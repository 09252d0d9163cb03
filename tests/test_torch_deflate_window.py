"""The port's plain Deflate decoder against zlib's inflate on the stress
inputs of ``tests/deflate_stress.py``: matches exactly 32,768 bytes back, a
stored block of 65,535 bytes, multi-block streams (also as gzip members at
their starts), literal-only and distance-1 streams, every period below 32,
runs of fixed blocks, and cut and bit-flipped copies; at ``out_cap`` one
byte short, exact and above 64 KiB.

The plain version (``deflate_decode.decompress_batch_plain``) is what the
CPU tests hold against the reference (``tests/test_torch_deflate.py``) and
what ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold the kernel
against on these same inputs.  No reference call: zlib is the oracle here.
Tolerance: exact (bytes, sizes, statuses).
"""
import gzip
import zlib

import numpy as np
import pytest
import torch

import deflate_stress as ds
from tpucomp_torch.chunk import ChunkBatch
from tpucomp_torch.constants import Status
from tpucomp_torch.formats import gzip as fgzip
from tpucomp_torch.ops.cuda import deflate_decode as dd

STREAMS = ds.window_streams()
NAMES = [name for name, _, _ in STREAMS]


def _decode(streams: list[bytes], out_cap: int):
    cb = ChunkBatch.from_chunks(streams, device="cpu")
    out, osz, st = dd.decompress_batch_plain(cb.data, cb.sizes, out_cap)
    return out.numpy(), osz.numpy(), st.numpy()


def _inflate(stream: bytes) -> bytes | None:
    """zlib's output, or None where zlib finds the stream corrupt or cut."""
    d = zlib.decompressobj(-15)
    try:
        out = d.decompress(stream)
    except zlib.error:
        return None
    return out if d.eof else None


@pytest.mark.parametrize("name", NAMES)
def test_stream_equals_zlib_at_each_out_cap(name):
    _, stream, raw = STREAMS[NAMES.index(name)]
    assert _inflate(stream) == raw
    n = len(raw)
    for out_cap in (n, ds.OUT_CAP_ABOVE):
        out, osz, st = _decode([stream], out_cap)
        assert st[0] == Status.SUCCESS and osz[0] == n
        assert out[0, :n].tobytes() == raw and not out[0, n:].any()
    out, osz, st = _decode([stream], n - 1)          # one byte short
    assert st[0] == Status.ERROR_OUTPUT_BUFFER_TOO_SMALL and osz[0] == 0
    assert out.shape == (1, n - 1) and not out.any()


def test_every_stream_in_one_batch_at_a_small_out_cap():
    out, osz, st = _decode([s for _, s, _ in STREAMS], 1000)
    assert (st == Status.ERROR_OUTPUT_BUFFER_TOO_SMALL).all()
    assert not osz.any() and not out.any()


def test_gzip_members_at_their_starts():
    members = ds.window_members()
    cb = ChunkBatch.from_chunks(members, device="cpu")
    off, end, _, _, ok = fgzip.parse_member(cb.data, cb.sizes)
    assert ok.all() and set(off.tolist()) == {10, 22}
    out, osz, st = fgzip.decompress_batch_with(dd.decompress_batch_plain, cb.data, cb.sizes,
                                               65536)
    for i, m in enumerate(members):
        raw = gzip.decompress(m)
        assert st[i] == Status.SUCCESS and osz[i] == len(raw)
        assert out[i, :len(raw)].numpy().tobytes() == raw and not out[i, len(raw):].any()


def test_cut_and_flipped_copies():
    bad = ds.corrupt([s for _, s, _ in STREAMS])
    out, osz, st = _decode(bad, 65536)
    for i, stream in enumerate(bad):
        want = _inflate(stream)
        if i % 5 < 3:                                # the cut copies
            assert want is None and st[i] == Status.ERROR_CANNOT_DECOMPRESS
        if want is not None and len(want) <= 65536:  # zlib reads it: the same bytes
            assert st[i] == Status.SUCCESS and out[i, :osz[i]].tobytes() == want
        if st[i] != Status.SUCCESS:                  # any failure: size 0, a zero row
            assert osz[i] == 0 and not out[i].any()
