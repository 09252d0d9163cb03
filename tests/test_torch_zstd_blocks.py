"""The port's Zstandard multi-block encoder against the JAX reference, on the
CPU: its multi-block branch, at a small block width.

Inside one ``pytest.MonkeyPatch.context()``, ``ZSTD_BLOCK`` is 4096 in both
``tpucomp.formats.zstd`` and the port's module, so rows of 12 KiB + 100
bytes take the multi-block branch: three whole blocks and a ragged one, the
repeat-offset stack restarting from sentinels after the first.  In the same
context both packages' ``formats/lz4._find_matches`` run at their default
depth (4 candidates, 2-word probes) instead of the encoder's 32 x 24: the
unrolled probes are most of the reference's graph, and this file is about
the blocks, not the match finder, which ``tests/test_torch_zstd_xla.py``
holds at the encoder's depth.  The reference runs through a fresh
``jax.jit(jax.vmap(encode_chunk))`` (not the cached ``compress_batch``), the
port through ``compress_batch``: frames, sizes and statuses must be equal.
The rows are those of ``tests/test_torch_zstd_xla.py`` (the equal-count rows
equal in each 4096-byte block).  python-zstandard and libzstd read every
port frame; the patches are undone on exit; a port-only
``Manager("zstd", 131072)`` round trip runs its chunks as 32 blocks each, at
the encoder's depth.  Nothing in ``tpucomp/`` is edited.
Tolerance: exact equality.

The reference encoder compiles once, in the module fixture (about 50 s on
one CPU worker; some 310 s at the encoder's depth); the port takes some
10 s.  Keep this file below 26 cases, so xdist queues it after
``tests/test_zstd.py`` (``ROADMAP.md``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import zstandard

from test_torch_zstd_xla import ROW_NAMES, readers_agree, rows
from tpucomp.formats import lz4 as ref_lz4
from tpucomp.formats import zstd as ref_fzstd

from tpucomp_torch.constants import Status
from tpucomp_torch.formats import lz4
from tpucomp_torch.formats import zstd as fzstd
from tpucomp_torch.manager import Manager
from tpucomp_torch.utils import synth

BLOCK = 4096
CAP = 3 * BLOCK + 100
OUT_CAP = fzstd.max_compressed_chunk_size(CAP)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side is thousands of small torch ops: on one intra-op
    thread each, this file's torch does not starve the xdist workers beside
    it with spinning threads.  The thread count is restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shallow(find_matches):
    """The match finder at its own default depth (4 candidates, 2-word
    probes) in place of the encoder's 32 x 24."""
    return lambda d, s, **kw: find_matches(d, s, **{**kw, "n_cands": 4, "probe_words": 2})


@pytest.fixture(scope="module")
def frames():
    data, sizes = rows(CAP, BLOCK)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_fzstd, "ZSTD_BLOCK", BLOCK)
        mp.setattr(fzstd, "ZSTD_BLOCK", BLOCK)
        mp.setattr(ref_lz4, "_find_matches", _shallow(ref_lz4._find_matches))
        mp.setattr(lz4, "_find_matches", _shallow(lz4._find_matches))
        enc = jax.jit(jax.vmap(lambda d, s: ref_fzstd.encode_chunk(
            d, s, ref_fzstd.DEFAULT_OPTS, OUT_CAP)))
        ref = enc(jnp.asarray(data), jnp.asarray(sizes))
        port = fzstd.compress_batch(torch.from_numpy(data), torch.from_numpy(sizes),
                                    fzstd.DEFAULT_OPTS, OUT_CAP)
    return data, sizes, [np.asarray(a) for a in ref], [a.numpy() for a in port]


@pytest.mark.parametrize("row", ROW_NAMES)
def test_frame_equals_reference(frames, row):
    _, _, ref, port = frames
    i = ROW_NAMES.index(row)
    assert port[1][i] == ref[1][i] and port[2][i] == ref[2][i]
    assert np.array_equal(port[0][i], ref[0][i]), row


def test_sizes_statuses_and_block_layout(frames):
    data, sizes, ref, port = frames
    assert np.array_equal(port[1], ref[1]) and np.array_equal(port[2], ref[2])
    assert (port[2] == Status.SUCCESS).all()
    # the mixed row: four blocks, the first compressed, the last one flagged last
    f = port[0][0]
    at, heads = 10, []
    while True:
        bh = int(f[at]) | int(f[at + 1]) << 8 | int(f[at + 2]) << 16
        heads.append(bh)
        at += 3 + (bh >> 3)
        if bh & 1:
            break
    assert len(heads) == 4 and (heads[0] >> 1) & 3 == 2 and at == port[1][0]


def test_python_zstandard_and_libzstd_read_every_frame(frames):
    data, sizes, _, port = frames
    assert readers_agree(data, sizes, port[0], port[1]) == []


def test_block_constant_restored(frames):
    assert ref_fzstd.ZSTD_BLOCK == fzstd.ZSTD_BLOCK == 1 << 17
    assert ref_lz4._find_matches.__name__ == lz4._find_matches.__name__ == "_find_matches"


def test_manager_round_trip_in_blocks(monkeypatch):
    monkeypatch.setattr(fzstd, "ZSTD_BLOCK", BLOCK)
    data = synth.mortgage_like(200_000, seed=16).tobytes()
    mgr = Manager("zstd", 131072, device="cpu")
    frame = mgr.compress(data)
    assert bytes(mgr.decompress(frame).numpy()) == data
    assert len(frame) < len(data) // 2
    chunk = fzstd.compress_batch(torch.frombuffer(bytearray(data[:131072]), dtype=torch.uint8)
                                 [None], torch.tensor([131072]))
    assert zstandard.ZstdDecompressor().decompress(
        chunk[0][0, :int(chunk[1][0])].numpy().tobytes()) == data[:131072]
