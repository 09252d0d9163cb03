"""The port's Hopper kernels against their plain versions, on the card.

Marked ``cuda``: each test skips (with a reason, decided inside the fixture)
when no CUDA device is present, so here on a CPU-only machine they all skip.
On a machine with a card run them with

    python -m pytest -m cuda tests/test_torch_*.py

The kernels build at first use.  Tolerance: exact equality (bytes, sizes,
statuses, candidate positions).
"""
import numpy as np
import pytest
import torch

from tpucomp_torch import batched
from tpucomp_torch.chunk import ChunkBatch
from tpucomp_torch.constants import Status
from tpucomp_torch.formats import crc32
from tpucomp_torch.formats import lz4 as flz4
from tpucomp_torch.formats import snappy as fsnappy
from tpucomp_torch.interop import cpu as interop
from tpucomp_torch.manager import ChecksumPolicy, Manager, create_manager
from tpucomp_torch.ops import match
from tpucomp_torch.ops.cuda import lz4_decode2, lz4_encode2, snappy_decode, snappy_encode2
from tpucomp_torch.utils import synth

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _batch(cap: int, seed: int, short_sizes=(0, 1, 12, 13, 17)) -> ChunkBatch:
    raw = [synth.mixed_corpus(cap + 64, seed=seed)[:cap],
           synth.mortgage_like(cap, seed=seed),
           synth.runs(cap, mean_run=300, seed=seed),
           synth.gen_data(255, cap, seed=seed)]
    raw += [raw[0]] * len(short_sizes)
    cb = ChunkBatch.from_chunks(raw, cap, device="cpu")
    cb.sizes[4:] = torch.tensor(short_sizes, dtype=torch.int32)
    return cb


def _equal(got, want):
    return all(torch.equal(g.cpu(), w.cpu()) for g, w in zip(got, want))


@pytest.mark.parametrize("cap", [4096, 16384, 65536])
def test_candidates2_on_card_equals_cpu(card, cap):
    cb = _batch(cap, seed=cap)
    got = match.candidates2(cb.data.to(card), cb.sizes.to(card))
    assert _equal(got, match.candidates2(cb.data, cb.sizes))


@pytest.mark.parametrize("out_cap", ["bound", 2048])
@pytest.mark.parametrize("cap", [4096, 16384, 65536])
def test_encode_kernel_equals_plain(card, cap, out_cap):
    cb = _batch(cap, seed=cap + 1)
    oc = flz4.max_compressed_chunk_size(cap) if out_cap == "bound" else out_cap
    before = lz4_encode2.emit_kernel.launches
    got = lz4_encode2.compress_batch(cb.data.to(card), cb.sizes.to(card), oc)
    torch.cuda.synchronize()
    assert lz4_encode2.emit_kernel.launches == before + 1
    assert _equal(got, lz4_encode2.compress_batch_plain(cb.data, cb.sizes, oc))


def _streams(cap: int):
    rng = np.random.default_rng(cap)
    raws = [synth.mixed_corpus(cap + 64, seed=3)[:cap].tobytes(),
            synth.mortgage_like(cap, seed=4).tobytes(), b"", b"x", b"\x00" * cap,
            b"ab" * (cap // 2), b"abcdefg" * (cap // 7),
            bytes(rng.integers(0, 256, cap, dtype=np.uint8))]
    comp = [interop.lz4_compress(r) for r in raws]
    good = comp[0]
    comp += [good[:k] for k in (1, 2, len(good) // 2, len(good) - 1)]
    for _ in range(4):
        b = bytearray(good)
        b[rng.integers(0, len(good))] ^= 1 << rng.integers(0, 8)
        comp.append(bytes(b))
    return comp + [b"\x04abcd\x00\x00", b"\x40abcd\x01\x00", b"\xff" * 64,
                   b"\x10a\x02\x00\x10b", b"\x10a\x01\x00\x10b"]


@pytest.mark.parametrize("out_cap", ["fits", 1000])
@pytest.mark.parametrize("cap", [4096, 65536])
def test_decode_kernel_equals_plain(card, cap, out_cap):
    if not interop.available()["lz4"]:
        pytest.skip("liblz4 is not installed")
    cb = ChunkBatch.from_chunks(_streams(cap), flz4.max_compressed_chunk_size(cap),
                                device="cpu")
    oc = cap if out_cap == "fits" else out_cap
    before = lz4_decode2.decompress_batch.launches
    got = lz4_decode2.decompress_batch(cb.data.to(card), cb.sizes.to(card), oc)
    torch.cuda.synchronize()
    assert lz4_decode2.decompress_batch.launches == before + 1
    assert _equal(got, lz4_decode2.decompress_batch_plain(cb.data, cb.sizes, oc))


def test_batched_auto_round_trip_on_card(card):
    buf = synth.mixed_corpus(1 << 20, seed=9).tobytes()
    cb = ChunkBatch.from_bytes(buf, 65536)          # device=None: the card
    assert cb.data.is_cuda
    comp, cst = batched.compress("lz4", cb)
    dec, dst = batched.decompress("lz4", comp, 65536)
    assert (cst == Status.SUCCESS).all() and (dst == Status.SUCCESS).all()
    assert dec.to_bytes() == buf
    assert batched.roundtrip_verify("lz4", cb)


@pytest.mark.parametrize("out_cap", ["bound", 2048])
@pytest.mark.parametrize("cap", [4096, 16384, 65536])
def test_snappy_encode_kernel_equals_plain(card, cap, out_cap):
    cb = _batch(cap, seed=cap + 2, short_sizes=(0, 1, 3, 4, 5, 17))
    oc = fsnappy.max_compressed_chunk_size(cap) if out_cap == "bound" else out_cap
    before = snappy_encode2.emit_kernel.launches
    got = snappy_encode2.compress_batch(cb.data.to(card), cb.sizes.to(card), oc)
    torch.cuda.synchronize()
    assert snappy_encode2.emit_kernel.launches == before + 1
    assert _equal(got, snappy_encode2.compress_batch_plain(cb.data, cb.sizes, oc))


def _snappy_streams(cap: int):
    rng = np.random.default_rng(cap)
    raws = [synth.mixed_corpus(cap + 64, seed=3)[:cap].tobytes(),
            synth.mortgage_like(cap, seed=4).tobytes(), b"", b"x", b"\x00" * cap,
            b"ab" * (cap // 2), bytes(rng.integers(0, 256, cap, dtype=np.uint8))]
    if interop.available()["snappy"]:
        comp = [interop.snappy_compress(r) for r in raws]
    else:   # the card's machine may lack libsnappy: the port's encoder stages
        cb = ChunkBatch.from_chunks(raws, cap, device="cpu")
        out, osz, _ = snappy_encode2.compress_batch_plain(
            cb.data, cb.sizes, fsnappy.max_compressed_chunk_size(cap))
        comp = [out[i, :osz[i]].numpy().tobytes() for i in range(len(raws))]
    good = comp[0]
    comp += [good[:k] for k in (1, 2, len(good) // 2, len(good) - 1)]
    for _ in range(4):
        b = bytearray(good)
        b[rng.integers(0, len(good))] ^= 1 << rng.integers(0, 8)
        comp.append(bytes(b))
    return comp + [b"\x14\x10abcd" + bytes([1 | (12 << 2), 4]),        # copy-1
                   b"\x46\x00Z" + bytes([(63 << 2) | 3, 1, 0, 0, 0, (4 << 2) | 3, 1, 0, 0, 0]),
                   b"\xff\xff\xff\xff\xff\x01", b"\x05\x01\x00\x00", b"\x80\x80\x80\x80\x10",
                   b"\x80\x80\x80\x80\x08", b"\xa0\x8d\x06\x0cabcd"]


@pytest.mark.parametrize("out_cap", ["fits", 1000])
@pytest.mark.parametrize("cap", [4096, 65536])
def test_snappy_decode_kernel_equals_plain(card, cap, out_cap):
    cb = ChunkBatch.from_chunks(_snappy_streams(cap), fsnappy.max_compressed_chunk_size(cap),
                                device="cpu")
    oc = cap if out_cap == "fits" else out_cap
    before = snappy_decode.decompress_batch.launches
    got = snappy_decode.decompress_batch(cb.data.to(card), cb.sizes.to(card), oc)
    torch.cuda.synchronize()
    assert snappy_decode.decompress_batch.launches == before + 1
    assert _equal(got, snappy_decode.decompress_batch_plain(cb.data, cb.sizes, oc))


def test_crc32_on_card_equals_cpu(card):
    cb = _batch(65536, seed=5)
    assert torch.equal(crc32.crc32_batch(cb.data.to(card), cb.sizes.to(card)).cpu(),
                       crc32.crc32_batch(cb.data, cb.sizes))


@pytest.mark.parametrize("fmt", ["lz4", "snappy"])
def test_manager_on_card(card, fmt):
    buf = synth.mixed_corpus(1 << 20, seed=10).tobytes()
    mgr = Manager(fmt, 65536, checksum_policy=ChecksumPolicy.COMPUTE_AND_VERIFY)
    frame = mgr.compress(buf)                       # device=None: the card
    assert frame.is_cuda
    assert frame.cpu().numpy().tobytes() == Manager(
        fmt, 65536, checksum_policy=ChecksumPolicy.COMPUTE_AND_VERIFY,
        device="cpu").compress(buf).numpy().tobytes()
    mgr2 = create_manager(frame)
    cfg = mgr2.configure_decompression(frame)
    out = mgr2.decompress(frame, cfg)
    assert out.is_cuda and cfg.get_status() == Status.SUCCESS
    assert out.cpu().numpy().tobytes() == buf
