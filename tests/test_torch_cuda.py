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
from tpucomp_torch.chunk import wrap_i32
from tpucomp_torch.constants import ElementType
from tpucomp_torch.formats import ans as fans
from tpucomp_torch.formats import cascaded as fcas
from tpucomp_torch.formats import crc32
from tpucomp_torch.formats import deflate as fdeflate
from tpucomp_torch.formats import gdeflate as fgdeflate
from tpucomp_torch.formats import gzip as fgzip
from tpucomp_torch.formats import lz4 as flz4
from tpucomp_torch.formats import snappy as fsnappy
from tpucomp_torch.formats import zstd as fzstd
from tpucomp_torch.interop import cpu as interop
from tpucomp_torch.manager import ChecksumPolicy, Manager, create_manager
from tpucomp_torch.ops import cascaded_fast, match
from tpucomp_torch.ops.cuda import (_probe, ans_decode, ans_encode, cascaded_expand, deflate_decode,
                                    deflate_encode, gdeflate_decode,
                                    gdeflate_encode, gdeflate_vdecode, lz4_decode, lz4_decode2,
                                    lz4_decodek, lz4_encode, lz4_encode2,
                                    snappy_decode, snappy_encode, snappy_encode2, zstd_decode,
                                    zstd_encode)
from tpucomp_torch.utils import synth

import deflate_stress as ds
import gdeflate_walk_stress as gws
import snappy_stress as ssx
import zstd_walk_stress as zws

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


@pytest.mark.parametrize("fmt", ["lz4", "snappy", "deflate", "zstd", "gdeflate", "ans"])
def test_manager_on_card(card, fmt):
    buf = synth.mixed_corpus(1 << 20, seed=10).tobytes()
    opts = {"deflate": fdeflate.DeflateOpts(1), "gdeflate": fgdeflate.GdeflateOpts(1)}.get(fmt)
    mgr = Manager(fmt, 65536, opts, checksum_policy=ChecksumPolicy.COMPUTE_AND_VERIFY)
    frame = mgr.compress(buf)                       # device=None: the card
    assert frame.is_cuda
    assert frame.cpu().numpy().tobytes() == Manager(
        fmt, 65536, opts, checksum_policy=ChecksumPolicy.COMPUTE_AND_VERIFY,
        device="cpu").compress(buf).numpy().tobytes()
    mgr2 = create_manager(frame)
    cfg = mgr2.configure_decompression(frame)
    out = mgr2.decompress(frame, cfg)
    assert out.is_cuda and cfg.get_status() == Status.SUCCESS
    assert out.cpu().numpy().tobytes() == buf


def _deflate_streams(cap: int):
    import zlib
    rng = np.random.default_rng(cap + 3)
    raws = [synth.mixed_corpus(cap + 64, seed=3)[:cap].tobytes(),
            synth.mortgage_like(cap, seed=4).tobytes(), b"", b"x", b"\x00" * cap,
            b"ab" * (cap // 2), bytes(rng.integers(0, 256, cap, dtype=np.uint8))]
    comp = [interop.deflate_compress(r, level) for r in raws for level in (0, 1, 6, 9)]
    if interop.available()["libdeflate"]:
        comp += [interop.libdeflate_compress(r, 9) for r in raws[:2]]
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    comp.append(co.compress(raws[0][:cap // 3]) + co.flush(zlib.Z_FULL_FLUSH)
                + co.compress(raws[0][cap // 3:]) + co.flush())
    good = comp[8]
    comp += [good[:k] for k in (1, 2, len(good) // 2, len(good) - 1)]
    for _ in range(8):
        b = bytearray(good)
        b[rng.integers(0, len(good))] ^= 1 << rng.integers(0, 8)
        comp.append(bytes(b))
    if cap == 65536:   # the window's stress inputs and their cut and flipped copies
        window = [s for _, s, _ in ds.window_streams()]
        comp += window + ds.corrupt(window)
    return comp + [b"\x07" * 40, b"\x05\x00", b"\x01\x05\x00\x00\x00hi",
                   b"\x01\xff\xff\x00\x00", bytes(rng.integers(0, 256, 96, dtype=np.uint8))]


@pytest.mark.parametrize("out_cap", ["fits", 1000])
@pytest.mark.parametrize("cap", [4096, 65536])
def test_deflate_decode_kernel_equals_plain(card, cap, out_cap):
    cb = ChunkBatch.from_chunks(_deflate_streams(cap), fdeflate.max_compressed_chunk_size(cap),
                                device="cpu")
    oc = cap if out_cap == "fits" else out_cap
    before = deflate_decode.decompress_batch.launches
    got = deflate_decode.decompress_batch(cb.data.to(card), cb.sizes.to(card), oc)
    torch.cuda.synchronize()
    assert deflate_decode.decompress_batch.launches == before + 1
    assert _equal(got, deflate_decode.decompress_batch_plain(cb.data, cb.sizes, oc))


@pytest.mark.parametrize("out_cap", [65535, 65536, ds.OUT_CAP_ABOVE])
def test_deflate_decode_window_kernel_equals_plain(card, out_cap):
    window = [s for _, s, _ in ds.window_streams()]
    cb = ChunkBatch.from_chunks(window + ds.corrupt(window), device="cpu")
    got = deflate_decode.decompress_batch(cb.data.to(card), cb.sizes.to(card), out_cap)
    torch.cuda.synchronize()
    assert _equal(got, deflate_decode.decompress_batch_plain(cb.data, cb.sizes, out_cap))


@pytest.mark.parametrize("out_cap", [65536, 1000])
def test_deflate_decode_gzip_members_kernel_equals_plain(card, out_cap):
    members = ds.window_members()
    cb = ChunkBatch.from_chunks(members + ds.corrupt(members[:3]), device="cpu")
    off, end, _, _, ok = fgzip.parse_member(cb.data, cb.sizes)
    starts = torch.where(ok, off, 0)
    got = deflate_decode.decompress_batch(cb.data.to(card), end.to(card), out_cap,
                                          starts=starts.to(card))
    torch.cuda.synchronize()
    assert _equal(got, deflate_decode.decompress_batch_plain(cb.data, end, out_cap, starts))


@pytest.mark.parametrize("out_cap", ["bound", 1024])
@pytest.mark.parametrize("algo", [0, 1, 2])
def test_deflate_encode_kernels_equal_plain(card, algo, out_cap):
    cap = 65536
    cb = _batch(cap, seed=algo + 7, short_sizes=(0, 1, 3, 4, 5, 20))
    oc = fdeflate.max_compressed_chunk_size(cap) if out_cap == "bound" else out_cap
    counters = [deflate_encode.fixed_kernel] if algo == 0 else [deflate_encode.hist_kernel,
                                                                deflate_encode.emit_kernel]
    before = [k.launches for k in counters]
    opts = fdeflate.DeflateOpts(algo)
    got, _ = batched.compress("deflate", ChunkBatch(cb.data.to(card), cb.sizes.to(card)),
                              opts, oc)
    torch.cuda.synchronize()
    assert [k.launches for k in counters] == [b + 1 for b in before]
    want, _ = batched.compress("deflate", cb, opts, oc)
    assert _equal((got.data, got.sizes), (want.data, want.sizes))


@pytest.mark.parametrize("entropy_only", [False, True])
@pytest.mark.parametrize("rows", ["batch", "walk stress"])
def test_deflate_hist_kernel_and_dyn_tables_on_card(card, rows, entropy_only):
    """Row 11 (the parse of ``csrc/lz_parse.cuh`` and its symbol counts; a
    byte histogram for entropy only) against ``hist_plain``'s walk, on the
    corpus and edge rows and on ``tests/gdeflate_walk_stress.py``'s (sizes
    0-8, 65535 and 65536, a 64 KiB run of one byte, a random 64 KiB row,
    back extensions, the 258 cap) with Deflate's 32 KiB candidates."""
    if rows == "batch":
        cb = _batch(65536, seed=11, short_sizes=(0, 1, 3, 4, 5, 20))
        cands = match.candidates2(cb.data, cb.sizes, window=deflate_encode.WINDOW)
    else:
        cb, names = gws.batch()
        cands = gws.candidates(cb, names, window=deflate_encode.WINDOW)
    if entropy_only:
        cands = None
    want = deflate_encode.hist_plain(cb.data, cb.sizes, cands)
    got = deflate_encode.hist_kernel(cb.data.to(card), cb.sizes.to(card),
                                     None if cands is None else [c.to(card) for c in cands])
    assert _equal(got, want)
    assert _equal(deflate_encode.dyn_tables(*got), deflate_encode.dyn_tables(*want))


def test_gzip_kernel_path_equals_plain(card):
    raws = [synth.mixed_corpus(70000, seed=5)[:65536].tobytes(), b"", b"gzip " * 999]
    comp = [interop.gzip_compress(r) for r in raws]
    bad = bytearray(comp[0])
    bad[-6] ^= 0xFF
    comp += [bytes(bad), comp[0][:20]]
    cb = ChunkBatch.from_chunks(comp, fgzip.max_compressed_chunk_size(65536), device="cpu")
    got, gst = batched.decompress("gzip", ChunkBatch(cb.data.to(card), cb.sizes.to(card)),
                                  65536)
    want, wst = batched.decompress("gzip", cb, 65536)
    assert _equal((got.data, got.sizes, gst), (want.data, want.sizes, wst))
    assert wst.tolist() == [0, 0, 0, 12, 12]


def _zstd_streams(cap: int):
    """libzstd frames at levels -5/1/3/19 (one block each at 64 KiB; several
    at 1 MiB), edge inputs, a frame of many literals, corrupt frames."""
    rng = np.random.default_rng(cap + 5)
    raws = [synth.mixed_corpus(cap + 64, seed=3)[:cap].tobytes(),
            synth.mortgage_like(cap, seed=4).tobytes(), synth.text_like(cap, seed=5).tobytes(),
            b"", b"x", b"\x00" * cap, b"ab" * (cap // 2),
            bytes(rng.integers(0, 256, cap, dtype=np.uint8)),
            bytes(rng.integers(0, 16, cap, dtype=np.uint8))]
    comp = [interop.zstd_compress(r, level) for r in raws for level in (-5, 1, 3, 19)]
    good = comp[2]
    comp += [good[:k] for k in (1, 4, 5, 12, len(good) // 2, len(good) - 1)]
    for _ in range(8):
        b = bytearray(good)
        b[rng.integers(0, len(good))] ^= 1 << rng.integers(0, 8)
        comp.append(bytes(b))
    return comp + [b"\x00" + good[1:], good[:4] + bytes([good[4] | 0x08]) + good[5:],
                   good[:4] + bytes([good[4] | 0x01, 0x07]) + good[5:],
                   bytes(rng.integers(0, 256, 96, dtype=np.uint8))]


@pytest.mark.parametrize("out_cap", ["fits", 1000])
@pytest.mark.parametrize("big", [False, True])
@pytest.mark.parametrize("cap", [65536, 1 << 20])
def test_zstd_decode_kernel_equals_plain(card, cap, big, out_cap):
    """Both wrappers (the two lit_caps) against their plain versions; at
    out_cap 1000 frames with many literals split into statuses 12 and 15."""
    if not interop.available()["zstd"]:
        pytest.skip("libzstd is not installed")
    streams = _zstd_streams(cap) if cap == 65536 else [
        interop.zstd_compress(synth.mixed_corpus(cap, seed=6).tobytes()[:cap], 3),
        interop.zstd_compress(synth.mortgage_like(cap, seed=7).tobytes(), 19)]
    cb = ChunkBatch.from_chunks(streams, device="cpu")
    oc = cap if out_cap == "fits" else out_cap
    kernel, plain = ((zstd_decode.decompress_batch_big, zstd_decode.decompress_batch_big_plain)
                     if big else (zstd_decode.decompress_batch, zstd_decode.decompress_batch_plain))
    before = kernel.launches
    got = kernel(cb.data.to(card), cb.sizes.to(card), oc)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = plain(cb.data, cb.sizes, oc)
    assert _equal(got, want)
    if out_cap == "fits":
        assert (want[2][:len(streams) if cap > 65536 else 36] == Status.SUCCESS).all()


def test_zstd_batched_dispatch_on_card(card):
    """batched.decompress("zstd") takes row 18 for 64 KiB chunks and row 19
    for 2 MiB chunks (the reference's gate), bit-exact on libzstd frames."""
    if not interop.available()["zstd"]:
        pytest.skip("libzstd is not installed")
    for chunk, kernel in ((65536, zstd_decode.decompress_batch),
                          (2 << 20, zstd_decode.decompress_batch_big)):
        buf = synth.mixed_corpus(4 << 20, seed=12).tobytes()
        raws = [buf[i:i + chunk] for i in range(0, len(buf), chunk)]
        cb = ChunkBatch.from_chunks([interop.zstd_compress(r, 3) for r in raws])  # the card
        before = kernel.launches
        dec, st = batched.decompress("zstd", cb, chunk)
        assert kernel.launches == before + 1
        assert (st == Status.SUCCESS).all() and dec.to_bytes() == buf


def _zstd_many_block_frames() -> list[bytes]:
    """Frames of many blocks: libzstd at levels 1/3/19 over 1.5 MiB (twelve
    blocks, matches across blocks), the port's multi-block encoder's frames
    (block-local matches), and bit flips and cuts after the first block."""
    raw = synth.mixed_corpus(3 << 19, seed=21).tobytes()
    frames = [interop.zstd_compress(raw, level) for level in (1, 3, 19)]
    n = 1 << 18
    data = torch.from_numpy(np.frombuffer(raw[:2 * n], np.uint8).copy()).reshape(2, n)
    comp, sizes, st = fzstd.compress_batch(data, torch.tensor([n, n - 999], dtype=torch.int32))
    assert st.tolist() == [0, 0]
    frames += [bytes(comp[i, :sizes[i]].numpy()) for i in range(2)]
    rng = np.random.default_rng(21)
    good = frames[1]
    for _ in range(10):
        b = bytearray(good)
        b[rng.integers(len(good) // 8, len(good))] ^= 1 << rng.integers(0, 8)
        frames.append(bytes(b))
    return frames + [good[:len(good) // 2], good[:-1]]


@pytest.mark.parametrize("out_cap", ["fits", 100_000])
def test_zstd_passes_equal_plain_on_many_block_frames(card, out_cap):
    """Row 19's passes on the card, each against its plain pass on the plain
    passes' own inputs, and the whole against the plain passes and the walk."""
    from tpucomp_torch.ops.cuda import zstd_passes as zp
    if not interop.available()["zstd"]:
        pytest.skip("libzstd is not installed")
    cb = ChunkBatch.from_chunks(_zstd_many_block_frames(), device="cpu")
    oc = 3 << 19 if out_cap == "fits" else out_cap
    lit_cap = zstd_decode.lit_cap_of(oc, big=True)
    k = {}
    want = zp.run(cb.data, cb.sizes, oc, lit_cap, plain=True, keep=k)
    assert _equal(want, zstd_decode.decompress_batch_big_plain(cb.data, cb.sizes, oc))
    if out_cap == "fits":
        assert (want[2][:5] == Status.SUCCESS).all()

    def on(*xs):
        return [x.to(card) for x in xs]

    d, sz = on(cb.data, cb.sizes)
    nblk, nseq, nlit, nover, most = k["totals"]
    fcount, bases, totals = zp.chain_kernel(d, sz, oc, lit_cap)
    assert _equal((fcount, bases), (k["fcount"], k["bases"])) and totals == k["totals"]
    assert _equal((zp.fill_kernel(d, sz, oc, lit_cap, *on(k["fcount"], k["bases"]), nblk),),
                  (k["blk"],))
    assert _equal(zp.entropy_kernel(d, k["blk"].to(card), nlit, nseq),
                  [k[x] for x in ("lits", "seqs", "bout", "bsym", "berr")])
    assert _equal(zp.scan_kernel(*on(k["fcount"], k["bases"], k["bout"], k["bsym"], k["berr"]),
                                 oc), [k[x] for x in ("bstart", "bin", "fsize", "fstat0")])
    assert _equal(zp.resolve_kernel(*on(k["blk"], k["seqs"], k["bstart"], k["bin"], k["fstat0"])),
                  (k["offs"], k["fstat1"]))
    if nover:
        assert _equal((zp.settle_kernel(d, sz, oc, lit_cap, k["fstat1"].to(card)),),
                      (k["fstat"],))
    out, osz, st = zp.zero_kernel(*on(k["fstat"], k["fsize"]), oc)
    col = torch.arange(oc, device=card)[None, :]
    assert _equal((torch.where(col >= osz[:, None], out, 0), osz, st), (k["out0"],) + want[1:])
    for multi in {most > 1, True}:   # the narrow shape where it applies, and the wide
        assert _equal((zp.execute_kernel(d, *on(k["blk"], k["lits"], k["seqs"], k["offs"],
                                                k["bstart"], k["bout"], k["fstat"], k["out0"]),
                                          multi),), want[:1])
    before = zstd_decode.decompress_batch_big.launches
    assert _equal(zstd_decode.decompress_batch_big(d, sz, oc), want)
    assert zstd_decode.decompress_batch_big.launches == before + 1


def _zstd_encode_batch() -> ChunkBatch:
    """64 KiB rows: mixed, mortgage-like, runs, random, the sequence-heavy row
    of tests/test_pallas_zstd.py:212-226, the period-16 stride, short sizes."""
    cap = 65536
    rng = np.random.default_rng(5)
    seq_heavy = b"".join(b"abcd" + rng.integers(0, 256, 2, dtype=np.uint8).tobytes()
                         for _ in range(12000))[:cap]
    base = (np.arange(16, dtype=np.uint8) * 7 + 3).tobytes()
    stride = b"".join(base + bytes([i & 0xFF]) for i in range(4000))[:cap]
    rows = _batch(cap, seed=13).chunk_list()[:4]
    rows += [seq_heavy, stride] + rows[:1] * 7
    out = ChunkBatch.from_chunks(rows, cap, device="cpu")
    out.sizes[6:] = torch.tensor((0, 1, 3, 4, 5, 20, 700), dtype=torch.int32)
    return out


@pytest.mark.parametrize("out_cap", ["bound", 2048])
@pytest.mark.parametrize("exact", [True, False])
def test_zstd_encode_kernels_equal_plain(card, exact, out_cap):
    """The hist and full walks (and the whole pipeline) against their plain
    versions at 64 KiB, in exact entropy and in the speed rung."""
    cb = _zstd_encode_batch()
    oc = fzstd.max_compressed_chunk_size(65536) if out_cap == "bound" else out_cap
    cands = match.candidates2(cb.data, cb.sizes, window=zstd_encode.MAX_CAP)
    cands_card = [c.to(card) for c in cands]
    data, sizes = cb.data.to(card), cb.sizes.to(card)
    if exact:
        want = zstd_encode.hist_plain(cb.data, cb.sizes, cands)
        assert _equal(zstd_encode.hist_kernel(data, sizes, cands_card), want)
        fse_tab, nc = zstd_encode.seq_tables(want[1])
        freq = want[0]
    else:
        fse_tab, nc = zstd_encode.speed_tables(cb.num_chunks, "cpu")
        freq = zstd_encode.whole_chunk_hist(cb.data, cb.sizes)
    meta, tree = zstd_encode.huf_meta(freq)
    want = zstd_encode.full_plain(cb.data, cb.sizes, cands, meta, tree, fse_tab, nc, oc)
    got = zstd_encode.full_kernel(data, sizes, cands_card, meta.to(card), tree.to(card),
                                  fse_tab.to(card), nc.to(card), oc)
    assert _equal(got, want)
    before = (zstd_encode.hist_kernel.launches, zstd_encode.full_kernel.launches)
    got = zstd_encode.compress_batch(data, sizes, oc, exact_entropy=exact)
    torch.cuda.synchronize()
    assert (zstd_encode.hist_kernel.launches, zstd_encode.full_kernel.launches) == (
        before[0] + int(exact), before[1] + 1)
    assert _equal(got, want)
    if out_cap == "bound":
        assert (want[2] == Status.SUCCESS).all()
    else:
        assert (want[2] == Status.ERROR_OUTPUT_BUFFER_TOO_SMALL).any()


def test_zstd_tables_on_card_equal_cpu(card):
    cb = _zstd_encode_batch()
    cands = match.candidates2(cb.data, cb.sizes, window=zstd_encode.MAX_CAP)
    freq, sch = zstd_encode.hist_plain(cb.data, cb.sizes, cands)
    assert _equal(zstd_encode.seq_tables(sch.to(card)), zstd_encode.seq_tables(sch))
    assert _equal(zstd_encode.huf_meta(freq.to(card)), zstd_encode.huf_meta(freq))
    assert _equal((zstd_encode.whole_chunk_hist(cb.data.to(card), cb.sizes.to(card)),),
                  (zstd_encode.whole_chunk_hist(cb.data, cb.sizes),))


def test_zstd_compress_on_card_read_by_libzstd(card):
    """batched.compress("zstd") on the card: libzstd and the port's decoder
    read every frame back bit-exact, at 64 KiB chunks and above (the
    multi-block encoder on the card, equal to its CPU run)."""
    if not interop.available()["zstd"]:
        pytest.skip("libzstd is not installed")
    buf = synth.mixed_corpus(4 << 20, seed=14).tobytes()
    cb = ChunkBatch.from_bytes(buf, 65536)                           # the card
    before = zstd_encode.full_kernel.launches
    comp, st = batched.compress("zstd", cb)
    assert zstd_encode.full_kernel.launches == before + 1
    assert (st == Status.SUCCESS).all()
    raws = cb.chunk_list()
    assert all(interop.zstd_decompress(f, len(r)) == r for f, r in zip(comp.chunk_list(), raws))
    dec, dst = batched.decompress("zstd", comp, 65536)
    assert (dst == Status.SUCCESS).all() and dec.to_bytes() == buf
    big = ChunkBatch.from_bytes(buf[:300000], 131072)
    bcomp, bst = batched.compress("zstd", big)
    assert (bst == Status.SUCCESS).all()
    assert all(interop.zstd_decompress(f, len(r)) == r
               for f, r in zip(bcomp.chunk_list(), big.chunk_list()))
    cpu = fzstd.compress_batch(big.data.cpu(), big.sizes.cpu(), fzstd.DEFAULT_OPTS,
                               bcomp.data.shape[1])
    assert torch.equal(bcomp.data.cpu(), cpu[0]) and torch.equal(bcomp.sizes.cpu(), cpu[1])


# ---------------------------------------------------------------- gdeflate ---

def _gdeflate_rows() -> ChunkBatch:
    """64 KiB rows: corpus heads, a row with distances above 49152, edges."""
    cap = 65536
    rng = np.random.default_rng(3)
    seg = bytes(rng.integers(0, 256, 40_000, dtype=np.uint8))
    raws = [synth.mixed_corpus(cap + 64, seed=3)[:cap].tobytes(),
            synth.mortgage_like(cap, seed=4).tobytes(),
            seg + b"\x00" * 12_000 + seg[:12_000], b"", b"x", b"\x00" * cap,
            b"ab" * 1200, bytes(rng.integers(0, 256, 700, dtype=np.uint8))]
    return ChunkBatch.from_chunks(raws, cap, device="cpu")


@pytest.mark.parametrize("algo", [0, 1, 2])
def test_gdeflate_walk_kernels_equal_plain(card, algo):
    """Rows 16-17: the hist walk and the fixed/emit lane walks, then the
    whole encode through ``batched``."""
    cb = _gdeflate_rows()
    d, s = cb.data.to(card), cb.sizes.to(card)
    cands = None if algo == 2 else match.candidates2(cb.data, cb.sizes)
    gc = None if cands is None else [c.to(card) for c in cands]
    if algo == 0:
        assert _equal(gdeflate_encode.fixed_kernel(d, s, gc),
                      gdeflate_encode.fixed_plain(cb.data, cb.sizes, cands))
    else:
        hist = gdeflate_encode.hist_plain(cb.data, cb.sizes, cands)
        assert _equal(gdeflate_encode.hist_kernel(d, s, gc), hist)
        tab = gdeflate_encode.dyn_tables_gd(*hist)
        assert _equal(gdeflate_encode.dyn_tables_gd(*[h.to(card) for h in hist]), tab)
        assert _equal(gdeflate_encode.emit_kernel(d, s, gc, tab[0].to(card)),
                      gdeflate_encode.emit_plain(cb.data, cb.sizes, cands, tab[0]))
    opts = fgdeflate.GdeflateOpts(algo)
    for oc in (fgdeflate.max_compressed_chunk_size(65536), 4096):
        got, gst = batched.compress("gdeflate", ChunkBatch(d, s), opts, oc)
        want, wst = batched.compress("gdeflate", cb, opts, oc)
        assert _equal((got.data, got.sizes, gst), (want.data, want.sizes, wst))


@pytest.mark.parametrize("case", ["fixed", "emit", "entropy_only", "long_codes", "hist",
                                  "hist_entropy_only"])
def test_gdeflate_parse_kernels_equal_plain_on_stress_rows(card, case):
    """Rows 16 (hist) and 17 (fixed, emit) on ``tests/gdeflate_walk_stress.py``:
    back extensions to position 0 and to the anchor (thinned candidates),
    cand8 winning, the 258 cap with and without back extension, matches
    ending around mflimit, sizes 0-8, 65535 and 65536, a 64 KiB run of one
    byte, a random 64 KiB row; ``long_codes`` pushes the random row's lanes
    past 832 words."""
    cb, names = gws.batch()
    d, s = cb.data.to(card), cb.sizes.to(card)
    cands = None if case.endswith("entropy_only") else gws.candidates(cb, names)
    gc = None if cands is None else [c.to(card) for c in cands]
    if case.startswith("hist"):
        got = gdeflate_encode.hist_kernel(d, s, gc)
        want = gdeflate_encode.hist_plain(cb.data, cb.sizes, cands)
    elif case == "fixed":
        got = gdeflate_encode.fixed_kernel(d, s, gc)
        want = gdeflate_encode.fixed_plain(cb.data, cb.sizes, cands)
    else:
        tab = (gws.long_code_table(cb.num_chunks) if case == "long_codes"
               else gdeflate_encode.dyn_tables_gd(
                   *gdeflate_encode.hist_plain(cb.data, cb.sizes, cands))[0])
        got = gdeflate_encode.emit_kernel(d, s, gc, tab.to(card))
        want = gdeflate_encode.emit_plain(cb.data, cb.sizes, cands, tab)
    assert _equal(got, want)
    if case == "long_codes":
        assert int(want[3][names.index("random_64k"), 1]) == 1


@pytest.mark.parametrize("out_cap", ["bound", 1024])
@pytest.mark.parametrize("algo", [1, 2])
def test_deflate_emit_parse_equals_plain_on_stress_rows(card, algo, out_cap):
    """Row 12 (the emit kernel on the shared parse) on
    ``tests/gdeflate_walk_stress.py``'s rows with Deflate's 32 KiB
    candidates (thinned for back extensions; the 258 cap; ends around
    mflimit; sizes 0-8, 65535, 65536; a 64 KiB run), with matches and
    entropy-only, at the bound and at an out_cap too small."""
    cb, names = gws.batch()
    cands = None if algo == 2 else gws.candidates(cb, names, window=deflate_encode.WINDOW)
    tables = deflate_encode.dyn_tables(*deflate_encode.hist_plain(cb.data, cb.sizes, cands))
    cap = fdeflate.max_compressed_chunk_size(gws.CAP) if out_cap == "bound" else out_cap
    got = deflate_encode.emit_kernel(cb.data.to(card), cb.sizes.to(card),
                                     None if cands is None else [c.to(card) for c in cands],
                                     *(t.to(card) for t in tables), cap)
    want = deflate_encode.emit_plain(cb.data, cb.sizes, cands, *tables, cap)
    assert _equal(got, want)


@pytest.mark.parametrize("batch", ["as is", "past the SM count"])
@pytest.mark.parametrize("rung,out_cap", [("exact", "bound"), ("exact", 2048),
                                          ("speed", "bound")])
def test_zstd_full_parse_equals_plain_on_stress_rows(card, rung, out_cap, batch):
    """Row 21 on ``tests/zstd_walk_stress.py``'s rows (repeat-only keeps,
    the initial offset 8, keeps through back extension alone, sequences
    without literals, a 65,532-byte match, sizes 0-8, 65535, 65536, a
    literal-only row), as they are and repeated past the card's SM count,
    so that a CTA parses several chunks through one scratch row."""
    cb, names = zws.batch()
    cands = zws.candidates(cb, names)
    if rung == "exact":
        freq, sch = zstd_encode.hist_plain(cb.data, cb.sizes, cands)
        fse_tab, nc = zstd_encode.seq_tables(sch)
    else:
        freq = zstd_encode.whole_chunk_hist(cb.data, cb.sizes)
        fse_tab, nc = zstd_encode.speed_tables(cb.num_chunks, "cpu")
    meta, tree = zstd_encode.huf_meta(freq)
    cap = fzstd.max_compressed_chunk_size(zws.CAP) if out_cap == "bound" else out_cap
    want = zstd_encode.full_plain(cb.data, cb.sizes, cands, meta, tree, fse_tab, nc, cap)
    idx = torch.arange(cb.num_chunks)
    if batch == "past the SM count":
        n_sm = torch.cuda.get_device_properties(card).multi_processor_count
        idx = torch.arange(n_sm + cb.num_chunks + 1) % cb.num_chunks
    on = lambda t: t[idx].to(card)      # noqa: E731
    got = zstd_encode.full_kernel(on(cb.data), on(cb.sizes), [on(c) for c in cands], on(meta),
                                  on(tree), on(fse_tab), on(nc), cap)
    assert _equal(got, tuple(w[idx] for w in want))


@pytest.mark.parametrize("batch", ["as is", "past the SM count"])
def test_zstd_hist_parse_equals_plain_on_stress_rows(card, batch):
    """Row 20 (the hist kernel on row 21's parse) on
    ``tests/zstd_walk_stress.py``'s rows and mixed's literal-heavy tail, as
    they are and repeated past the card's SM count (a CTA's scratch row
    reused); the same scratch then serves row 21, as in ``compress_batch``."""
    cb, names = zws.batch()
    raw = synth.mixed_corpus(1 << 20, seed=42).tobytes()
    cb = ChunkBatch.from_chunks(cb.chunk_list() + [raw[-65536:], raw[860_000:860_000 + 65536]],
                                zws.CAP, device="cpu")
    names = names + ["mixed tail", "mixed 860000"]
    cands = list(zws.candidates(ChunkBatch(cb.data[:-2], cb.sizes[:-2]), names[:-2]))
    tail = match.candidates2(cb.data[-2:], cb.sizes[-2:], window=zws.WINDOW)
    cands = [torch.cat([a, b]) for a, b in zip(cands, tail)]
    want = zstd_encode.hist_plain(cb.data, cb.sizes, cands)
    idx = torch.arange(cb.num_chunks)
    if batch == "past the SM count":
        n_sm = torch.cuda.get_device_properties(card).multi_processor_count
        idx = torch.arange(n_sm + cb.num_chunks + 1) % cb.num_chunks
    on = lambda t: t[idx].to(card)      # noqa: E731
    scratch = zstd_encode.parse_scratch(len(idx), card)
    before = zstd_encode.hist_kernel.launches
    got = zstd_encode.hist_kernel(on(cb.data), on(cb.sizes), [on(c) for c in cands], scratch)
    assert zstd_encode.hist_kernel.launches == before + 1
    assert _equal(got, tuple(w[idx] for w in want))
    meta, tree = zstd_encode.huf_meta(want[0])
    fse_tab, nc = zstd_encode.seq_tables(want[1])
    cap = fzstd.max_compressed_chunk_size(zws.CAP)
    frames = zstd_encode.full_kernel(on(cb.data), on(cb.sizes), [on(c) for c in cands], on(meta),
                                     on(tree), on(fse_tab), on(nc), cap, scratch)
    plain = zstd_encode.full_plain(cb.data, cb.sizes, cands, meta, tree, fse_tab, nc, cap)
    assert _equal(frames, tuple(w[idx] for w in plain))


@pytest.mark.parametrize("out_cap", ssx.OUT_CAPS)
def test_snappy_decode_kernels_equal_plain_on_stress_rows(card, out_cap):
    """Row 6 on ``tests/snappy_stress.py``'s streams: the parse kernel at
    out_caps 65536 and 1000, the walk (the shape the parse does not take)
    past 64 KiB; each launch counted by its own wrapper."""
    cb, names = ssx.batch()
    parse = snappy_decode.parse_fits(cb.data.shape[1], out_cap)
    assert parse == (out_cap <= 65536)
    before = (snappy_decode.decompress_batch.launches,
              snappy_decode.decompress_batch_walk.launches)
    got = snappy_decode.decompress_batch(cb.data.to(card), cb.sizes.to(card), out_cap)
    torch.cuda.synchronize()
    assert (snappy_decode.decompress_batch.launches,
            snappy_decode.decompress_batch_walk.launches) == (before[0] + int(parse),
                                                               before[1] + int(not parse))
    want = snappy_decode.decompress_batch_plain(cb.data, cb.sizes, out_cap)
    for i, name in enumerate(names):
        assert _equal([g[i] for g in got], [w[i] for w in want]), name
    walk = snappy_decode.decompress_batch_walk(cb.data.to(card), cb.sizes.to(card), out_cap)
    assert _equal(walk, want)


@pytest.mark.parametrize("algo", [0, 1, 2])
def test_gdeflate_chunk_past_64_kib_gets_its_own_status(card, algo):
    """``batched.compress("gdeflate")`` on a 65544-byte chunk beside a small
    one: the call goes on chunk by chunk (the parse kernel reads at most a
    row's first 64 KiB), the big chunk gets ``ERROR_CHUNK_SIZE_TOO_LARGE``,
    size 0 and a zero row, and the batch equals the plain path's."""
    cb = ChunkBatch.from_chunks([synth.mixed_corpus(65544, seed=6).tobytes(),
                                 synth.mixed_corpus(3000, seed=5).tobytes()], device="cpu")
    opts = fgdeflate.GdeflateOpts(algo)
    got, gst = batched.compress("gdeflate", ChunkBatch(cb.data.to(card), cb.sizes.to(card)), opts)
    want, wst = batched.compress("gdeflate", cb, opts)
    assert gst.tolist() == [Status.ERROR_CHUNK_SIZE_TOO_LARGE, Status.SUCCESS]
    assert int(got.sizes[0]) == 0 and not bool(got.data[0].any())
    assert _equal((got.data, got.sizes, gst), (want.data, want.sizes, wst))


@pytest.mark.parametrize("out_cap", [65536, 1000])
def test_gdeflate_decode_kernels_equal_plain(card, out_cap):
    """Rows 13-14: the parse (tables row, tokens, sp, err) and the replay,
    then the whole decode, on the port's tiles of every algo and corrupt
    tiles."""
    cb = _gdeflate_rows()
    oc = fgdeflate.max_compressed_chunk_size(65536)
    tiles = []
    for algo in (0, 1, 2):
        comp, _ = batched.compress("gdeflate", cb, fgdeflate.GdeflateOpts(algo), oc)
        tiles += comp.chunk_list()
    good = tiles[8]
    rng = np.random.default_rng(out_cap)
    tiles += [good[:k] for k in (24, 80, len(good) // 2)]
    for _ in range(6):
        b = bytearray(good)
        b[rng.integers(0, len(good))] ^= 1 << rng.integers(0, 8)
        tiles.append(bytes(b))
    tiles += [good[:1] + b"\x02" + good[2:], b"\x03" + bytes(16), b""]
    tc = ChunkBatch.from_chunks(tiles, oc, device="cpu")
    c, s = tc.data.to(card), tc.sizes.to(card)
    parse = gdeflate_vdecode.parse_plain(tc.data, tc.sizes, out_cap)
    assert _equal(gdeflate_vdecode.parse_kernel(c, s, out_cap), parse)
    n = torch.minimum(parse[0][:, 1], torch.tensor(parse[1].shape[1], dtype=torch.int32))
    assert _equal(gdeflate_vdecode.exec_kernel(parse[1].to(card), n.to(card), out_cap),
                  gdeflate_vdecode.exec_plain(parse[1], n, out_cap))
    before = [gdeflate_vdecode.parse_kernel.launches, gdeflate_vdecode.exec_kernel.launches]
    got = batched.decompress("gdeflate", ChunkBatch(c, s), out_cap)
    torch.cuda.synchronize()
    assert [gdeflate_vdecode.parse_kernel.launches,
            gdeflate_vdecode.exec_kernel.launches] == [b + 1 for b in before]
    want = batched.decompress("gdeflate", tc, out_cap)
    assert _equal((got[0].data, got[0].sizes, got[1]), (want[0].data, want[0].sizes, want[1]))


def test_gdeflate_tables_on_card_equal_cpu(card):
    """``tile_tables`` and the schedule's torch ops on the card, against the
    CPU, and the parse kernel's tables row against ``tile_tables``."""
    cb = _gdeflate_rows()
    comp, _ = batched.compress("gdeflate", cb, fgdeflate.GdeflateOpts(1))
    got = fgdeflate.tile_tables(comp.data.to(card))
    want = fgdeflate.tile_tables(comp.data)
    flat = [x for g in zip(got, want) for x in ((g,) if not isinstance(g[0], tuple)
                                                 else tuple(zip(*g)))]
    assert all(torch.equal(a.cpu(), b) for a, b in flat)
    tabs = gdeflate_vdecode.parse_kernel(comp.data.to(card), comp.sizes.to(card), 65536)[0]
    assert torch.equal(tabs.cpu(), gdeflate_vdecode._table_rows(comp.data))


def _ans_rows() -> ChunkBatch:
    """Nine rows (a ragged group of eight): 64 KiB heads, a cut size, the
    edge rows of tests/test_pallas_ans.py, all 256 symbols with most rare."""
    rng = np.random.default_rng(31)
    raws = [synth.mixed_corpus(65536, seed=42).tobytes()[:65536],
            synth.mortgage_like(65536, seed=42).tobytes(), b"", b"x", b"\x00" * 3000,
            bytes(rng.integers(0, 4, 5000, dtype=np.uint8)),
            bytes(rng.integers(0, 256, 3000, dtype=np.uint8)),
            bytes(range(256)) + b"a" * 20000, synth.runs(65536, mean_run=300, seed=3).tobytes()]
    cb = ChunkBatch.from_chunks(raws, 65536, device="cpu")
    cb.sizes[-1] = 1000
    return cb


@pytest.mark.parametrize("wide", [False, True])
def test_ans_encode_kernels_equal_plain(card, wide):
    """Rows 24-25: the walk (words, emits, x_fin, wcount), then whole frames
    at the bound and at a too-small out_cap."""
    cb = _ans_rows()
    d, s = cb.data.to(card), cb.sizes.to(card)
    freq, cum = fans.tables_for(cb.data, cb.sizes)
    assert _equal(fans.tables_for(d, s), (freq, cum))
    walk = ans_encode.walk_kernel_wide if wide else ans_encode.walk_kernel
    assert _equal(walk(d, s, freq.to(card), cum.to(card)),
                  ans_encode.walk_plain(cb.data, cb.sizes, freq, cum))
    comp = ans_encode.compress_batch_wide if wide else ans_encode.compress_batch
    for oc in (fans.max_compressed_chunk_size(65536), 4096):
        assert _equal(comp(d, s, oc), ans_encode.compress_batch_plain(cb.data, cb.sizes, oc))


@pytest.mark.parametrize("out_cap", [65536, 1000])
def test_ans_decode_kernels_equal_plain(card, out_cap):
    """Rows 22-23 on the port's frames, truncated and flipped frames, bad
    headers, and the same rows cut below the header."""
    cb = _ans_rows()
    bound = fans.max_compressed_chunk_size(65536)
    comp = ans_encode.compress_batch_plain(cb.data, cb.sizes, bound)
    frames = ChunkBatch(comp[0], comp[1]).chunk_list()
    good = frames[0]
    rng = np.random.default_rng(out_cap)
    bad = []
    for at, val in ((0, 0x5A), (1, 3), (12, good[12] ^ 0x55), (7, 0x80), (11, 0x80)):
        b = bytearray(good)
        b[at] = val
        bad.append(bytes(b))
    for _ in range(4):
        b = bytearray(good)
        b[rng.integers(fans.HEADER_BYTES, len(good))] ^= 1 << rng.integers(0, 8)
        bad.append(bytes(b))
    tc = ChunkBatch.from_chunks(frames + bad + [good, good[:1302], b""], bound, device="cpu")
    tc.sizes[len(frames) + len(bad)] -= 40      # truncated
    for data in (tc.data, tc.data[:, :1200].contiguous()):
        want = ans_decode.decompress_batch_plain(data, tc.sizes, out_cap)
        for fn in (ans_decode.decompress_batch, ans_decode.decompress_batch_wide):
            assert _equal(fn(data.to(card), tc.sizes.to(card), out_cap), want)


def test_ans_batched_dispatch_on_card(card):
    """``batched`` routes "ans" to the wide wrappers (rows 23 and 25)."""
    cb = _ans_rows()
    d = ChunkBatch(cb.data.to(card), cb.sizes.to(card))
    before = [ans_encode.walk_kernel_wide.launches, ans_decode.decompress_batch_wide.launches,
              ans_encode.walk_kernel.launches, ans_decode.decompress_batch.launches]
    comp, cst = batched.compress("ans", d)
    dec, dst = batched.decompress("ans", comp, 65536)
    torch.cuda.synchronize()
    assert [ans_encode.walk_kernel_wide.launches, ans_decode.decompress_batch_wide.launches,
            ans_encode.walk_kernel.launches, ans_decode.decompress_batch.launches] == \
        [before[0] + 1, before[1] + 1, before[2], before[3]]
    assert (cst == 0).all() and (dst == 0).all()
    assert torch.equal(dec.sizes.cpu(), cb.sizes) and dec.to_bytes() == cb.to_bytes()


_CAS_OPTS = fcas.CascadedOpts(ElementType.LONGLONG, 2, 1, True)


def _cas_rows(cap: int = 65536):
    """Row 26's inputs at the main path's cap_el: hand-made run streams (nr
    0/1/2, no runs, runs of 1, 127, 128, 129 and cap_el), corrupt ones
    (zero-length, negative and over-long runs, counts outside the row, nr
    above 2, int32 starts that wrap)."""
    rows = [((cap, 0, 0, 0), [], []), ((0, 0, 0, 1), [], []), ((cap, cap, 0, 1), [1] * cap, []),
            ((cap, 4, 0, 1), [127, 128, 129, cap - 384], []), ((cap, 1, 0, 1), [cap], []),
            ((cap, 4, 3, 2), [1000, 24, 1024, cap - 2048], [1, 2, 1]),
            ((cap, 6, 0, 1), [0, 5, 0, 90000, 3, -4], []), ((0, -3, 0, 1), [4, 4], []),
            ((cap, cap + 50, 7, 2), [2] * 50, [10, 0, 200000, 1, 1, -1, 3]),
            ((cap, 2, 2, 7), [cap // 2] * 2, [1, 1]), ((cap, cap, 0, 1), [cap] * cap, [])]
    rng = np.random.default_rng(26)
    B = len(rows)
    vals = [torch.from_numpy(rng.integers(-2**31, 2**31, (B, cap)).astype(np.int32))
            for _ in range(2)]
    runs = [torch.zeros((B, cap), dtype=torch.int32) for _ in range(2)]
    for b, (_, r1, r2) in enumerate(rows):
        runs[0][b, :len(r1)] = torch.tensor(r1, dtype=torch.int32)
        runs[1][b, :len(r2)] = torch.tensor(r2, dtype=torch.int32)
    return (*vals, *runs, torch.tensor([r[0] for r in rows], dtype=torch.int32))


def _cas_batch(device):
    raw = [synth.mortgage_like(65536, seed=s).tobytes() for s in (1, 2)]
    raw += [synth.sorted_ints(65536, seed=3).tobytes(), raw[0][:8], b""]
    return ChunkBatch.from_chunks(raw, 65536, device=device)


def test_cascaded_expand_kernel_equals_plain(card):
    """Row 26 on whole rows: the hand-made and corrupt run streams, and the
    fast decoder's _stage1 outputs of the port's LONGLONG frames."""
    args = _cas_rows()
    before = cascaded_expand.expand_batch.launches
    got = cascaded_expand.expand_batch(*(a.to(card) for a in args), 65536)
    torch.cuda.synchronize()
    assert cascaded_expand.expand_batch.launches == before + 1
    assert _equal(got, cascaded_expand.expand_batch_plain(*args, 65536))
    cb = _cas_batch("cpu")
    comp = cascaded_fast.compress_batch(cb.data, cb.sizes, _CAS_OPTS,
                                        fcas.max_compressed_chunk_size(65536, _CAS_OPTS))
    s1 = cascaded_fast._stage1(comp[0], cascaded_fast.comp_words(comp[0], 65536), comp[1], 65536)
    args = (wrap_i32(s1[0]).to(torch.int32), wrap_i32(s1[1]).to(torch.int32), *s1[2:5])
    assert _equal(cascaded_expand.expand_batch(*(a.to(card) for a in args), 65536),
                  cascaded_expand.expand_batch_plain(*args, 65536))


def test_cascaded_batched_dispatch_on_card(card):
    """``batched`` routes "cascaded" to the fast path (row 26 once a
    decode); its frames and rows equal the fast path's on the CPU, and
    backend "xla" gives the general program's frames on either device."""
    cb = _cas_batch("cpu")
    d = ChunkBatch(cb.data.to(card), cb.sizes.to(card))
    before = cascaded_expand.expand_batch.launches
    comp, cst = batched.compress("cascaded", d, _CAS_OPTS)
    dec, dst = batched.decompress("cascaded", comp, 65536)
    torch.cuda.synchronize()
    assert cascaded_expand.expand_batch.launches == before + 1
    assert (cst == 0).all() and (dst == 0).all() and dec.to_bytes() == cb.to_bytes()
    cap = fcas.max_compressed_chunk_size(65536, _CAS_OPTS)
    assert _equal((comp.data, comp.sizes, cst),
                  cascaded_fast.compress_batch(cb.data, cb.sizes, _CAS_OPTS, cap))
    assert _equal((dec.data, dec.sizes, dst),
                  cascaded_fast.decompress_batch(comp.data.cpu(), comp.sizes.cpu(), 65536,
                                                 plain=True))
    x_card = batched.compress("cascaded", d, _CAS_OPTS, backend="xla")
    x_cpu = batched.compress("cascaded", cb, _CAS_OPTS, backend="xla")
    assert _equal((x_card[0].data, x_card[0].sizes, x_card[1]),
                  (x_cpu[0].data, x_cpu[0].sizes, x_cpu[1]))
    xd = batched.decompress("cascaded", x_card[0], 65536)
    assert xd[0].to_bytes() == cb.to_bytes()


def test_cascaded_manager_on_card(card):
    """``Manager("cascaded")`` on the card (the fast path) writes the CPU
    Manager's frame (the general program) where the two encoders agree, and
    reads it back."""
    buf = synth.low_cardinality_ints(1 << 20, seed=10).tobytes()
    opts = fcas.CascadedOpts(ElementType.INT, 1, 0, True)
    policy = ChecksumPolicy.COMPUTE_AND_VERIFY
    frame = Manager("cascaded", 65536, opts, checksum_policy=policy).compress(buf)
    assert frame.is_cuda
    assert frame.cpu().numpy().tobytes() == Manager(
        "cascaded", 65536, opts, checksum_policy=policy, device="cpu").compress(
        buf).numpy().tobytes()
    mgr = create_manager(frame)
    assert mgr.opts == opts
    cfg = mgr.configure_decompression(frame)
    out = mgr.decompress(frame, cfg)
    assert out.is_cuda and cfg.get_status() == Status.SUCCESS
    assert out.cpu().numpy().tobytes() == buf



# ------------------------------------- the reference's variants (rows 3-5, 8, 15) ---

@pytest.mark.parametrize("k", [None, 1, 3, 4, 32, 33])
def test_lz4_decode_variant_kernels_equal_plain(card, k):
    """Rows 3 (``k`` None: one chunk a block) and 4 (``k`` chunks a block,
    ``min(k, 32)`` warps): row 1's plain version, which is theirs."""
    if not interop.available()["lz4"]:
        pytest.skip("liblz4 is not installed")
    cb = ChunkBatch.from_chunks(_streams(65536), flz4.max_compressed_chunk_size(65536),
                                device="cpu")
    c, s = cb.data.to(card), cb.sizes.to(card)
    mod = lz4_decode if k is None else lz4_decodek
    for oc in (65536, 1000):
        before = mod.decompress_batch.launches
        got = (lz4_decode.decompress_batch(c, s, oc) if k is None
               else lz4_decodek.decompress_batch(c, s, oc, k=k))
        torch.cuda.synchronize()
        assert mod.decompress_batch.launches == before + 1
        assert _equal(got, lz4_decode2.decompress_batch_plain(cb.data, cb.sizes, oc))


@pytest.mark.parametrize("fmt", ["lz4", "snappy"])
def test_hash_encode_kernels_equal_plain(card, fmt):
    """Rows 5 and 8: the hash-table scan at out_cap = bound and 2048, on
    64 KiB rows, cut sizes and sizes outside [0, cap]."""
    cb = _batch(65536, seed=5, short_sizes=(0, 1, 12, 13, 17, -3, 70000))
    mod, bound = ((lz4_encode, flz4.max_compressed_chunk_size(65536)) if fmt == "lz4"
                  else (snappy_encode, fsnappy.max_compressed_chunk_size(65536)))
    for oc in (bound, 2048):
        before = mod.compress_batch.launches
        got = mod.compress_batch(cb.data.to(card), cb.sizes.to(card), oc)
        torch.cuda.synchronize()
        assert mod.compress_batch.launches == before + 1
        assert _equal(got, mod.compress_batch_plain(cb.data, cb.sizes, oc))


def test_gdeflate_serial_decode_kernel_equals_plain(card):
    """Row 15 on the port's tiles of every algo (64 KiB rows, distances
    above 49152), cuts (a row kept whole with its size 3 short), flips,
    a future version and a btype-3 tile, at out_cap 65536 and 256."""
    cb = _gdeflate_rows()
    oc = fgdeflate.max_compressed_chunk_size(65536)
    tiles = []
    for algo in (0, 1, 2):
        comp, _ = batched.compress("gdeflate", cb, fgdeflate.GdeflateOpts(algo), oc)
        tiles += comp.chunk_list()
    good = tiles[8]
    rng = np.random.default_rng(15)
    tiles += [good[:k] for k in (24, 80, len(good) // 2)]
    for _ in range(6):
        b = bytearray(good)
        b[rng.integers(0, len(good))] ^= 1 << rng.integers(0, 8)
        tiles.append(bytes(b))
    tiles += [good[:1] + b"\x02" + good[2:], b"\x03" + bytes(16), b"", good]
    tc = ChunkBatch.from_chunks(tiles, oc, device="cpu")
    tc.sizes[-1] -= 3
    for out_cap in (65536, 256):
        before = gdeflate_decode.decompress_batch.launches
        got = gdeflate_decode.decompress_batch(tc.data.to(card), tc.sizes.to(card), out_cap)
        torch.cuda.synchronize()
        assert gdeflate_decode.decompress_batch.launches == before + 1
        want = gdeflate_decode.decompress_batch_plain(tc.data, tc.sizes, out_cap)
        assert _equal(got, want)
        if out_cap == 65536:
            assert (want[2][:24] == Status.SUCCESS).all()


# ------------------------------------------------------------------ probes ---

@pytest.mark.parametrize("name", list(_probe.PROBES))
def test_probe_kernel_equals_plain(card, name):
    """Row 27: each probe's kernel on ``_probe.CHECK_CASES`` (the reference's
    inputs, out-of-range, negative and overlapping scalars) equals its plain
    version, whole outputs with their INT32_MIN fill."""
    blocks = _probe.check_blocks()
    for n, xk, v in _probe.check_calls():
        if n != name:
            continue
        args = _probe.check_args(xk, v, blocks)
        before = _probe.PROBES[name].launches
        got = _probe.PROBES[name](*(a.to(card) for a in args))
        torch.cuda.synchronize()
        assert _probe.PROBES[name].launches == before + 1
        assert torch.equal(got.cpu(), _probe.PLAIN[name](*args)), (name, xk, v)


@pytest.mark.parametrize("name", list(_probe.PROBES))
def test_probe_entry_writes_every_element(card, name):
    """Row 27: each probe's C entry, called on an output buffer filled with
    a poison value, writes every element: the probe's values, and
    ``INT32_MIN`` where the probe leaves one unwritten."""
    blocks = _probe.check_blocks()
    shape = _probe._SPECS[name][1]
    for n, xk, v in _probe.check_calls():
        if n != name:
            continue
        args = [a.to(card) for a in _probe.check_args(xk, v, blocks)]
        out = torch.full(shape, 0x5A5A5A5A, dtype=torch.int32, device=card)
        ptrs = [a.data_ptr() for a in args][1 if name == "p9" else 0:]
        rc = _probe._entry(name)(*ptrs, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        assert rc == 0
        assert torch.equal(out.cpu(), _probe.PLAIN[name](*[a.cpu() for a in args])), (name, xk, v)


def test_probe_call_is_one_launch(card):
    """Row 27: a probe call launches its kernel and nothing else (no fill),
    counted by ``torch.profiler``."""
    blocks = _probe.check_blocks()
    for name, (xk, scalars) in _probe.CHECK_CASES.items():
        args = _probe.check_args(xk, None if scalars is None else scalars[0], blocks, card)
        _probe.PROBES[name](*args)          # the library loads outside the window
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            _probe.PROBES[name](*args)
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(kernels) == 1 and f"{name}_kernel" in kernels[0], (name, kernels)
