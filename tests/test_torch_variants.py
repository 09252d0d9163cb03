"""The reference's kernel variants in the port against the JAX reference, on
the CPU.

The plain versions of the five variants that no dispatch table reaches are
held against ``tpucomp``'s own entry points, run in interpret mode, on the
same numpy inputs: the single-chunk and K-way LZ4 decoders (kernel rows 3-4,
``lz4_decode``, ``lz4_decodek``), the hash-table LZ4 and Snappy encoders
(rows 5 and 8, ``lz4_encode``, ``snappy_encode``) and the serial GDeflate
tile decoder (row 15, ``gdeflate_decode``).  Inputs: the corrupt LZ4 set (a
liblz4 stream, cuts, random bytes, bit flips, a size of -1, an empty row,
hand-made streams) at a fitting and a too-small out_cap; 16 KiB rows
(mixed, mortgage, zeros, random bytes) and the edge rows ``b""``, ``b"x"``
and 13 bytes at out_cap = bound and 4096; the tiles of
``tests/test_pallas_gdeflate.py`` (``gdeflate_pyref`` btype 0/1/2, the port's
encoder in algos 0-2, the 64 KiB window) and corrupt tiles at out_cap 65536
and 256.  Tolerance: exact equality — every output is bytes, sizes and
status codes.

All reference calls run once, in the module fixture (about 40 s on one
worker here, most of it compiling the interpret-mode kernels: the K-way
decoder at k = 4 some 6-8 s, each GDeflate call some 6 s).  Each k of the
K-way decoder is called at one of the two out_caps (its result does not
depend on k); the single-chunk decoder at both.  Keep this file below 26
cases, so xdist queues it after ``tests/test_zstd.py`` (``ROADMAP.md``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gdeflate_pyref as pyref
from tpucomp.ops.pallas import gdeflate_decode as ref_gd
from tpucomp.ops.pallas import lz4_decode as ref_ld
from tpucomp.ops.pallas import lz4_decodek as ref_ldk
from tpucomp.ops.pallas import lz4_encode as ref_le
from tpucomp.ops.pallas import snappy_encode as ref_se

from tpucomp_torch import batched
from tpucomp_torch.chunk import ChunkBatch
from tpucomp_torch.constants import Status
from tpucomp_torch.formats import gdeflate as fg
from tpucomp_torch.formats import lz4 as flz4
from tpucomp_torch.formats import snappy as fsnappy
from tpucomp_torch.interop import cpu as interop
from tpucomp_torch.ops.cuda import (gdeflate_decode, gdeflate_vdecode, lz4_decode,
                                    lz4_decodek, lz4_encode, snappy_encode)
from tpucomp_torch.utils import synth

# ---------------------------------------------------------------- inputs ---

LZ4_CAPS = {"fits": 1080, "small": 512}
K_CAPS = {1: "fits", 3: "small", 4: "fits"}   # each k at one out_cap


def _lz4_set():
    """The corrupt-LZ4 set: 15 rows and their sizes."""
    raw = synth.mixed_corpus(1000, seed=21).tobytes()
    good = interop.lz4_compress(raw)
    rng = np.random.default_rng(21)
    rows = [good, good[:len(good) // 2], good[:-1], good[:1],
            bytes(rng.integers(0, 256, 300, dtype=np.uint8))]
    for _ in range(6):
        b = bytearray(good)
        b[rng.integers(0, len(good))] ^= 1 << rng.integers(0, 8)
        rows.append(bytes(b))
    rows += [good, b"", b"\x10a\x02\x00\x10b", b"\x40abcd\x01\x00", b"\xff" * 64]
    sizes = [len(r) for r in rows]
    sizes[11] = -1                              # the good stream, size -1
    return raw, rows, sizes


ENC_CAP = 16384
ENC_ROWS = {
    "mixed": synth.mixed_corpus(ENC_CAP, seed=23).tobytes(),
    "mortgage": synth.mortgage_like(ENC_CAP, seed=23).tobytes(),
    "zeros": bytes(ENC_CAP),
    "random": bytes(np.random.default_rng(23).integers(0, 256, ENC_CAP, dtype=np.uint8)),
    "empty": b"", "one": b"x", "thirteen": b"abcdefghijklm",
}
ENCODERS = {"lz4": (ref_le, lz4_encode, flz4.max_compressed_chunk_size(ENC_CAP)),
            "snappy": (ref_se, snappy_encode, fsnappy.max_compressed_chunk_size(ENC_CAP))}
ENC_SMALL = 4096

GD_CAPS = (65536, 256)
_RNG = np.random.default_rng(7)
GD_RAWS = [  # tests/test_pallas_gdeflate.py:22-32
    b"hello gdeflate, hello gdeflate, hello gdeflate! " * 30,
    bytes(_RNG.integers(0, 4, 3000, dtype=np.uint8)),
    bytes(_RNG.integers(0, 256, 700, dtype=np.uint8)),
    b"\x00" * 3000, b"ab" * 1200, b"x", b""]
_SEG = bytes(np.random.default_rng(3).integers(0, 256, 40_000, dtype=np.uint8))
GD_WINDOW = _SEG + b"\x00" * 12_000 + _SEG[:12_000]   # distance codes 30/31
GD_CUT = "cut 3 (row kept)"


def _gd_tiles():
    """name -> (row bytes, size): valid tiles, then the corrupt set."""
    tiles = {f"pyref{b} {i}": pyref.compress(r, btype=b)
             for b in (1, 2) for i, r in enumerate(GD_RAWS)}
    tiles.update({f"pyref0 {i}": pyref.compress(GD_RAWS[i], btype=0) for i in (0, 2)})
    cb = ChunkBatch.from_bytes(synth.mixed_corpus(8192, seed=5).tobytes(), 4096, device="cpu")
    for algo in (0, 1, 2):
        comp, st = batched.compress("gdeflate", cb, fg.GdeflateOpts(algo))
        assert (st == Status.SUCCESS).all()
        tiles.update({f"algo{algo} {i}": t for i, t in enumerate(comp.chunk_list())})
    tiles["window"] = pyref.compress(GD_WINDOW, btype=2)
    out = {k: (t, len(t)) for k, t in tiles.items()}
    good = pyref.compress(b"corrupt me " * 50, btype=2)
    rng = np.random.default_rng(9)
    ntok = bytearray(good)
    ntok[2:6] = (1 << 24).to_bytes(4, "little")           # n_tokens > raw
    out.update({"good": (good, len(good)), GD_CUT: (good, len(good) - 3),
                "cut 3 (row zeroed)": (good[:-3], len(good) - 3), "cut 24": (good[:24], 24),
                "n_tok > raw": (bytes(ntok), len(good)), "btype 3": (b"\x03" + bytes(16), 17),
                "version 2": (good[:1] + b"\x02" + good[2:], len(good)),
                "random": (bytes(rng.integers(0, 256, 96, dtype=np.uint8)), 96),
                "empty": (b"", 0)})
    for f in range(6):
        b = bytearray(good)
        b[rng.integers(0, len(good))] ^= 1 << rng.integers(0, 8)
        out[f"flip {f}"] = (bytes(b), len(good))
    return out


def _rows(rows, sizes, cap=None):
    """Rows padded to one width, as numpy arrays."""
    cap = cap or max(max(len(r) for r in rows), 1)
    data = np.zeros((len(rows), cap), np.uint8)
    for i, r in enumerate(rows):
        data[i, :len(r)] = np.frombuffer(r, np.uint8)
    return data, np.asarray(sizes, np.int32)


def _np(res):
    return [np.asarray(x) for x in res]


@pytest.fixture(scope="module")
def ref():
    """Every reference call, once."""
    res = {}
    raw, rows, sizes = _lz4_set()
    res["lz4_raw"] = raw
    res["lz4_in"] = _rows(rows, sizes)
    c, s = (jnp.asarray(x) for x in res["lz4_in"])
    for name, oc in LZ4_CAPS.items():
        res["single", name] = _np(ref_ld.decompress_batch(c, s, oc, interpret=True))
    for k, name in K_CAPS.items():
        res["k", k] = _np(ref_ldk.decompress_batch(c, s, LZ4_CAPS[name], interpret=True, k=k))

    res["enc_in"] = _rows(list(ENC_ROWS.values()), [len(r) for r in ENC_ROWS.values()],
                          ENC_CAP)
    d, s = (jnp.asarray(x) for x in res["enc_in"])
    for fmt, (mod, _, bound) in ENCODERS.items():
        for oc in (bound, ENC_SMALL):
            res[fmt, oc] = _np(mod.compress_batch(d, s, oc, interpret=True))

    tiles = _gd_tiles()
    res["gd_names"] = list(tiles)
    res["gd_in"] = _rows([t for t, _ in tiles.values()], [n for _, n in tiles.values()])
    c, s = (jnp.asarray(x) for x in res["gd_in"])
    for oc in GD_CAPS:
        res["gd", oc] = _np(ref_gd.decompress_batch(c, s, oc, interpret=True))
    return res


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _assert_equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


# ------------------------------------------------------ rows 3-4: LZ4 decode ---

@pytest.mark.parametrize("out_cap", list(LZ4_CAPS))
def test_lz4_decode_single_equals_reference(ref, out_cap):
    got = lz4_decode.decompress_batch_plain(*_t(*ref["lz4_in"]), LZ4_CAPS[out_cap])
    _assert_equal(got, ref["single", out_cap])
    st = got[2].numpy()
    if out_cap == "fits":
        assert st[0] == Status.SUCCESS
        assert got[0][0, :got[1][0]].numpy().tobytes() == ref["lz4_raw"]
        assert st[11] == Status.ERROR_CANNOT_DECOMPRESS     # size -1
    else:
        assert st[0] == Status.ERROR_OUTPUT_BUFFER_TOO_SMALL


@pytest.mark.parametrize("k", list(K_CAPS))
def test_lz4_decodek_equals_reference(ref, k):
    out_cap = LZ4_CAPS[K_CAPS[k]]
    got = lz4_decodek.decompress_batch_plain(*_t(*ref["lz4_in"]), out_cap, k=k)
    _assert_equal(got, ref["k", k])
    # the result does not depend on k: the single-chunk decoder's
    _assert_equal(got, ref["single", K_CAPS[k]])


# -------------------------------------------------- rows 5, 8: v1 encoders ---

@pytest.mark.parametrize("out_cap", ["bound", "small"])
@pytest.mark.parametrize("fmt", list(ENCODERS))
def test_encoder_equals_reference(ref, fmt, out_cap):
    _, mod, bound = ENCODERS[fmt]
    oc = bound if out_cap == "bound" else ENC_SMALL
    got = mod.compress_batch_plain(*_t(*ref["enc_in"]), oc)
    _assert_equal(got, ref[fmt, oc])
    st = got[2].numpy()
    if out_cap == "bound":
        assert (st == Status.SUCCESS).all()
    else:   # the random row does not fit 4096 bytes: a zero row and size 0
        i = list(ENC_ROWS).index("random")
        assert st[i] == Status.ERROR_OUTPUT_BUFFER_TOO_SMALL and got[1][i] == 0
        assert not got[0][i].any()


@pytest.mark.parametrize("fmt", list(ENCODERS))
def test_encoder_frames_read_by_c_library(ref, fmt):
    if not interop.available()[fmt]:
        pytest.skip(f"lib{fmt} is not installed")
    _, mod, bound = ENCODERS[fmt]
    out, osz, _ = ref[fmt, bound]
    for i, raw in enumerate(ENC_ROWS.values()):
        frame = out[i, :osz[i]].tobytes()
        back = (interop.lz4_decompress(frame, len(raw)) if fmt == "lz4"
                else interop.snappy_decompress(frame))
        assert back == raw, i
    assert out[list(ENC_ROWS).index("empty"), 0] == 0   # LZ4's token 0x00, Snappy's size 0


def test_encoder_epoch_guard_and_cpu_tensors():
    """The reference's limit ``B * epoch_stride < 2**31`` raises in the port
    as in the reference; the kernel wrappers raise for CPU tensors."""
    big = np.zeros((8192, 16), np.uint8)        # stride 2**18: 8192 * 2**18 == 2**31
    sizes = np.full(8192, 16, np.int32)
    for ref_mod, mod in ((ref_le, lz4_encode), (ref_se, snappy_encode)):
        with pytest.raises(AssertionError, match="epoch stride"):
            ref_mod.compress_batch(jnp.asarray(big), jnp.asarray(sizes), 64, interpret=True)
        with pytest.raises(ValueError, match="epoch stride"):
            mod.compress_batch_plain(*_t(big, sizes), 64)
        ok = mod.compress_batch_plain(*_t(big[:8191], sizes[:8191]), 64)
        assert (ok[2] == Status.SUCCESS).all()
        with pytest.raises(ValueError, match="CUDA"):
            mod.compress_batch(*_t(big[:4], sizes[:4]), 64)
    c, s = _t(big[:4], sizes[:4])
    for fn in (lz4_decode.decompress_batch, lz4_decodek.decompress_batch,
               gdeflate_decode.decompress_batch):
        with pytest.raises(ValueError, match="CUDA"):
            fn(c, s, 64)
    with pytest.raises(ValueError, match="k must"):
        lz4_decodek.decompress_batch_plain(c, s, 64, k=0)


def test_encoder_clamps_sizes(ref):
    """Sizes outside ``[0, cap]`` are clamped, as in the port's other
    encoders: -5 encodes as 0 bytes, cap + 100 as the whole row."""
    data, sizes = ref["enc_in"]
    for fmt, (_, mod, bound) in ENCODERS.items():
        cut = mod.compress_batch_plain(*_t(data[:2], np.array([-5, ENC_CAP + 100], np.int32)),
                                       bound)
        want = mod.compress_batch_plain(*_t(data[:2], np.array([0, ENC_CAP], np.int32)), bound)
        _assert_equal(cut, [w.numpy() for w in want])
        _assert_equal([x[1:] for x in cut], [x[1:2] for x in ref[fmt, bound]])


# ------------------------------------------------- row 15: serial GDeflate ---

@pytest.mark.parametrize("out_cap", GD_CAPS)
def test_gdeflate_decode_equals_reference(ref, out_cap):
    got = gdeflate_decode.decompress_batch_plain(*_t(*ref["gd_in"]), out_cap)
    _assert_equal(got, ref["gd", out_cap])
    names = ref["gd_names"]
    st = dict(zip(names, got[2].tolist()))
    if out_cap == 65536:
        ok = [n for n in names if n.startswith(("pyref", "algo", "window", "good"))]
        assert all(st[n] == Status.SUCCESS for n in ok), st
        i = names.index("window")
        assert got[0][i, :got[1][i]].numpy().tobytes() == GD_WINDOW
        for bad in ("cut 24", "n_tok > raw", "btype 3", "version 2", "empty"):
            assert st[bad] == Status.ERROR_CANNOT_DECOMPRESS, bad


def test_gdeflate_statuses_differ_from_vdecode(ref):
    """Row 15 is its own function on corrupt tiles: it reads the row past a
    cut size, and decides too_big from the header before any parse.  Rows
    13-14 (:mod:`gdeflate_vdecode`, the dispatched decoder, whose plain
    version ``tests/test_torch_gdeflate.py`` holds against the reference's)
    differ there, as the reference's two decoders do."""
    names = ref["gd_names"]
    c, s = _t(*ref["gd_in"])
    idx = {n: i for i, n in enumerate(names)}
    # out_cap 65536: the valid tiles but the window, and the cut (the plain
    # vectorized parse walks every round of the longest tile in torch ops,
    # 1.5 ms a round here, up to out_cap / 32 + 1 rounds on a corrupt count)
    serial = ref["gd", 65536]
    some = [i for n, i in idx.items() if n.startswith(("pyref", "algo", "good")) or n == GD_CUT]
    vec = [x.numpy() for x in gdeflate_vdecode.decompress_batch_plain(c[some], s[some], 65536)]
    valid = [j for j, i in enumerate(some) if names[i].startswith(("pyref", "algo", "good"))]
    assert (serial[2][some][valid] == Status.SUCCESS).all()
    assert (vec[2][valid] == Status.SUCCESS).all()
    cut = some.index(idx[GD_CUT])   # the row holds the whole tile, its size is 3 short
    assert serial[2][idx[GD_CUT]] == Status.SUCCESS and serial[1][idx[GD_CUT]] == 550
    assert vec[2][cut] == Status.ERROR_CANNOT_DECOMPRESS

    serial = ref["gd", 256]
    vec = [x.numpy() for x in gdeflate_vdecode.decompress_batch_plain(c, s, 256)]
    pairs = {n: (int(serial[2][i]), int(vec[2][i])) for n, i in idx.items()}
    small, cannot = Status.ERROR_OUTPUT_BUFFER_TOO_SMALL, Status.ERROR_CANNOT_DECOMPRESS
    assert pairs["n_tok > raw"] == (cannot, small)
    assert pairs["cut 24"] == (small, cannot)
    differ = {n for n, (a, b) in pairs.items() if a != b}
    assert differ and all(pairs[n] in ((small, cannot), (cannot, small)) for n in differ), pairs
