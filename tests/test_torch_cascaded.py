"""The port's Cascaded path against the JAX reference, on the CPU.

The port's general program (``tpucomp_torch.formats.cascaded``, the registry
entry) is held against ``tpucomp.formats.cascaded``, its fast path
(``tpucomp_torch.ops.cascaded_fast``, with the expansion's plain version)
against ``tpucomp.ops.cascaded_fast``, its bit packer against
``tpucomp.ops.bitpack``, and the expansion's plain version against the
reference's row-26 kernel (``cascaded_expand.expand_batch`` in interpret
mode, on ``[0, n)``) and against ``cascaded_fast._expand_chunk`` (whole
rows), on the same numpy inputs: rows of every element width (runs,
unsigned values straddling 2^31, signed 1-, 4- and 8-byte values, the
int64 extremes, a mortgage-like column), empty rows and a size that is not a
multiple of the element, under four option sets (the three of the card's
configurations among them); both decoders on those frames, garbage,
truncated streams, headers whose counts have the top bit set, and
``tests/golden/cascaded.bin``, where the two reference decoders disagree and
the port copies each.  The Manager's frame equals the reference Manager's.
Tolerance: exact equality (bytes, sizes, statuses, words, values).

All reference calls run once, in the module fixture (about 40 s on one CPU
worker).  Keep this file below 26 cases, so xdist queues it after
``tests/test_zstd.py`` (``ROADMAP.md``).
"""
import binascii
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpucomp.formats.crc32 as ref_crc32
import tpucomp.manager as ref_manager
from tpucomp.constants import ElementType as RefType
from tpucomp.formats import cascaded as ref_fc
from tpucomp.ops import bitpack as ref_bp
from tpucomp.ops import cascaded_fast as ref_cf
from tpucomp.ops.pallas import cascaded_expand as ref_ce

from tpucomp_torch import batched
from tpucomp_torch.chunk import ChunkBatch
from tpucomp_torch.constants import ElementType, Status
from tpucomp_torch.formats import cascaded as fc
from tpucomp_torch.manager import ChecksumPolicy, Manager, create_manager
from tpucomp_torch.manager import _opts_from_blob, _opts_to_blob
from tpucomp_torch.ops import bitpack, cascaded_fast
from tpucomp_torch.ops.cuda import cascaded_expand
from tpucomp_torch.utils import synth

CAP = 4096                # row bytes and decode out_cap
GOLDEN = Path(__file__).parent / "golden"
OFF_LADDER = (5, 7, 33, 63)


def _runs(dtype, n_el, card, seed):
    vals = np.random.default_rng(seed).integers(0, card, n_el // 8 + 1).astype(dtype)
    return np.repeat(vals, 8)[:n_el].tobytes()


_R = np.random.default_rng(21)
# option set -> rows (name -> bytes); each row fits CAP
ROWS = {
    (ElementType.UINT, 2, 1, True): {          # the default (the card's "mixed")
        "runs": _runs(np.uint32, 1024, 7, 1),
        "straddle": _R.integers(2**31 - 50, 2**31 + 50, 1024).astype(np.uint32).tobytes(),
        "lowcard": synth.low_cardinality_ints(CAP, seed=3).tobytes(),
        "random": _R.integers(0, 2**32, 1000, dtype=np.uint64).astype(np.uint32).tobytes(),
        "const": np.full(1024, 7, np.uint32).tobytes(),
        "empty": b"", "bad_size": b"abc"},
    (ElementType.INT, 1, 0, True): {           # the card's "lowcard"
        "walk": np.cumsum(_R.integers(-9, 10, 1024)).astype(np.int32).tobytes(),
        "lowcard": synth.low_cardinality_ints(CAP, seed=5).tobytes(),
        "negatives": np.array([-5, -4, -3, 100, -(2**31)] * 3, np.int32).tobytes()},
    (ElementType.LONGLONG, 2, 1, True): {      # the card's "mortgage"
        "mortgage": synth.mortgage_like(CAP, seed=42).tobytes(),
        "extremes": np.array([0, -1, 1, -(2**63), 2**63 - 1], np.int64).tobytes(),
        "sorted": synth.sorted_ints(CAP, seed=2).tobytes()},
    (ElementType.CHAR, 0, 2, False): {
        "runs": _runs(np.uint8, 4096, 5, 6),
        "signed": _R.integers(-128, 128, 3000).astype(np.int8).tobytes()},
}
OPTS = {k: fc.CascadedOpts(*k) for k in ROWS}


def _ref_opts(o):
    return ref_fc.CascadedOpts(RefType(int(o.type)), o.num_rles, o.num_deltas, o.use_bp)


def _batch(rows):
    cb = ChunkBatch.from_chunks(list(rows.values()), CAP, device="cpu")
    return cb.data.numpy(), cb.sizes.numpy()


def _frames(res):
    return [res[0][i, :res[1][i]].tobytes() for i in range(len(res[1]))]


def _header(nr, nd, tid, n, n1, n2, streams=1):
    """A hand-made frame: the 24-byte header and ``streams`` empty streams
    (32-byte headers, width 0)."""
    u32 = lambda v: int(v).to_bytes(4, "little")        # noqa: E731
    return (bytes([fc.MAGIC, fc.VERSION, nr, nd, tid, 1, 0, 0]) + u32(n) + u32(n1) + u32(n2)
            + bytes(4) + bytes(fc.STREAM_HEADER_BYTES) * streams)


def _golden():
    blob = (GOLDEN / "cascaded.bin").read_bytes()
    n = int(np.frombuffer(blob[:4], np.int32)[0])
    chunks, off = [], 4 + 4 * n
    for s in np.frombuffer(blob[4:4 + 4 * n], np.int32):
        chunks.append(blob[off:off + s])
        off += s
    return chunks


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """This file runs beside the suite's longest file (xdist queues it after
    ``test_zstd.py``): keep its torch ops to one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _host_crc32(data, sizes):
    """``crc32_batch`` through ``binascii`` (a host callback inside jit)."""
    def crcs(d, s):
        return np.array([binascii.crc32(d[i, :s[i]].tobytes()) for i in range(len(s))],
                        np.uint32)
    return jax.pure_callback(crcs, jax.ShapeDtypeStruct(sizes.shape, jnp.uint32),
                             data, sizes)


MGR_DATA = synth.low_cardinality_ints(20_000, seed=17).tobytes()
MGR_CHUNK = 4096
# bitpack rows: every W64 width and some off the ladder, 300 values a row
PACK_BITS = np.array(bitpack.W64 + OFF_LADDER, np.int32)
PACK_N, PACK_COUNT = 300, 257
# expand rows: scalars (n, n1, n2, nr), runs1, runs2, at cap_el = CAP
EXPAND_CASES = {
    "nr0": ((CAP, 0, 0, 0), [], []),
    "no_runs": ((0, 0, 0, 1), [], []),
    "runs_1": ((CAP, CAP, 0, 1), [1] * CAP, []),
    "runs_127_128_129": ((CAP, 4, 0, 1), [127, 128, 129, CAP - 384], []),
    "one_run_cap": ((CAP, 1, 0, 1), [CAP], []),
    "two_passes": ((CAP, 4, 3, 2), [1000, 24, 1024, 2048], [1, 2, 1]),
    "two_passes_dense": ((CAP, 585, 3, 2), [7] * 584 + [8], [300, 200, 85]),
}
# whole-row comparisons only: the Pallas kernel leaves these undefined
CORRUPT_RUNS = {
    "zero_and_long": ((CAP, 6, 0, 1), [0, 5, 0, 9000, 3, -4], []),
    "negative_n": ((0, -3, 0, 1), [4, 4], []),
    "n_over_cap": ((CAP, CAP + 50, 7, 2), [2] * 50, [10, 0, 20000, 1, 1, -1, 3]),
    "nr_above_2": ((CAP, 2, 2, 7), [2048, 2048], [1, 1]),
}
WRAP_CAP = 1 << 16     # 65536 runs of 65536: the int32 starts wrap (one row)


def _expand_inputs(cases, cap=CAP):
    B = len(cases)
    rng = np.random.default_rng(B)
    vlo = rng.integers(-2**31, 2**31, (B, cap)).astype(np.int32)
    vhi = rng.integers(-2**31, 2**31, (B, cap)).astype(np.int32)
    r1 = np.zeros((B, cap), np.int32)
    r2 = np.zeros((B, cap), np.int32)
    sc = np.zeros((B, 4), np.int32)
    for b, (scalars, runs1, runs2) in enumerate(cases.values()):
        r1[b, :len(runs1)] = runs1
        r2[b, :len(runs2)] = runs2
        sc[b] = scalars
    return vlo, vhi, r1, r2, sc


EXPAND_SETS = {"hand": (EXPAND_CASES, CAP), "corrupt": (CORRUPT_RUNS, CAP),
               "wrap": ({"wrap": ((WRAP_CAP, WRAP_CAP, 0, 1), [WRAP_CAP] * WRAP_CAP, [])},
                        WRAP_CAP)}


@pytest.fixture(scope="module")
def ref():
    """Every reference call of this file, once."""
    res = {}
    rng = np.random.default_rng(11)
    v = rng.integers(-2**62, 2**62, (len(PACK_BITS), PACK_N))
    vmin = rng.integers(-1000, 1000, len(PACK_BITS))
    res["pack_in"] = (v, vmin)
    res["pack"] = np.asarray(jax.jit(jax.vmap(
        lambda a, m, b: ref_bp.pack(a, jnp.int32(PACK_COUNT), m, b, 2 * PACK_N + 2)))(
        jnp.asarray(v), jnp.asarray(vmin), jnp.asarray(PACK_BITS)))
    res["unpack"] = np.asarray(jax.jit(jax.vmap(
        lambda w, m, b: ref_bp.unpack(w, PACK_N, b, m)))(
        jnp.asarray(res["pack"]), jnp.asarray(vmin), jnp.asarray(PACK_BITS)))

    frames = []
    for key, rows in ROWS.items():
        d, s = (jnp.asarray(x) for x in _batch(rows))
        o = _ref_opts(OPTS[key])
        cap = ref_fc.max_compressed_chunk_size(CAP, o)
        for name, enc in (("general", ref_fc.compress_batch), ("fast", ref_cf.compress_batch)):
            res["encode", key, name] = [np.asarray(x) for x in enc(d, s, o, cap)]
            frames += [(f"{key[0].name}:{name}:{r}", f) for r, f in
                       zip(rows, _frames(res["encode", key, name])) if f]

    good = dict(frames)["UINT:general:runs"]
    hand = {
        "garbage": np.random.default_rng(0).integers(0, 256, 128, dtype=np.uint8).tobytes(),
        "bad_magic": b"\x00" + good[1:],
        "truncated": good[:len(good) - 40],
        "top_bit_80": _header(0, 0, int(ElementType.UINT), *(0x80000000,) * 3),
        "top_bit_ff": _header(0, 0, int(ElementType.UINT), *(0xFFFFFFFF,) * 3),
        "n_4": _header(0, 0, int(ElementType.UINT), 4, 4, 4),
        "n_over_cap": _header(0, 0, int(ElementType.UINT), 2000, 2000, 2000),
        "bad_type": _header(0, 0, 9, 4, 4, 4),
    }
    gold = _golden()
    named = frames + list(hand.items()) + [(f"golden{i}", g) for i, g in enumerate(gold)]
    cb = ChunkBatch.from_chunks([f for _, f in named], device="cpu")
    res["decode_names"] = [k for k, _ in named]
    res["decode_in"] = (cb.data.numpy(), cb.sizes.numpy())
    c, cs = (jnp.asarray(x) for x in res["decode_in"])
    res["decode", "general"] = [np.asarray(x) for x in ref_fc.decompress_batch(c, cs, CAP)]
    res["decode", "fast"] = [np.asarray(x) for x in ref_cf.decompress_batch(c, cs, CAP)]
    res["sizes"] = np.asarray(jax.jit(jax.vmap(ref_fc.get_decompress_size))(c, cs))

    for label, (cases, cap) in EXPAND_SETS.items():
        args = _expand_inputs(cases, cap)
        res["expand_in", label] = args
        res["expand_chunk", label] = [np.asarray(x) for x in jax.jit(jax.vmap(
            lambda a, b, r1, r2, s: ref_cf._expand_chunk(a, b, r1, r2, s, cap)))(
            *(jnp.asarray(x) for x in args))]
    res["row26"] = [np.asarray(x) for x in ref_ce.expand_batch(
        *(jnp.asarray(x) for x in res["expand_in", "hand"]), cap_el=CAP, interpret=True)]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_crc32, "crc32_batch", _host_crc32)
        res["mgr_frame"] = np.asarray(ref_manager.Manager(
            "cascaded", MGR_CHUNK, _ref_opts(OPTS[ElementType.INT, 1, 0, True]),
            checksum_policy=int(ChecksumPolicy.COMPUTE_AND_VERIFY)).compress(MGR_DATA)).tobytes()
    return res


def _differing(got, want, names):
    got, want = np.asarray(got), np.asarray(want)
    return [names[i] for i in np.nonzero((got != want).reshape(len(names), -1).any(axis=1))[0]]


def _assert_same(got, want, names):
    for k, (g, w) in enumerate(zip(got, want)):
        bad = _differing(g, w, names)
        assert not bad, f"output {k} differs on {bad}"


@pytest.fixture(scope="module")
def port_decode(ref):
    """The port's general decoder and fast decoder (with the expansion's
    plain version) over the reference's decode inputs, once each."""
    c, cs = (torch.from_numpy(x) for x in ref["decode_in"])
    return {"general": [x.numpy() for x in fc.decompress_batch(c, cs, CAP)],
            "fast": [x.numpy() for x in cascaded_fast.decompress_batch(c, cs, CAP, plain=True)]}


# ---------------------------------------------------------------- bitpack ---

def test_bitpack_equals_reference(ref):
    """``pack``/``unpack`` at every ``W64`` width and at 5, 7, 33 and 63 bits
    (words and values), and the width helpers."""
    v, vmin = (torch.from_numpy(x) for x in ref["pack_in"])
    bits = torch.from_numpy(PACK_BITS)
    words = bitpack.pack(v, torch.full((len(bits),), PACK_COUNT), vmin, bits, 2 * PACK_N + 2)
    names = [f"b{b}" for b in PACK_BITS]
    _assert_same([words], [ref["pack"].astype(np.int64)], names)
    _assert_same([bitpack.unpack(words, PACK_N, bits, vmin)], [ref["unpack"]], names)
    x = torch.tensor([-5, 0, 1, 2, 3, 255, 256, 2**31, 2**62, 2**63 - 1])
    assert bitpack.bit_length(x).tolist() == [int(ref_bp.bit_length(jnp.int64(int(t))))
                                              for t in x]
    b = torch.arange(0, 70)
    assert bitpack.round_width(b).tolist() == [int(ref_bp.round_width(jnp.int32(int(t))))
                                               for t in b]
    assert bitpack.round_bits_pow2(b).tolist() == [int(ref_bp.round_bits_pow2(jnp.int32(int(t))))
                                                   for t in b]
    vv = np.array([5, -3, 2**62, -(2**62), 7], np.int64)
    for cnt in (0, 1, 3, 5):
        want = [int(t) for t in ref_bp.choose_width(jnp.asarray(vv), jnp.int32(cnt))]
        got = bitpack.choose_width(torch.from_numpy(vv)[None], torch.tensor([cnt]))
        assert [int(t[0]) for t in got] == want, cnt


def test_static_width_pack_layout():
    """The fast path's static-width packer writes the general packer's words
    at every ladder width, and its unpacker reads them back; ``pack_any`` /
    ``unpack_any`` pick each row's width, an off-ladder one the next below."""
    rng = np.random.default_rng(12)
    n = 300
    for b in bitpack.W64[1:]:
        lo = torch.from_numpy(rng.integers(0, 1 << min(b, 32), (2, n)))
        hi = torch.from_numpy(rng.integers(0, 1 << max(b - 32, 1), (2, n))) if b > 32 \
            else torch.zeros((2, n), dtype=torch.int64)
        words = cascaded_fast._pack_static(lo, hi, b, 2 * n)
        want = bitpack.pack(lo | (hi << 32), torch.tensor([n, n]),
                            torch.zeros(2, dtype=torch.int64), torch.tensor([b, b]), 2 * n)
        assert torch.equal(words, want), b
        l2, h2 = cascaded_fast._unpack_static(words, b, n)
        assert torch.equal(l2, lo) and torch.equal(h2, hi), b
    lo = torch.from_numpy(rng.integers(0, 1 << 16, (3, n))) >> torch.tensor([[0], [4], [4]])
    bits = torch.tensor([16, 12, 13])          # 13 is off the ladder: packed at 12
    words = cascaded_fast.pack_any(lo, torch.zeros_like(lo), bits, n)
    assert torch.equal(words[2], cascaded_fast._pack_static(lo[2:], torch.zeros_like(lo[2:]),
                                                            12, n)[0])
    l2, _ = cascaded_fast.unpack_any(words, bits, n, bitpack.W64)
    assert torch.equal(l2, lo)


# ----------------------------------------------------------------- encode ---

@pytest.mark.parametrize("key", list(ROWS),
                         ids=lambda k: f"{k[0].name}-r{k[1]}d{k[2]}bp{int(k[3])}")
@pytest.mark.parametrize("path", ["general", "fast"])
def test_encoder_equals_reference(ref, key, path):
    """Frames, sizes and statuses on whole rows: the general encoder against
    ``formats/cascaded.py``, the fast one against ``cascaded_fast.py``."""
    d, s = (torch.from_numpy(x) for x in _batch(ROWS[key]))
    cap = fc.max_compressed_chunk_size(CAP, OPTS[key])
    enc = fc.compress_batch if path == "general" else cascaded_fast.compress_batch
    got = [x.numpy() for x in enc(d, s, OPTS[key], cap)]
    _assert_same(got, ref["encode", key, path], list(ROWS[key]))
    st = dict(zip(ROWS[key], got[2]))
    assert st.pop("bad_size", Status.ERROR_INVALID_VALUE) == Status.ERROR_INVALID_VALUE
    assert all(v == Status.SUCCESS for v in st.values())


SHORT_OPTS = fc.CascadedOpts(ElementType.SHORT, 0, 2, True)
SHORT_ROWS = {"runs": _runs(np.int16, 2048, 9, 4),
              "signed": _R.integers(-300, 300, 2000).astype(np.int16).tobytes(),
              "extremes": np.array([-(2**15), 2**15 - 1, 0, -1] * 5, np.int16).tobytes()}


@pytest.mark.parametrize("path", ["general", "fast"])
def test_short_rows_round_trip(path):
    """Signed 2-byte rows (sign extension, two deltas) through each of the
    port's encoders and back through both of its decoders, bit-exact."""
    d, s = (torch.from_numpy(x) for x in _batch(SHORT_ROWS))
    enc = fc.compress_batch if path == "general" else cascaded_fast.compress_batch
    comp, csz, cst = enc(d, s, SHORT_OPTS, fc.max_compressed_chunk_size(CAP, SHORT_OPTS))
    assert (cst == Status.SUCCESS).all()
    for out, sz, st in (fc.decompress_batch(comp, csz, CAP),
                        cascaded_fast.decompress_batch(comp, csz, CAP, plain=True)):
        assert (st == Status.SUCCESS).all() and torch.equal(sz, s)
        assert all(torch.equal(out[i, :s[i]], d[i, :s[i]]) for i in range(len(s)))


def test_encoders_agree_where_the_reference_does(ref):
    """Where the reference's two encoders give the same frame, so do the
    port's; the rows where they differ are the same rows."""
    for key, rows in ROWS.items():
        same_ref = [(ref["encode", key, "general"][0][i] == ref["encode", key, "fast"][0][i]).all()
                    for i in range(len(rows))]
        d, s = (torch.from_numpy(x) for x in _batch(rows))
        cap = fc.max_compressed_chunk_size(CAP, OPTS[key])
        g = fc.compress_batch(d, s, OPTS[key], cap)[0]
        f = cascaded_fast.compress_batch(d, s, OPTS[key], cap)[0]
        assert [bool(torch.equal(g[i], f[i])) for i in range(len(rows))] == same_ref, key


# ----------------------------------------------------------------- decode ---

@pytest.mark.parametrize("path", ["general", "fast"])
def test_decoder_equals_reference(ref, port_decode, path):
    """Rows, sizes and statuses of each decoder against its reference, on
    every frame the encoders made, corrupt and hand-made frames and the
    golden frames."""
    _assert_same(port_decode[path], ref["decode", path], ref["decode_names"])


def test_decoder_statuses(ref, port_decode):
    """The two decoders part where the references part: the golden frames
    (stream widths off the ``W64`` ladder) and the top-bit headers."""
    names = ref["decode_names"]
    gen = dict(zip(names, zip(port_decode["general"][2], port_decode["general"][1])))
    fast = dict(zip(names, zip(port_decode["fast"][2], port_decode["fast"][1])))
    assert [gen[f"golden{i}"] for i in range(3)] == [(0, 4096)] * 3
    assert [fast[f"golden{i}"] for i in range(3)] == [(0, 4096), (12, 0), (12, 0)]
    for k in ("top_bit_80", "top_bit_ff"):
        assert gen[k] == (Status.ERROR_CANNOT_DECOMPRESS, 0) and fast[k] == (Status.SUCCESS, 0)
    assert gen["n_4"] == fast["n_4"] == (Status.SUCCESS, 16)
    for k in ("garbage", "bad_magic", "truncated", "n_over_cap", "bad_type"):
        assert gen[k][0] == fast[k][0] == Status.ERROR_CANNOT_DECOMPRESS, k
    out = port_decode["general"][0]
    raw = (GOLDEN / "input.bin").read_bytes()
    got = [out[names.index(f"golden{i}"), :4096].tobytes() for i in range(3)]
    assert got == [raw[:4096], raw[4096:8192], raw[8192:12288]]
    rows = {f"{key[0].name}:general:{r}": v for key, rs in ROWS.items() for r, v in rs.items()}
    for path in ("general", "fast"):
        o, sz, st = port_decode[path]
        for name, raw_row in rows.items():
            if name in names:
                i = names.index(name)
                assert st[i] == 0 and o[i, :sz[i]].tobytes() == raw_row, (path, name)


# ----------------------------------------------------------------- expand ---

def test_expand_plain_equals_row26(ref):
    """The plain expansion against the reference's row-26 kernel in
    interpret mode, on ``[0, n)`` (where the TPU kernel is defined): nr 0,
    1 and 2, no runs, runs of 1, 127, 128, 129 and cap_el."""
    args = [torch.from_numpy(x) for x in ref["expand_in", "hand"]]
    got = cascaded_expand.expand_batch_plain(*args, CAP)
    n = args[4][:, 0].numpy()
    for k, name in enumerate(EXPAND_CASES):
        for g, w in zip(got, ref["row26"]):
            assert (g[k, :n[k]].numpy() == w[k, :n[k]]).all(), name


@pytest.mark.parametrize("label", list(EXPAND_SETS))
def test_expand_plain_equals_expand_chunk(ref, label):
    """Whole rows against ``cascaded_fast._expand_chunk``, also on
    zero-length, negative and over-long runs, counts outside the row, nr
    above 2 and a row whose int32 run starts wrap."""
    cases, cap = EXPAND_SETS[label]
    args = [torch.from_numpy(x) for x in ref["expand_in", label]]
    got = [x.numpy() for x in cascaded_expand.expand_batch_plain(*args, cap)]
    _assert_same(got, ref["expand_chunk", label], list(cases))


def test_expand_kernel_refuses_cpu_tensors():
    z = torch.zeros((2, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        cascaded_expand.expand_batch(z, z, z, z, torch.zeros((2, 4), dtype=torch.int32), 16)


# -------------------------------------------------------------------- api ---

def test_sizes_and_bounds(ref):
    for o in list(OPTS.values()) + [fc.CascadedOpts(ElementType.BITS, 1, 0, True),
                                    fc.CascadedOpts(ElementType.ULONGLONG, 0, 0, False),
                                    fc.CascadedOpts(ElementType.SHORT, 0, 2, True)]:
        for n in (0, 1, 1000, 4096, 65536):
            assert fc.max_compressed_chunk_size(n, o) == ref_fc.max_compressed_chunk_size(
                n, _ref_opts(o))
    data, sizes = ref["decode_in"]
    got = batched.get_decompress_size(
        "cascaded", ChunkBatch(torch.from_numpy(data), torch.from_numpy(sizes)))
    np.testing.assert_array_equal(got.numpy(), ref["sizes"])
    with pytest.raises(ValueError, match=r"\[0, 2\]"):
        fc.CascadedOpts(num_rles=3)


def test_dispatch_on_the_cpu(monkeypatch):
    """``auto`` and ``xla`` give the general program on the CPU (as the
    reference off the TPU), ``kernel`` raises, and the fast path's shape
    gates hand large rows and out_caps to the general program."""
    spec = batched._get("cascaded")
    cpu = torch.device("cpu")
    for resolve, plain in ((batched._encode_fn, fc.compress_batch),
                           (batched._decode_fn, fc.decompress_batch)):
        assert resolve("cascaded", spec, "auto", cpu) is plain
        assert resolve("cascaded", spec, "xla", cpu) is plain
    buf = synth.low_cardinality_ints(20000, seed=1).tobytes()
    cb = ChunkBatch.from_bytes(buf, 8192, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        batched.compress("cascaded", cb, backend="kernel")
    comp, cst = batched.compress("cascaded", cb, backend="xla")
    with pytest.raises(ValueError, match="CUDA"):
        batched.decompress("cascaded", comp, 8192, backend="kernel")
    dec, dst = batched.decompress("cascaded", comp, 8192)
    assert (cst == 0).all() and (dst == 0).all() and dec.to_bytes() == buf
    fdec = cascaded_fast.decompress_batch(comp.data, comp.sizes, 8192, plain=True)
    assert all(torch.equal(a, b) for a, b in zip(fdec, (dec.data, dec.sizes, dst)))
    calls = []
    monkeypatch.setattr(fc, "compress_batch", lambda *a: calls.append("enc") or "general")
    monkeypatch.setattr(fc, "decompress_batch", lambda *a: calls.append("dec") or "general")
    monkeypatch.setattr(cascaded_fast, "ENCODE_GATE", 4096)
    monkeypatch.setattr(cascaded_fast, "DECODE_GATE", 4096)
    assert cascaded_fast.compress_batch(cb.data, cb.sizes, None, 9216) == "general"
    assert cascaded_fast.decompress_batch(comp.data, comp.sizes, 8192) == "general"
    assert calls == ["enc", "dec"]


def test_manager_frame_equals_reference(ref):
    """The port's CPU Manager frame (general encoder, COMPUTE_AND_VERIFY)
    equals the reference Manager's; ``create_manager`` reads the opts blob
    back, the frame reads back, and a flipped payload byte is a bad
    checksum."""
    opts = OPTS[ElementType.INT, 1, 0, True]
    m = Manager("cascaded", MGR_CHUNK, opts, checksum_policy=ChecksumPolicy.COMPUTE_AND_VERIFY,
                device="cpu")
    frame = m.compress(MGR_DATA)
    assert frame.numpy().tobytes() == ref["mgr_frame"]
    m2 = create_manager(ref["mgr_frame"], device="cpu")
    assert (m2.format, m2.opts) == ("cascaded", opts)
    cfg = m2.configure_decompression(frame)
    assert m2.decompress(frame, cfg).numpy().tobytes() == MGR_DATA
    assert cfg.get_status() == Status.SUCCESS
    bad = frame.clone()
    bad[-10] ^= 0xFF                                   # in the last chunk's stream
    bcfg = m2.configure_decompression(bad)
    m2.decompress(bad, bcfg)
    assert bcfg.get_status() == Status.ERROR_BAD_CHECKSUM


def test_manager_opts_blob():
    for o in OPTS.values():
        blob = _opts_to_blob("cascaded", o)
        assert blob == ref_manager._opts_to_blob("cascaded", _ref_opts(o))
        assert _opts_from_blob("cascaded", blob) == o
