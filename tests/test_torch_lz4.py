"""The port's LZ4 path against the JAX reference, on the CPU.

Plain encode and decode (the Hopper kernels' plain versions) and the batched
API on CPU tensors are held against ``tpucomp``'s Pallas kernels run in
interpret mode (``lz4_encode2`` / ``lz4_decode2``, the reference's dispatched
LZ4 kernels) on the same numpy inputs.  Tolerance: exact equality — every
output is bytes, sizes and status codes.

All reference calls run once, in the module fixture (each costs seconds of
interpret-mode compile); the tests then compare one batch row each.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import tpucomp.batched as ref_batched
from tpucomp.chunk import ChunkBatch as RefBatch
from tpucomp.formats import lz4 as ref_lz4
from tpucomp.ops.pallas import lz4_decode2 as ref_dec
from tpucomp.ops.pallas import lz4_encode2 as ref_enc

from tpucomp_torch import batched
from tpucomp_torch.chunk import ChunkBatch
from tpucomp_torch.constants import ElementType, Status
from tpucomp_torch.formats import lz4 as flz4
from tpucomp_torch.interop import cpu as interop
from tpucomp_torch.ops.cuda import lz4_decode2, lz4_encode2
from tpucomp_torch.utils import synth

# ------------------------------------------------------------------ inputs ---

_MIX = synth.mixed_corpus(16448, seed=5)


def _signed_order(n):
    """Equal 4-byte words followed by words on both sides of the int32 sign:
    the 8-byte-prefix sort must order them as signed values."""
    rng = np.random.default_rng(8)
    tail = rng.choice(np.array([0x01, 0x7F, 0x80, 0xFF], np.uint8), size=(n // 8, 4))
    head = np.tile(np.frombuffer(b"ABCD", np.uint8), (n // 8, 1))
    return np.concatenate([head, tail], axis=1).reshape(-1)


# name -> (function making the cap-4096 row, size); rows past `size` keep
# nonzero bytes, which the candidate sorts see exactly as the reference's do
C4K_ROWS = {
    "mixed0": (lambda: _MIX[0:4096], 4096),
    "mixed1": (lambda: _MIX[4096:8192], 4096),
    "mixed2": (lambda: _MIX[8192:12288], 4096),
    "mixed3": (lambda: _MIX[12288:16384], 4096),
    "runs": (lambda: synth.runs(4096, seed=1), 4096),
    "random": (lambda: synth.gen_data(255, 4096, seed=6), 4096),
    "lowent": (lambda: synth.gen_data(3, 4096, seed=7), 4096),
    "zeros": (lambda: np.zeros(4096, np.uint8), 4096),
    "text": (lambda: synth.text_like(4096, seed=2), 4096),
    "mortgage": (lambda: synth.mortgage_like(4096, seed=3), 4096),
    "signed": (lambda: _signed_order(4096), 4096),
    "size0": (lambda: _MIX[100:4196], 0),
    "size1": (lambda: _MIX[200:4296], 1),
    "size12": (lambda: _MIX[300:4396], 12),
    "size13": (lambda: _MIX[400:4496], 13),
    "size17": (lambda: _MIX[500:4596], 17),
    "size3000": (lambda: _MIX[600:4696], 3000),
}

# multi-slab chunks: the reference streams candidates in 4096-position slabs
C16K_ROWS = {
    "mixed": (lambda: synth.mixed_corpus(16400, seed=9)[:16384], 16384),
    "runs": (lambda: synth.runs(16384, mean_run=900, seed=4), 16384),
    "mortgage": (lambda: synth.mortgage_like(16384, seed=10), 16384),
    "random_short": (lambda: synth.gen_data(255, 16384, seed=11), 10000),
}
C64K_ROWS = {
    "mortgage": (lambda: synth.mortgage_like(65536, seed=42), 65536),
    "mixed": (lambda: synth.mixed_corpus(327680, seed=42)[65536:131072], 65536),
}
ENCODE_SETS = {  # name -> (rows, cap, out_cap)
    "c4k": (C4K_ROWS, 4096, flz4.max_compressed_chunk_size(4096)),
    "c4k_small_out": (C4K_ROWS, 4096, 1024),
    "c16k": (C16K_ROWS, 16384, flz4.max_compressed_chunk_size(16384)),
    "c64k": (C64K_ROWS, 65536, flz4.max_compressed_chunk_size(65536)),
}
ENCODE_CASES = [(s, r) for s, (rows, _, _) in ENCODE_SETS.items() for r in rows]

_HELLO = b"hello world, hello world, hello world!" * 40
_FUZZ_RAW = synth.mixed_corpus(2048, seed=33).tobytes()
_RNG = np.random.default_rng(7)
LIBLZ4_RAWS = {
    "hello": _HELLO,
    "lowent": bytes(_RNG.integers(0, 4, 5000, dtype=np.uint8)),
    "incompressible": bytes(_RNG.integers(0, 256, 700, dtype=np.uint8)),
    "offset1": b"\x00" * 3000,
    "offset2": b"ab" * 1500,
    "offset7": b"abcdefg" * 400,
    "offset300": (b"0123456789abcdef" * 20)[:300] * 12,
    "one_byte": b"x",
    "empty": b"",
    "long_match_ext": b"\x00" * 16384,
    "long_literal_ext": bytes(_RNG.integers(0, 256, 5000, dtype=np.uint8)),
    "overflow_then_garbage": b"tpucomp " * 600,
}
HANDMADE = {
    "offset0": b"\x04abcd\x00\x00",
    "offset_past_output": b"\x04abcd\xff\xff\x04abcd",
    "offset_past_output_only": b"\x10a\x02\x00\x10b",   # off 2 > op 1, then a good end
    "offset_equals_output": b"\x10a\x01\x00\x10b",      # off == op: valid
    "ends_on_match": b"\x40abcd\x01\x00",
    "runaway_literal": b"\xff" * 64,
    "literal_without_data": b"\x10",
    "ext_hits_end": b"\xf0" + b"\xff" * 3,
    "lone_zero_token": b"\x00",
}
FUZZ = ["fuzz_good", "fuzz_cut1", "fuzz_cut2", "fuzz_cut_q", "fuzz_cut_h",
        "fuzz_cut_n2", "fuzz_cut_n1"] + [f"fuzz_flip{i}" for i in range(6)]
DECODE_CASES = (list(LIBLZ4_RAWS) + ["hc0", "hc1"] + list(HANDMADE) + FUZZ
                + ["negative_size"]
                + [f"ref_frame_c16k_{r}" for r in C16K_ROWS]
                + [f"port_frame_c4k_{r}" for r in list(C4K_ROWS)[:4]])
DECODE_OUT_CAPS = {"fits": 16384, "small_out": 1000}
assert len(DECODE_CASES) % 2 == 1  # odd B: the reference pads to pairs


def _rows(rows: dict, cap: int):
    data = np.zeros((len(rows), cap), np.uint8)
    sizes = np.zeros(len(rows), np.int32)
    for i, (build, size) in enumerate(rows.values()):
        row = build()
        data[i, :len(row)] = row
        sizes[i] = size
    return data, sizes


def _fuzz_streams(good: bytes) -> list[bytes]:
    """Truncated and bit-flipped variants, built as tests/test_pallas_fuzz.py does."""
    rng = np.random.default_rng(len(good))
    out = [good]
    n = len(good)
    for cut in (1, 2, n // 4, n // 2, n - 2, n - 1):
        out.append(good[:max(1, cut)])
    for _ in range(6):
        b = bytearray(good)
        b[rng.integers(0, n)] ^= 1 << rng.integers(0, 8)
        out.append(bytes(b))
    return out


def _np(t):
    return [np.asarray(x) for x in t]


# ---------------------------------------------------------------- fixture ---

@pytest.fixture(scope="module")
def results():
    """Every reference call of this file, once, beside the port's."""
    res = {"enc": {}, "dec": {}}
    for sname, (rows, cap, out_cap) in ENCODE_SETS.items():
        data, sizes = _rows(rows, cap)
        ref = _np(ref_enc.compress_batch(jnp.asarray(data), jnp.asarray(sizes),
                                         out_cap, interpret=True))
        port = [t.numpy() for t in lz4_encode2.compress_batch_plain(
            torch.from_numpy(data), torch.from_numpy(sizes), out_cap)]
        res["enc"][sname] = (data, sizes, ref, port)

    # decode inputs: foreign, corrupt and cross-package streams
    streams = {k: interop.lz4_compress(v) for k, v in LIBLZ4_RAWS.items()}
    streams["overflow_then_garbage"] += b"\x00\x00"
    hc_src = synth.mixed_corpus(16400, seed=11).tobytes()
    streams["hc0"] = interop.lz4_compress(hc_src[:8192], hc_level=9)
    streams["hc1"] = interop.lz4_compress(hc_src[8192:16384], hc_level=9)
    streams.update(HANDMADE)
    streams.update(zip(FUZZ, _fuzz_streams(interop.lz4_compress(_FUZZ_RAW))))
    streams["negative_size"] = streams["hello"]
    for sname, prefix, which in (("c16k", "ref_frame_c16k_", 2),    # reference's
                                 ("c4k", "port_frame_c4k_", 3)):    # port's
        out, osz, _ = res["enc"][sname][which]
        for i, r in enumerate(ENCODE_SETS[sname][0]):
            if f"{prefix}{r}" in DECODE_CASES:
                streams[f"{prefix}{r}"] = out[i, :osz[i]].tobytes()
    comp_cap = -(-max(len(s) for s in streams.values()) // 8) * 8
    comp = np.zeros((len(DECODE_CASES), comp_cap), np.uint8)
    csz = np.zeros(len(DECODE_CASES), np.int32)
    for i, name in enumerate(DECODE_CASES):
        s = streams[name]
        comp[i, :len(s)] = np.frombuffer(s, np.uint8)
        csz[i] = -1 if name == "negative_size" else len(s)
    for oname, out_cap in DECODE_OUT_CAPS.items():
        ref = _np(ref_dec.decompress_batch(jnp.asarray(comp), jnp.asarray(csz),
                                           out_cap, interpret=True))
        port = [t.numpy() for t in lz4_decode2.decompress_batch_plain(
            torch.from_numpy(comp), torch.from_numpy(csz), out_cap)]
        res["dec"][oname] = (comp, csz, ref, port)

    # the batched API, reference backend "pallas" vs the port on CPU tensors
    data, sizes, _, _ = res["enc"]["c4k"]
    typed = ref_lz4.LZ4Opts(data_type=ref_lz4.ElementType.INT)
    rb = RefBatch(data=jnp.asarray(data), sizes=jnp.asarray(sizes))
    pb = ChunkBatch.from_numpy(data, sizes, device="cpu")
    res["compress"] = {
        "default": (ref_batched.compress("lz4", rb, backend="pallas"),
                    batched.compress("lz4", pb)),
        "typed_int": (ref_batched.compress("lz4", rb, opts=typed, backend="pallas"),
                      batched.compress("lz4", pb, opts=flz4.LZ4Opts(ElementType.INT))),
    }
    rc = RefBatch(data=jnp.asarray(comp), sizes=jnp.asarray(csz))
    pc = ChunkBatch.from_numpy(comp, csz, device="cpu")
    res["decompress"] = (ref_batched.decompress("lz4", rc, 16384, backend="pallas"),
                         batched.decompress("lz4", pc, 16384))
    return res


# ------------------------------------------------------------------ tests ---

@pytest.mark.parametrize("sname,row", ENCODE_CASES)
def test_plain_encode_equals_reference(results, sname, row):
    data, sizes, (r_out, r_sz, r_st), (p_out, p_sz, p_st) = results["enc"][sname]
    i = list(ENCODE_SETS[sname][0]).index(row)
    assert (p_st[i], p_sz[i]) == (r_st[i], r_sz[i])
    assert p_out[i].tobytes() == r_out[i].tobytes()
    if p_st[i] == Status.SUCCESS:   # a standard LZ4 block that liblz4 reads
        raw = data[i, :sizes[i]].tobytes()
        assert interop.lz4_decompress(p_out[i, :p_sz[i]].tobytes(), len(raw)) == raw
    else:
        assert p_st[i] == Status.ERROR_OUTPUT_BUFFER_TOO_SMALL and p_sz[i] == 0


def test_small_out_cap_hits_too_small(results):
    _, _, _, (_, _, st) = results["enc"]["c4k_small_out"]
    assert (st == Status.ERROR_OUTPUT_BUFFER_TOO_SMALL).sum() >= 3
    assert (st == Status.SUCCESS).sum() >= 3


@pytest.mark.parametrize("oname", list(DECODE_OUT_CAPS))
@pytest.mark.parametrize("name", DECODE_CASES)
def test_plain_decode_equals_reference(results, oname, name):
    _, _, (r_out, r_sz, r_st), (p_out, p_sz, p_st) = results["dec"][oname]
    i = DECODE_CASES.index(name)
    assert (p_st[i], p_sz[i]) == (r_st[i], r_sz[i])
    assert p_out[i].tobytes() == r_out[i].tobytes()


def test_decode_statuses_cover_the_contract(results):
    _, _, _, (_, sz, st) = results["dec"]["fits"]
    by = dict(zip(DECODE_CASES, st.tolist()))
    for name in ("offset0", "offset_past_output", "offset_past_output_only",
                 "ends_on_match",
                 "runaway_literal", "literal_without_data", "ext_hits_end",
                 "negative_size", "overflow_then_garbage"):
        assert by[name] == Status.ERROR_CANNOT_DECOMPRESS, name
    assert by["empty"] == Status.SUCCESS and sz[DECODE_CASES.index("empty")] == 0
    assert by["offset_equals_output"] == Status.SUCCESS
    _, _, _, (_, _, st_small) = results["dec"]["small_out"]
    small = dict(zip(DECODE_CASES, st_small.tolist()))
    assert small["hello"] == Status.ERROR_OUTPUT_BUFFER_TOO_SMALL
    # a parse error after the overflow still wins
    assert small["overflow_then_garbage"] == Status.ERROR_CANNOT_DECOMPRESS


@pytest.mark.parametrize("row", list(C16K_ROWS))
def test_port_decodes_reference_frames(results, row):
    data, sizes, _, _ = results["enc"]["c16k"]
    _, _, _, (out, osz, st) = results["dec"]["fits"]
    i, j = list(C16K_ROWS).index(row), DECODE_CASES.index(f"ref_frame_c16k_{row}")
    assert st[j] == Status.SUCCESS
    assert out[j, :osz[j]].tobytes() == data[i, :sizes[i]].tobytes()


@pytest.mark.parametrize("row", list(C4K_ROWS)[:4])
def test_reference_decodes_port_frames(results, row):
    data, sizes, _, _ = results["enc"]["c4k"]
    _, _, (out, osz, st), _ = results["dec"]["fits"]
    i, j = list(C4K_ROWS).index(row), DECODE_CASES.index(f"port_frame_c4k_{row}")
    assert st[j] == Status.SUCCESS
    assert out[j, :osz[j]].tobytes() == data[i, :sizes[i]].tobytes()


@pytest.mark.parametrize("opts", ["default", "typed_int"])
def test_batched_compress_equals_reference(results, opts):
    (r_cb, r_st), (p_cb, p_st) = results["compress"][opts]
    assert np.array_equal(p_st.numpy(), np.asarray(r_st))
    assert np.array_equal(p_cb.sizes.numpy(), np.asarray(r_cb.sizes))
    assert np.array_equal(p_cb.data.numpy(), np.asarray(r_cb.data))
    if opts == "typed_int":   # sizes 1, 13, 17 are not whole int32 elements
        assert (p_st.numpy() == Status.ERROR_INVALID_VALUE).sum() == 3


def test_batched_decompress_equals_reference(results):
    (r_cb, r_st), (p_cb, p_st) = results["decompress"]
    assert np.array_equal(p_st.numpy(), np.asarray(r_st))
    assert np.array_equal(p_cb.sizes.numpy(), np.asarray(r_cb.sizes))
    assert np.array_equal(p_cb.data.numpy(), np.asarray(r_cb.data))


def test_carry_batch_between_packages(results):
    """A batch compressed by the port crosses to the reference as numpy
    arrays and back: both directions decode to the input."""
    data, sizes, _, _ = results["enc"]["c4k"]
    (_, _), (p_cb, _) = results["compress"]["default"]
    d, s = p_cb.to_numpy()
    back = ChunkBatch.from_numpy(d, s, device="cpu")
    assert torch.equal(back.data, p_cb.data) and torch.equal(back.sizes, p_cb.sizes)
    dec, st = batched.decompress("lz4", back, 4096)
    assert (st.numpy() == Status.SUCCESS).all()
    assert dec.chunk_list() == [data[i, :sizes[i]].tobytes() for i in range(len(sizes))]


def test_batched_roundtrip_verify():
    buf = synth.mixed_corpus(20000, seed=12).tobytes()
    assert batched.roundtrip_verify("lz4", ChunkBatch.from_bytes(buf, 4096, device="cpu"))


@pytest.mark.parametrize("call", ["compress", "decompress"])
def test_alignment_failure_equals_reference(call):
    data = np.arange(18, dtype=np.uint8).reshape(3, 6)
    sizes = np.array([6, 3, 0], np.int32)
    rb = RefBatch(data=jnp.asarray(data), sizes=jnp.asarray(sizes))
    pb = ChunkBatch.from_numpy(data, sizes, device="cpu")
    if call == "compress":
        (r_cb, r_st), (p_cb, p_st) = (ref_batched.compress("lz4", rb),
                                      batched.compress("lz4", pb))
    else:
        (r_cb, r_st), (p_cb, p_st) = (ref_batched.decompress("lz4", rb, 64),
                                      batched.decompress("lz4", pb, 64))
    assert (p_st.numpy() == Status.ERROR_ALIGNMENT).all()
    assert np.array_equal(p_st.numpy(), np.asarray(r_st))
    assert np.array_equal(p_cb.data.numpy(), np.asarray(r_cb.data))
    assert np.array_equal(p_cb.sizes.numpy(), np.asarray(r_cb.sizes))


def test_input_violations_equal_reference():
    sizes = np.array([0, 1, 1 << 24, (1 << 24) + 1, 2**31 - 1, 4096], np.int32)
    r_spec, p_spec = ref_batched._get("lz4"), batched._get("lz4")
    for ro, po in ((ref_lz4.DEFAULT_OPTS, flz4.DEFAULT_OPTS),
                   (ref_lz4.LZ4Opts(data_type=ref_lz4.ElementType.INT),
                    flz4.LZ4Opts(ElementType.INT))):
        want = np.asarray(ref_batched._input_violations("lz4", r_spec, jnp.asarray(sizes), ro))
        got = batched._input_violations("lz4", p_spec, torch.from_numpy(sizes), po).numpy()
        assert np.array_equal(got, want)
