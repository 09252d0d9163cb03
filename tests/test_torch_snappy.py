"""The port's Snappy path against the JAX reference, on the CPU.

Plain encode and decode (the Hopper kernels' plain versions), the preamble
size read and the batched API on CPU tensors are held against ``tpucomp``'s
Pallas kernels run in interpret mode (``snappy_encode2`` / ``snappy_decode``,
the reference's dispatched Snappy kernels) on the same numpy inputs, and
libsnappy reads every frame the port writes.  Tolerance: exact equality —
every output is bytes, sizes and status codes.

All reference calls run once, in the module fixture (each costs seconds of
interpret-mode compile); the tests then compare one batch row each.  The
encoder's rows share one cap of 16 KiB: the 4 KiB rows end in the first of
the reference's four 4096-position slabs, the 16 KiB rows cross all four.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import tpucomp.batched as ref_batched
from tpucomp.chunk import ChunkBatch as RefBatch
from tpucomp.ops.pallas import snappy_decode as ref_dec
from tpucomp.ops.pallas import snappy_encode2 as ref_enc

from tpucomp_torch import batched
from tpucomp_torch.chunk import ChunkBatch
from tpucomp_torch.constants import Status
from tpucomp_torch.formats import snappy as fsnappy
from tpucomp_torch.interop import cpu as interop
from tpucomp_torch.ops.cuda import snappy_decode, snappy_encode2
from tpucomp_torch.utils import synth

# ------------------------------------------------------------------ inputs ---

_MIX = synth.mixed_corpus(20000, seed=5)
CAP = 16384

# name -> (function making the row, size); rows past `size` keep nonzero
# bytes, which the candidate sorts see exactly as the reference's do
ENCODE_ROWS = {
    "mixed0": (lambda: _MIX[0:4096], 4096),
    "mixed1": (lambda: _MIX[4096:8192], 4096),
    "runs": (lambda: synth.runs(4096, seed=1), 4096),
    "random": (lambda: synth.gen_data(255, 4096, seed=6), 4096),
    "zeros": (lambda: np.zeros(4096, np.uint8), 4096),
    "text": (lambda: synth.text_like(4096, seed=2), 4096),
    "mortgage": (lambda: synth.mortgage_like(4096, seed=3), 4096),
    "size0": (lambda: _MIX[100:4196], 0),
    "size1": (lambda: _MIX[200:4296], 1),
    "size3": (lambda: _MIX[300:4396], 3),
    "size4": (lambda: _MIX[400:4496], 4),
    "size5": (lambda: _MIX[500:4596], 5),
    "size17": (lambda: _MIX[600:4696], 17),
    "size3000": (lambda: _MIX[700:4796], 3000),
    "mixed16k": (lambda: _MIX[2000:2000 + CAP], CAP),          # multi-slab
    "zeros16k": (lambda: np.zeros(CAP, np.uint8), CAP),        # 64/60 split
    "random16k": (lambda: synth.gen_data(255, CAP, seed=7), CAP),  # 3-byte tag
}
ENCODE_OUT_CAPS = {"bound": fsnappy.max_compressed_chunk_size(CAP), "small_out": 1024}


def _varint(n: int) -> bytes:
    out = b""
    while True:
        b7 = n & 0x7F
        n >>= 7
        out += bytes([b7 | (0x80 if n else 0)])
        if not n:
            return out


_RNG = np.random.default_rng(7)
LIBSNAPPY_RAWS = {
    "hello": b"hello snappy, hello snappy, hello snappy! " * 40,
    "lowent": bytes(_RNG.integers(0, 4, 5000, dtype=np.uint8)),
    "incompressible": bytes(_RNG.integers(0, 256, 700, dtype=np.uint8)),
    "offset1": b"\x00" * 3000,
    "offset7": b"abcdefg" * 400,
    "offset300": (b"0123456789abcdef" * 20)[:300] * 12,
    "one_byte": b"x",
    "empty": b"",
    "overflow_then_garbage": b"tpucomp " * 600,
}
HANDMADE = {
    # legal streams the encoders never write (tests/test_pallas_snappy.py:72-85)
    # (its length bits spill into the offset: off 260 > op, an error in both)
    "copy1": _varint(20) + b"\x10abcd" + bytes([((16 - 4) << 2) | 1, 4]),
    "copy1_valid": _varint(12) + b"\x0cabcd" + bytes([1 | ((8 - 4) << 2), 4]),
    "copy4": _varint(70) + b"\x00Z" + bytes([(63 << 2) | 3, 1, 0, 0, 0])
    + bytes([(4 << 2) | 3, 1, 0, 0, 0]),
    "literal_2byte_len": _varint(300) + bytes([61 << 2, 299 & 0xFF, 299 >> 8])
    + bytes(range(100)) * 3,
    # corrupt streams (tests/test_pallas_snappy.py:101-106)
    "runaway_varint": b"\xff\xff\xff\xff\xff\x01",
    "copy_offset0": b"\x05\x01\x00\x00",
    "truncated_literal": b"\x0a\xfcabc",
    "random128": bytes(np.random.default_rng(9).integers(0, 256, 128, dtype=np.uint8)),
    # the preamble in int32: bits above 31 drop, the top bit is an error
    "preamble_bit32_dropped": b"\x80\x80\x80\x80\x10",
    "preamble_high_bits_dropped": b"\x85\x80\x80\x80\x70\x10abcde",
    "preamble_negative": b"\x80\x80\x80\x80\x08",
    # too_big is settled by the preamble and beats any later error
    "preamble_above_out_cap": _varint(100000) + b"\x0cabcd",
    "too_big_then_garbage": _varint(100000) + b"\x0cabcd\x05\x00\x00",
    # 4-byte lengths and offsets read as int32
    "literal_len_all_ones": _varint(10) + bytes([63 << 2, 0xFF, 0xFF, 0xFF, 0xFF]),
    "literal_len_bit31": _varint(10) + bytes([63 << 2, 0, 0, 0, 0x80]),
    "copy4_offset_bit31": _varint(8) + b"\x0cabcd" + bytes([(3 << 2) | 3, 0, 0, 0, 0x80]),
    "copy4_offset_past_output": _varint(8) + b"\x0cabcd" + bytes([(3 << 2) | 3, 5, 0, 0, 0]),
    "copy_only_header": _varint(8) + b"\x0cabcd\x0e",
    "length_mismatch": _varint(9) + b"\x0cabcd",
    "lone_zero": b"\x00",
}
FUZZ = ["fuzz_good", "fuzz_cut1", "fuzz_cut2", "fuzz_cut_q", "fuzz_cut_h",
        "fuzz_cut_n2", "fuzz_cut_n1"] + [f"fuzz_flip{i}" for i in range(6)]
DECODE_CASES = (list(LIBSNAPPY_RAWS) + list(HANDMADE) + FUZZ + ["negative_size"]
                + [f"ref_frame_{r}" for r in ("mixed0", "zeros", "mixed16k")]
                + [f"port_frame_{r}" for r in ("mixed1", "text", "size5")])
DECODE_OUT_CAPS = {"fits": CAP, "small_out": 1000}


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
    data, sizes = _rows(ENCODE_ROWS, CAP)
    for oname, out_cap in ENCODE_OUT_CAPS.items():
        ref = _np(ref_enc.compress_batch(jnp.asarray(data), jnp.asarray(sizes),
                                         out_cap, interpret=True))
        port = [t.numpy() for t in snappy_encode2.compress_batch_plain(
            torch.from_numpy(data), torch.from_numpy(sizes), out_cap)]
        res["enc"][oname] = (ref, port)
    res["enc_in"] = (data, sizes)

    # decode inputs: foreign, hand-made, corrupt and cross-package streams
    streams = {k: interop.snappy_compress(v) for k, v in LIBSNAPPY_RAWS.items()}
    streams["overflow_then_garbage"] += b"\x05\x00\x00"
    streams.update(HANDMADE)
    good = interop.snappy_compress(synth.mixed_corpus(2048, seed=33).tobytes())
    streams.update(zip(FUZZ, _fuzz_streams(good)))
    streams["negative_size"] = streams["hello"]
    names = list(ENCODE_ROWS)
    for prefix, which in (("ref_frame_", 0), ("port_frame_", 1)):
        out, osz, _ = res["enc"]["bound"][which]
        for name in DECODE_CASES:
            if name.startswith(prefix):
                i = names.index(name[len(prefix):])
                streams[name] = out[i, :osz[i]].tobytes()
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
        port = [t.numpy() for t in snappy_decode.decompress_batch_plain(
            torch.from_numpy(comp), torch.from_numpy(csz), out_cap)]
        res["dec"][oname] = (ref, port)
    res["dec_in"] = (comp, csz)

    # the batched API, reference backend "pallas" vs the port on CPU tensors
    # (the same shapes and caps as above, so the reference reuses its compiles)
    rb = RefBatch(data=jnp.asarray(data), sizes=jnp.asarray(sizes))
    pb = ChunkBatch.from_numpy(data, sizes, device="cpu")
    rc = RefBatch(data=jnp.asarray(comp), sizes=jnp.asarray(csz))
    pc = ChunkBatch.from_numpy(comp, csz, device="cpu")
    res["compress"] = (ref_batched.compress("snappy", rb, backend="pallas"),
                       batched.compress("snappy", pb))
    res["decompress"] = (ref_batched.decompress("snappy", rc, CAP, backend="pallas"),
                         batched.decompress("snappy", pc, CAP))
    res["size"] = (np.asarray(ref_batched.get_decompress_size("snappy", rc)),
                   batched.get_decompress_size("snappy", pc).numpy())
    return res


# ------------------------------------------------------------------ tests ---

@pytest.mark.parametrize("oname", list(ENCODE_OUT_CAPS))
@pytest.mark.parametrize("row", list(ENCODE_ROWS))
def test_plain_encode_equals_reference(results, oname, row):
    (r_out, r_sz, r_st), (p_out, p_sz, p_st) = results["enc"][oname]
    i = list(ENCODE_ROWS).index(row)
    assert (p_st[i], p_sz[i]) == (r_st[i], r_sz[i])
    assert p_out[i].tobytes() == r_out[i].tobytes()


@pytest.mark.parametrize("row", list(ENCODE_ROWS))
def test_libsnappy_reads_port_frames(results, row):
    data, sizes = results["enc_in"]
    _, (out, osz, st) = results["enc"]["bound"]
    i = list(ENCODE_ROWS).index(row)
    assert st[i] == Status.SUCCESS
    assert interop.snappy_decompress(out[i, :osz[i]].tobytes()) == \
        data[i, :sizes[i]].tobytes()


def test_small_out_cap_hits_too_small(results):
    _, (out, osz, st) = results["enc"]["small_out"]
    assert (st == Status.ERROR_OUTPUT_BUFFER_TOO_SMALL).sum() >= 3
    assert (st == Status.SUCCESS).sum() >= 3
    bad = st != Status.SUCCESS
    assert (osz[bad] == 0).all() and not out[bad].any()


@pytest.mark.parametrize("oname", list(DECODE_OUT_CAPS))
@pytest.mark.parametrize("name", DECODE_CASES)
def test_plain_decode_equals_reference(results, oname, name):
    (r_out, r_sz, r_st), (p_out, p_sz, p_st) = results["dec"][oname]
    i = DECODE_CASES.index(name)
    assert (p_st[i], p_sz[i]) == (r_st[i], r_sz[i])
    assert p_out[i].tobytes() == r_out[i].tobytes()


def test_decode_statuses_cover_the_contract(results):
    _, (_, sz, st) = results["dec"]["fits"]
    by = dict(zip(DECODE_CASES, st.tolist()))
    size = dict(zip(DECODE_CASES, sz.tolist()))
    for name in ("runaway_varint", "copy_offset0", "truncated_literal",
                 "preamble_negative", "literal_len_all_ones", "literal_len_bit31",
                 "copy4_offset_bit31", "copy4_offset_past_output",
                 "copy_only_header", "length_mismatch", "negative_size", "copy1"):
        assert by[name] == Status.ERROR_CANNOT_DECOMPRESS, name
    for name in ("preamble_above_out_cap", "too_big_then_garbage"):
        assert by[name] == Status.ERROR_OUTPUT_BUFFER_TOO_SMALL, name
    for name in ("copy1_valid", "copy4", "literal_2byte_len", "empty", "lone_zero",
                 "preamble_bit32_dropped", "preamble_high_bits_dropped"):
        assert by[name] == Status.SUCCESS, name
    assert size["preamble_bit32_dropped"] == 0
    assert size["preamble_high_bits_dropped"] == 5
    _, (_, _, st_small) = results["dec"]["small_out"]
    small = dict(zip(DECODE_CASES, st_small.tolist()))
    assert small["hello"] == Status.ERROR_OUTPUT_BUFFER_TOO_SMALL


@pytest.mark.parametrize("name", [n for n in DECODE_CASES if n.startswith(("ref_", "port_"))])
def test_frames_cross_decode(results, name):
    """The port reads the reference's frames and the reference the port's."""
    data, sizes = results["enc_in"]
    i = list(ENCODE_ROWS).index(name.split("frame_")[1])
    j = DECODE_CASES.index(name)
    reader = 1 if name.startswith("ref_") else 0
    out, osz, st = results["dec"]["fits"][reader]
    assert st[j] == Status.SUCCESS
    assert out[j, :osz[j]].tobytes() == data[i, :sizes[i]].tobytes()


def test_get_decompress_size_equals_reference(results):
    ref, port = results["size"]
    assert port.dtype == np.int32 and np.array_equal(port, ref)
    by = dict(zip(DECODE_CASES, port.tolist()))
    assert by["preamble_negative"] < 0 and by["negative_size"] == 0


def test_batched_compress_equals_reference(results):
    (r_cb, r_st), (p_cb, p_st) = results["compress"]
    assert np.array_equal(p_st.numpy(), np.asarray(r_st))
    assert np.array_equal(p_cb.sizes.numpy(), np.asarray(r_cb.sizes))
    assert np.array_equal(p_cb.data.numpy(), np.asarray(r_cb.data))


def test_batched_decompress_equals_reference(results):
    (r_cb, r_st), (p_cb, p_st) = results["decompress"]
    assert np.array_equal(p_st.numpy(), np.asarray(r_st))
    assert np.array_equal(p_cb.sizes.numpy(), np.asarray(r_cb.sizes))
    assert np.array_equal(p_cb.data.numpy(), np.asarray(r_cb.data))


def test_batched_roundtrip_verify():
    buf = synth.mixed_corpus(20000, seed=12).tobytes()
    assert batched.roundtrip_verify("snappy", ChunkBatch.from_bytes(buf, 4096, device="cpu"))


def test_libsnappy_oracle_round_trip():
    raw = synth.mixed_corpus(10000, seed=2).tobytes()
    assert interop.snappy_decompress(interop.snappy_compress(raw)) == raw
    assert interop.available()["snappy"]
