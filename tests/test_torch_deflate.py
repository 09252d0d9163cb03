"""The port's Deflate and gzip paths against the JAX reference, on the CPU.

The plain decoder, the plain encoder in its three modes (algo 0 fixed codes,
algo 1 dynamic codes, algo 2 dynamic codes without matches), the dynamic
tables and the gzip path are held against ``tpucomp``'s Pallas kernels run
in interpret mode (``deflate_decode``, ``deflate_encode``, the gzip entry of
``PALLAS_DECODERS``) on the same numpy inputs, and zlib (and libdeflate, where
it loads) reads every frame the port writes.  The port's Manager frame for
deflate (algo 1, ``COMPUTE_AND_VERIFY``) is byte-identical to
``tpucomp.manager``'s with the reference on its Pallas backends, as
``tests/test_torch_manager.py`` holds the lz4 and snappy frames, and each
package reads the other's.  Tolerance: exact equality — every output is
bytes, sizes, status codes or table words.

All reference calls run once, in the module fixture (each costs seconds of
interpret-mode compile).  In the reference's gzip path the CRC32 words come
from ``binascii.crc32`` through a host callback, as in
``tests/test_torch_manager.py``: its own CRC32 costs some 15 s of compile,
and that file holds it equal to ``binascii``.  Keep this file below 26
cases, so xdist queues it after ``tests/test_zstd.py`` (``ROADMAP.md``).
"""
import binascii
import io
import gzip as pygzip
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpucomp.formats.crc32 as ref_crc32
import tpucomp.manager as ref_manager
from tpucomp.formats import deflate as ref_fdeflate
from tpucomp.formats import gzip as ref_fgzip
from tpucomp.ops import pallas as ref_pallas
from tpucomp.ops.pallas import deflate_decode as ref_dec
from tpucomp.ops.pallas import deflate_encode as ref_enc

from tpucomp_torch import batched
from tpucomp_torch.chunk import ChunkBatch
from tpucomp_torch.constants import Status
from tpucomp_torch.formats import deflate as fdeflate
from tpucomp_torch.formats import gzip as fgzip
from tpucomp_torch.interop import cpu as interop
from tpucomp_torch.manager import ChecksumPolicy, Manager, create_manager
from tpucomp_torch.ops.cuda import deflate_decode, deflate_encode
from tpucomp_torch.utils import synth

# ------------------------------------------------------------------ inputs ---


class _Bits:
    """An LSB-first bit writer for hand-made streams."""

    def __init__(self):
        self.acc, self.n = 0, 0

    def put(self, v, n):
        self.acc |= v << self.n
        self.n += n

    def code(self, c, n):                     # Huffman codes go MSB first
        self.put(int(f"{c:0{n}b}"[::-1], 2), n)

    def bytes(self):
        return self.acc.to_bytes((self.n + 7) // 8, "little")


def _lone_distance_stream(bad_distance: bool = False) -> bytes:
    """A dynamic block whose distance code has one code of length 1 (an
    incomplete code, accepted until its missing code '1' is read): 'a', then
    five matches of 258 at distance 1.  Lit/len lengths: 97 -> 1, 256 -> 2,
    285 -> 2; CL lengths 2 for symbols 0, 1, 2 and 18."""
    b = _Bits()
    b.put(1, 1)
    b.put(2, 2)
    b.put(29, 5)                               # HLIT 286
    b.put(0, 5)                                # HDIST 1
    b.put(14, 4)                               # HCLEN 18
    cl = {0: 2, 1: 2, 2: 2, 18: 2}
    for s in [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1]:
        b.put(cl.get(s, 0), 3)
    clc = {0: 0, 1: 1, 2: 2, 18: 3}            # canonical, all of length 2
    for sym, extra in [(18, 86), (1, None), (18, 127), (18, 9), (2, None), (18, 17),
                       (2, None), (1, None)]:
        b.code(clc[sym], 2)
        if extra is not None:
            b.put(extra, 7)
    b.code(0, 1)                               # 'a'
    for _ in range(5):
        b.code(3, 2)                           # length 258
        b.code(1 if bad_distance else 0, 1)    # distance 1
    b.code(2, 2)                               # EOB
    return b.bytes()


def _oversubscribed_cl_stream() -> bytes:
    """A dynamic header whose 19 code-length codes all have length 1."""
    b = _Bits()
    for v, n in [(1, 1), (2, 2), (0, 5), (0, 5), (15, 4)] + [(1, 3)] * 19 + [(0, 16)]:
        b.put(v, n)
    return b.bytes()


_RNG = np.random.default_rng(9)
_MIX = synth.mixed_corpus(140_000, seed=4)
_RAWS = [b"hello deflate, hello deflate! " * 30, bytes(_RNG.integers(0, 4, 3000, dtype=np.uint8)),
         bytes(_RNG.integers(0, 256, 700, dtype=np.uint8)), b"\x00" * 3000, b"ab" * 1200,
         b"x", b"", _MIX[:6000].tobytes()]


def _decode_streams() -> dict:
    s = {f"zlib{lv}_{i}": interop.deflate_compress(r, lv)
         for i, r in enumerate(_RAWS) for lv in (0, 1, 6, 9)}
    if interop.available()["libdeflate"]:
        s.update({f"libdeflate{lv}": interop.libdeflate_compress(_RAWS[-1], lv) for lv in (1, 9)})
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    s["multiblock"] = (co.compress(_RAWS[-1][:2000]) + co.flush(zlib.Z_FULL_FLUSH)
                       + co.compress(_RAWS[-1][2000:]) + co.flush())
    s["lone_distance"] = _lone_distance_stream()
    s["lone_distance_missing_code"] = _lone_distance_stream(bad_distance=True)
    # corrupt streams (tests/test_pallas_deflate.py:101-108)
    s.update(btype3=b"\x07" * 40, truncated_fixed=b"\x05\x00",
             stored_nlen=b"\x01\x05\x00\x00\x00hi", stored_past_end=b"\x01\xff\xff\x00\x00",
             random96=bytes(_RNG.integers(0, 256, 96, dtype=np.uint8)), empty=b"",
             oversubscribed_cl=_oversubscribed_cl_stream())
    good = s["zlib6_7"]
    for k in (1, 2, len(good) // 4, len(good) // 2, len(good) - 2, len(good) - 1):
        s[f"cut{k}"] = good[:k]
    for i in range(12):
        b = bytearray(good)
        b[_RNG.integers(0, len(good))] ^= 1 << _RNG.integers(0, 8)
        s[f"flip{i}"] = bytes(b)
    return s


DECODE = _decode_streams()
DECODE_OUT_CAPS = {"fits": 8192, "small_out": 1000}

CAP = 65536
ENCODE_ROWS = {  # name -> (row, size)
    "random": (_RNG.integers(0, 256, CAP, dtype=np.uint8), CAP),    # two stored blocks
    "zeros": (np.zeros(CAP, np.uint8), CAP),                        # 258-byte matches
    "mixed": (_MIX[6000:6000 + CAP], CAP),
    "mortgage": (synth.mortgage_like(CAP, seed=5), CAP),
    "ab": (np.frombuffer(b"ab" * (CAP // 2), np.uint8), CAP),       # a lone distance code
    **{f"size{n}": (_MIX[70000:70000 + CAP], n) for n in (0, 1, 3, 4, 20)},
}
SMALL_OUT_ROWS = ["random", "mixed", "ab", "size20"]
ALGOS = [0, 1, 2]
# entropy-only coding at a small out_cap takes algo 1's emit path: no case
ENCODE_CASES = [(0, "bound"), (0, "small_out"), (1, "bound"), (1, "small_out"), (2, "bound")]


def _batch(names):
    data = np.stack([ENCODE_ROWS[n][0] for n in names])
    sizes = np.array([ENCODE_ROWS[n][1] for n in names], np.int32)
    return data, sizes


def _ref_encode(algo, data, sizes, out_cap):
    if algo == 0:
        r = ref_enc.compress_batch(data, sizes, out_cap, interpret=True)
    else:
        r = ref_enc.compress_batch_dyn(data, sizes, out_cap, interpret=True,
                                       entropy_only=algo == 2)
    return [np.asarray(x) for x in r]


def _port_encode(algo, data, sizes, out_cap):
    d, s = torch.from_numpy(data), torch.from_numpy(sizes)
    if algo == 0:
        r = deflate_encode.compress_batch_plain(d, s, out_cap)
    else:
        r = deflate_encode.compress_batch_dyn_plain(d, s, out_cap, entropy_only=algo == 2)
    return [x.numpy() for x in r]


def _gzip_members() -> dict:
    text = synth.text_like(3000, seed=2).tobytes()
    m = {"text": interop.gzip_compress(text), "empty": interop.gzip_compress(b""),
         "lowent": interop.gzip_compress(bytes(_RNG.integers(0, 8, 2500, dtype=np.uint8)))}
    bad = bytearray(m["text"])
    bad[-6] ^= 0xFF
    m["bad_crc"] = bytes(bad)
    bad = bytearray(m["text"])
    bad[-2] ^= 0x01
    m["bad_isize"] = bytes(bad)
    m["truncated"] = m["lowent"][:20]
    buf = io.BytesIO()
    with pygzip.GzipFile(filename="some/file/name.bin", mode="wb", fileobj=buf,
                         mtime=12345) as f:
        f.write(text)
    m["fname"] = buf.getvalue()
    body = interop.deflate_compress(text)
    trailer = binascii.crc32(text).to_bytes(4, "little") + len(text).to_bytes(4, "little")
    m["fextra_fcomment"] = (b"\x1f\x8b\x08\x14\x00\x00\x00\x00\x00\x03" + b"\x04\x00abcd"
                            + b"a comment\x00" + body + trailer)
    m["fhcrc"] = b"\x1f\x8b\x08\x02\x00\x00\x00\x00\x00\x03\x00\x00" + body + trailer
    m["fname_no_nul"] = b"\x1f\x8b\x08\x08\x00\x00\x00\x00\x00\x03" + b"x" * 30
    m["bad_magic"] = b"\x1f\x8c" + m["text"][2:]
    return m


GZIP = _gzip_members()


def _host_crc32_chunk(data, size):
    """``crc32_chunk`` through ``binascii`` (a host callback, vmapped)."""
    def crcs(d, s):
        d2, s1 = d.reshape(-1, d.shape[-1]), np.reshape(s, -1)
        return np.array([binascii.crc32(d2[i, :s1[i]].tobytes()) for i in range(len(s1))],
                        np.uint32).reshape(np.shape(s))
    return jax.pure_callback(crcs, jax.ShapeDtypeStruct(size.shape, jnp.uint32), data, size,
                             vmap_method="expand_dims")


def _host_crc32_batch(data, sizes):
    """``crc32_batch`` through ``binascii`` (a host callback inside jit)."""
    def crcs(d, s):
        return np.array([binascii.crc32(d[i, :s[i]].tobytes()) for i in range(len(s))],
                        np.uint32)
    return jax.pure_callback(crcs, jax.ShapeDtypeStruct(sizes.shape, jnp.uint32), data, sizes)


MANAGER_DATA = _MIX[100_000:124_000].tobytes()
MANAGER_CHUNK = 4096


def _port_manager(**kw):
    return Manager("deflate", MANAGER_CHUNK, fdeflate.DeflateOpts(1),
                   checksum_policy=ChecksumPolicy.COMPUTE_AND_VERIFY, device="cpu", **kw)


def _hist_cases() -> tuple[np.ndarray, np.ndarray]:
    """Edge histograms for the dynamic tables: ties everywhere (uniform),
    Fibonacci counts (the 15-bit and 7-bit limits and the Kraft repair), a
    lone literal, EOB alone, no matches, all 286 symbols, random."""
    fib = [1, 1]
    while len(fib) < 40:
        fib.append(fib[-1] + fib[-2])
    rng = np.random.default_rng(5)
    llh, dh = np.zeros((8, 288), np.int64), np.zeros((8, 30), np.int64)
    llh[0, :256], llh[0, 256] = 200, 1
    llh[1, :30], llh[1, 256] = fib[:30], 1
    dh[1] = fib[:30]
    llh[2, 65], llh[2, 256] = 4000, 1
    llh[3, 256] = 1
    llh[4, :256] = rng.integers(0, 300, 256)
    llh[4, 256] = 1
    llh[5, :286] = rng.integers(1, 40, 286)
    dh[5] = rng.integers(1, 40, 30)
    llh[6, :286] = 1
    llh[6, 100] = 60000
    dh[6, 3] = 500
    llh[7, :286] = rng.integers(0, 5000, 286)
    dh[7] = rng.integers(0, 3000, 30)
    return llh.astype(np.int32), dh.astype(np.int32)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """This file runs beside the suite's longest file (xdist queues it after
    ``test_zstd.py``): keep its torch ops to one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    """Every reference call of this file, once."""
    res = {}
    dec = ChunkBatch.from_chunks(list(DECODE.values()), device="cpu")
    res["decode_in"] = (dec.data.numpy(), dec.sizes.numpy())
    for name, cap in DECODE_OUT_CAPS.items():
        res["decode", name] = [np.asarray(x) for x in ref_dec.decompress_batch(
            *res["decode_in"], cap, interpret=True)]
    bound = fdeflate.max_compressed_chunk_size(CAP)
    for algo, out_cap in ENCODE_CASES:
        res["encode", algo, out_cap] = (
            _ref_encode(algo, *_batch(ENCODE_ROWS), bound) if out_cap == "bound"
            else _ref_encode(algo, *_batch(SMALL_OUT_ROWS), 1024))
    llh, dh = _hist_cases()
    with jax.enable_x64(False):
        res["dyn_tables"] = [np.asarray(x) for x in jax.vmap(ref_enc._dyn_tables)(
            jnp.asarray(llh), jnp.asarray(dh))]
    gz = ChunkBatch.from_chunks(list(GZIP.values()), 4096, device="cpu")
    res["gzip_in"] = (gz.data.numpy(), gz.sizes.numpy())
    # the port's frame, outside the backend variables below
    port_frame = _port_manager().compress(MANAGER_DATA).numpy().tobytes()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_crc32, "crc32_chunk", _host_crc32_chunk)
        mp.setattr(ref_crc32, "crc32_batch", _host_crc32_batch)
        res["gzip"] = [np.asarray(x) for x in ref_pallas.PALLAS_DECODERS["gzip"](
            *res["gzip_in"], 4096)]
        mp.setenv("TPUCOMP_DECODE_BACKEND", "pallas")
        mp.setenv("TPUCOMP_ENCODE_BACKEND", "pallas")
        res["ref_frame"] = np.asarray(ref_manager.Manager(
            "deflate", MANAGER_CHUNK, opts=ref_fdeflate.DeflateOpts(1),
            checksum_policy=int(ChecksumPolicy.COMPUTE_AND_VERIFY)).compress(
                MANAGER_DATA)).tobytes()
        m = ref_manager.create_manager(port_frame)
        cfg = m.configure_decompression(port_frame)
        res["ref_reads_port"] = (np.asarray(m.decompress(port_frame, cfg)).tobytes(),
                                 int(cfg.get_status()))
    res["gzip_size"] = np.asarray(jax.vmap(ref_fgzip.get_decompress_size)(*res["gzip_in"]))
    return res


# ----------------------------------------------------------------- decode ---

@pytest.mark.parametrize("out_cap", list(DECODE_OUT_CAPS))
def test_decoder_equals_reference(ref, out_cap):
    data, sizes = ref["decode_in"]
    got = deflate_decode.decompress_batch_plain(torch.from_numpy(data),
                                                torch.from_numpy(sizes),
                                                DECODE_OUT_CAPS[out_cap])
    want = ref["decode", out_cap]
    names = list(DECODE)
    for k in range(3):
        bad = [names[i] for i in np.nonzero((got[k].numpy() != want[k]).reshape(
            len(names), -1).any(axis=1))[0]]
        assert not bad, f"output {k} differs on {bad}"


def test_decoder_reads_oracle_streams_and_rejects_corrupt_ones(ref):
    out, osz, stat = ref["decode", "fits"]
    names = list(DECODE)
    ok = {n for n, st in zip(names, stat) if st == Status.SUCCESS}
    raws = {f"zlib{lv}_{i}": r for i, r in enumerate(_RAWS) for lv in (0, 1, 6, 9)}
    raws.update({n: _RAWS[-1] for n in names if n.startswith("libdeflate")},
                multiblock=_RAWS[-1], lone_distance=b"a" * 1291)
    assert set(raws) <= ok
    for n, r in raws.items():
        i = names.index(n)
        assert out[i, :osz[i]].tobytes() == r, n
    for n in ["lone_distance_missing_code", "btype3", "truncated_fixed", "stored_nlen",
              "stored_past_end", "empty", "oversubscribed_cl", "cut1"]:
        assert stat[names.index(n)] == Status.ERROR_CANNOT_DECOMPRESS, n


# ----------------------------------------------------------------- encode ---

@pytest.mark.parametrize("algo,out_cap", ENCODE_CASES)
def test_encoder_equals_reference(ref, algo, out_cap):
    names = list(ENCODE_ROWS) if out_cap == "bound" else SMALL_OUT_ROWS
    cap = fdeflate.max_compressed_chunk_size(CAP) if out_cap == "bound" else 1024
    got = _port_encode(algo, *_batch(names), cap)
    want = ref["encode", algo, out_cap]
    for k in range(3):
        bad = [names[i] for i in np.nonzero((got[k] != want[k]).reshape(
            len(names), -1).any(axis=1))[0]]
        assert not bad, f"output {k} differs on {bad}"
    if out_cap == "small_out":
        assert (want[2] == Status.ERROR_OUTPUT_BUFFER_TOO_SMALL).sum() >= 2


@pytest.mark.parametrize("algo", ALGOS)
def test_zlib_and_decoders_read_port_frames(algo):
    out, osz, stat = _port_encode(algo, *_batch(ENCODE_ROWS),
                                  fdeflate.max_compressed_chunk_size(CAP))
    assert (stat == Status.SUCCESS).all()
    frames = [out[i, :osz[i]].tobytes() for i in range(len(osz))]
    raws = [r[:n].tobytes() for r, n in ENCODE_ROWS.values()]
    for f, r in zip(frames, raws):
        assert zlib.decompress(f, -15) == r
        if interop.available()["libdeflate"]:
            assert interop.libdeflate_decompress(f, len(r)) == r
    cb = ChunkBatch.from_chunks(frames, fdeflate.max_compressed_chunk_size(CAP), device="cpu")
    dec, dsz, dst = deflate_decode.decompress_batch_plain(cb.data, cb.sizes, CAP)
    assert (dst == Status.SUCCESS).all()
    assert [dec[i, :dsz[i]].numpy().tobytes() for i in range(len(raws))] == raws


def test_dyn_tables_equal_reference(ref):
    llh, dh = _hist_cases()
    got = deflate_encode.dyn_tables(torch.from_numpy(llh), torch.from_numpy(dh))
    for g, w in zip(got, ref["dyn_tables"]):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)
    assert (got[2] > 3).any() and (got[2] == 3).any()      # dynamic and fixed headers


def test_huff_lengths_equal_reference():
    fib = np.array([1, 1, 2, 3, 5, 8, 13, 21, 34, 55, 89, 144, 233, 377, 610, 987, 1597,
                    2584, 4181, 6765, 10946], np.int32)
    cases = [(np.full(19, 7, np.int32), 7), (fib[:19], 7), (fib, 15),
             (np.pad(fib, (0, 265)), 15), (np.zeros(30, np.int32), 15),
             (np.eye(1, 30, 4, dtype=np.int32)[0] * 9, 15)]
    with jax.enable_x64(False):
        for freq, max_len in cases:
            want = [np.asarray(x) for x in ref_fdeflate._huff_lengths(jnp.asarray(freq),
                                                                      max_len)]
            lens, ok = fdeflate.huff_lengths(torch.from_numpy(freq)[None], max_len)
            np.testing.assert_array_equal(lens[0].numpy(), want[0])
            assert bool(ok[0]) == bool(want[1])
            codes = fdeflate.assign_codes(lens, max_len)[0].numpy()
            np.testing.assert_array_equal(
                codes, np.asarray(ref_fdeflate._assign_codes(jnp.asarray(want[0]), max_len)))


# ------------------------------------------------------------------- gzip ---

def test_gzip_equals_reference(ref):
    data, sizes = ref["gzip_in"]
    got = batched.decompress("gzip", ChunkBatch(torch.from_numpy(data),
                                                torch.from_numpy(sizes)), 4096)
    got = (got[0].data.numpy(), got[0].sizes.numpy(), got[1].numpy())
    names = list(GZIP)
    for k in range(3):
        np.testing.assert_array_equal(got[k], ref["gzip"][k], err_msg=f"output {k}")
    ok = [n for n, st in zip(names, got[2]) if st == Status.SUCCESS]
    assert ok == ["text", "empty", "lowent", "fname", "fextra_fcomment", "fhcrc"]
    size = fgzip.get_decompress_size(torch.from_numpy(data), torch.from_numpy(sizes))
    np.testing.assert_array_equal(size.numpy(), ref["gzip_size"])


# -------------------------------------------------------------------- api ---

def test_batched_api_and_bounds():
    for n in (0, 1, 1000, 4096, 65536):
        assert fdeflate.max_compressed_chunk_size(n) == ref_fdeflate.max_compressed_chunk_size(n)
        assert fgzip.max_compressed_chunk_size(n) == ref_fgzip.max_compressed_chunk_size(n)
    assert fdeflate.max_compressed_chunk_size(65536) == 99328
    buf = _MIX[:70000].tobytes()
    cb = ChunkBatch.from_bytes(buf, 16384, device="cpu")
    for algo in ALGOS:
        comp, cst = batched.compress("deflate", cb, fdeflate.DeflateOpts(algo))
        dec, dst = batched.decompress("deflate", comp, 16384)
        assert (cst == 0).all() and (dst == 0).all() and dec.to_bytes() == buf
    with pytest.raises(ValueError, match="gzip provides decompression only"):
        batched.compress("gzip", cb)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        batched.get_decompress_size("deflate", cb)
    with pytest.raises(NotImplementedError, match="formats/deflate.py"):
        batched.decompress("deflate", cb, 16384, backend="xla")
    with pytest.raises(ValueError, match="CUDA"):
        batched.compress("deflate", cb, backend="kernel")


def test_manager_frame_equals_reference(ref):
    port = _port_manager().compress(MANAGER_DATA).numpy().tobytes()
    assert port == ref["ref_frame"]
    assert ref["ref_reads_port"] == (MANAGER_DATA, Status.SUCCESS)
    m = create_manager(ref["ref_frame"], device="cpu")
    assert (m.format, m.opts) == ("deflate", fdeflate.DeflateOpts(1))
    cfg = m.configure_decompression(ref["ref_frame"])
    assert bytes(m.decompress(ref["ref_frame"], cfg).numpy()) == MANAGER_DATA
    assert cfg.get_status() == Status.SUCCESS
