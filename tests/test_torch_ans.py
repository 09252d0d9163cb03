"""The port's ANS (rANS) path against the JAX reference, on the CPU.

The plain versions of the port's encoder (``tables_for``, the state walk,
``serialize_scan``) and decoder (the header checks and the 128-lane walk)
are held against ``tpucomp``'s Pallas wrappers run in interpret mode
(``ans_encode.compress_batch_wide`` / ``compress_batch``,
``ans_decode.decompress_batch_wide`` / ``decompress_batch``), the XLA
``ans.compress_batch`` and the reference's ``tables_for`` and
``get_decompress_size`` on the same numpy inputs: 64 KiB rows (the mixed and
mortgage heads of ``synth`` at seed 42), the edge rows of
``tests/test_pallas_ans.py``, a row of all 256 symbols with most of them
rare, an odd batch, a too-small ``out_cap``, corrupt frames (flipped stream
bytes, a truncated size, bad magic, version and frequencies, a size above
``out_cap``, the two header frames on which the reference's XLA decoder
differs from its Pallas wrappers), rows narrower than the header and an
``out_cap`` that is not a multiple of 128.  The port follows the Pallas
wrappers.  ``tests/golden/ans.bin`` decodes, and the port's Manager frame
equals the reference Manager's.  Tolerance: exact equality — every output
is bytes, sizes, status codes or table words.

All reference calls run once, in the module fixture (about 16-18 s on one
CPU worker).  Keep this file below 26 cases, so xdist queues it after
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
from tpucomp.formats import ans as ref_fa
from tpucomp.ops.pallas import ans_decode as ref_dec
from tpucomp.ops.pallas import ans_encode as ref_enc

from tpucomp_torch import batched
from tpucomp_torch.chunk import ChunkBatch
from tpucomp_torch.constants import Status
from tpucomp_torch.formats import ans as fa
from tpucomp_torch.manager import ChecksumPolicy, Manager, create_manager
from tpucomp_torch.manager import _opts_from_blob, _opts_to_blob
from tpucomp_torch.ops.cuda import ans_decode, ans_encode
from tpucomp_torch.utils import synth

CAP = 65536
BOUND = fa.max_compressed_chunk_size(CAP)
SMALL_OUT = 4096          # an encode out_cap most 64 KiB rows overflow
RAGGED_OUT = 1000         # a decode out_cap that is not a multiple of 128
NARROW = 1200             # a frame row narrower than the 1292-byte header
GOLDEN = Path(__file__).parent / "golden"

_RNG = np.random.default_rng(31)
_MIXED = synth.mixed_corpus(CAP, seed=42).tobytes()[:CAP]
ROWS = {  # the encoders' rows: 9, an odd batch (a ragged group of the wide kernel)
    "mixed": _MIXED,
    "mortgage": synth.mortgage_like(CAP, seed=42).tobytes()[:CAP],
    "cut": _MIXED,                              # size 1000 of a full row
    "empty": b"", "x": b"x",
    "zeros": b"\x00" * 3000,                    # f = 4096: never emits
    "bits2": bytes(_RNG.integers(0, 4, 5000, dtype=np.uint8)),
    "random": bytes(_RNG.integers(0, 256, 3000, dtype=np.uint8)),
    "rare": bytes(range(256)) + b"a" * 20000,   # 255 symbols of count 1
}
SIZES = {"cut": 1000}
# the tables' rows: an entropy ladder (k-bit symbols) beside the encoders' rows
LADDER = {f"ladder{k}": bytes(np.random.default_rng(k).integers(0, 1 << k, 4000 + 97 * k,
                                                              dtype=np.uint8))
          for k in range(1, 9)}


def _batch(rows: dict, cap: int, sizes: dict | None = None):
    cb = ChunkBatch.from_chunks(list(rows.values()), cap, device="cpu")
    for name, s in (sizes or {}).items():
        cb.sizes[list(rows).index(name)] = s
    return cb.data.numpy(), cb.sizes.numpy()


def _frames(res) -> list[bytes]:
    return [res[0][i, :res[1][i]].tobytes() for i in range(len(res[1]))]


def _patched(frame: bytes, at: int, value: bytes) -> bytes:
    b = bytearray(frame)
    b[at:at + len(value)] = value
    return bytes(b)


def _corrupt(frames: dict) -> dict:
    """name -> (frame bytes, comp_size): the corrupt frames of the decoder tests."""
    good = frames["mixed"]
    words = (len(good) - fa.HEADER_BYTES) // 2
    u32 = lambda v: int(v).to_bytes(4, "little")        # noqa: E731
    early = fa.HEADER_BYTES + 7
    c = {"flip_early": _patched(good, early, bytes([good[early] ^ 0xA1])),
         "flip_late": _patched(good, len(good) - 3, bytes([good[-3] ^ 0x10])),
         "bad_magic": _patched(good, 0, b"\x5a"),
         "bad_version": _patched(good, 1, b"\x03"),
         "bad_freq": _patched(good, 12, bytes([good[12] ^ 0x55])),
         "size_over_cap": _patched(good, 4, u32(CAP + 1)),
         # the XLA decode_chunk: 12 for the first, SUCCESS for the second
         "size0_words5": _patched(_patched(good, 4, u32(0)), 8, u32(5))[:fa.HEADER_BYTES + 10],
         "size_top_bit": _patched(good, 4, u32(0x80000010)),
         "words_top_bit": _patched(good, 8, u32(0x80000001)),
         "garbage": bytes(_RNG.integers(0, 256, 2000, dtype=np.uint8)),
         "empty_row": b""}
    out = {k: (v, len(v)) for k, v in c.items()}
    out["truncated"] = (good, len(good) - 40)
    out["short_by_one_word"] = (good, fa.HEADER_BYTES + 2 * words - 1)
    return out


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """This file runs beside the suite's longest file (xdist queues it after
    ``test_zstd.py``): keep its torch ops to one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _host_crc32(data, sizes):
    """``crc32_batch`` through ``binascii`` (a host callback inside jit; the
    reference's own costs some 15 s of compile, ``test_torch_manager.py``)."""
    def crcs(d, s):
        return np.array([binascii.crc32(d[i, :s[i]].tobytes()) for i in range(len(s))],
                        np.uint32)
    return jax.pure_callback(crcs, jax.ShapeDtypeStruct(sizes.shape, jnp.uint32),
                             data, sizes)


MGR_DATA = synth.mixed_corpus(20_000, seed=17).tobytes()
MGR_CHUNK = 4096


@pytest.fixture(scope="module")
def ref():
    """Every reference call of this file, once."""
    res = {}
    d, s = (jnp.asarray(x) for x in _batch(ROWS, CAP, SIZES))
    res["encode", "wide"] = [np.asarray(x) for x in
                             ref_enc.compress_batch_wide(d, s, BOUND, interpret=True)]
    res["encode", "single"] = [np.asarray(x) for x in
                               ref_enc.compress_batch(d, s, BOUND, interpret=True)]
    res["encode", "xla"] = [np.asarray(x) for x in
                            ref_fa.compress_batch(d, s, ref_fa.DEFAULT_OPTS, BOUND)]
    res["encode", "small"] = [np.asarray(x) for x in
                              ref_fa.compress_batch(d, s, ref_fa.DEFAULT_OPTS, SMALL_OUT)]
    td, ts = (jnp.asarray(x) for x in _batch({**ROWS, **LADDER}, CAP, SIZES))
    res["tables"] = [np.asarray(x) for x in jax.jit(jax.vmap(ref_fa.tables_for))(td, ts)]

    frames = dict(zip(ROWS, _frames(res["encode", "wide"])))
    named = {**{k: (v, len(v)) for k, v in frames.items()}, **_corrupt(frames)}
    cb = ChunkBatch.from_chunks([v for v, _ in named.values()], BOUND, device="cpu")
    cb.sizes[:] = torch.tensor([n for _, n in named.values()], dtype=torch.int32)
    res["decode_names"] = list(named)
    res["decode_in"] = (cb.data.numpy(), cb.sizes.numpy())
    c, cs = (jnp.asarray(x) for x in res["decode_in"])
    for out_cap in (CAP, RAGGED_OUT):
        res["decode", "wide", out_cap] = [np.asarray(x) for x in ref_dec.decompress_batch_wide(
            c, cs, out_cap, interpret=True)]
    res["decode", "single", CAP] = [np.asarray(x) for x in ref_dec.decompress_batch(
        c, cs, CAP, interpret=True)]
    res["sizes"] = np.asarray(jax.vmap(ref_fa.get_decompress_size)(c, cs))
    # rows narrower than the header, at the ragged out_cap (comp_sizes as given)
    n = res["decode_in"][0][:, :NARROW]
    res["narrow_in"] = (n, res["decode_in"][1])
    res["decode", "narrow"] = [np.asarray(x) for x in ref_dec.decompress_batch(
        jnp.asarray(n), cs, RAGGED_OUT, interpret=True)]
    # the XLA decoder on the two header frames it reads differently
    pick = [res["decode_names"].index(k) for k in ("size0_words5", "size_top_bit")]
    res["xla_pick"] = pick
    res["decode", "xla"] = [np.asarray(x) for x in ref_fa.decompress_batch(
        c[np.array(pick)], cs[np.array(pick)], 1024)]

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPUCOMP_DECODE_BACKEND", "pallas")
        mp.setenv("TPUCOMP_ENCODE_BACKEND", "pallas")
        mp.setattr(ref_crc32, "crc32_batch", _host_crc32)
        res["mgr_frame"] = np.asarray(ref_manager.Manager(
            "ans", MGR_CHUNK, checksum_policy=int(ChecksumPolicy.COMPUTE_AND_VERIFY))
            .compress(MGR_DATA)).tobytes()
    return res


def _port_encode(fn, out_cap=BOUND):
    d, s = (torch.from_numpy(x) for x in _batch(ROWS, CAP, SIZES))
    return [x.numpy() for x in fn(d, s, out_cap)]


@pytest.fixture(scope="module")
def port_decode(ref):
    """The port's plain decoder over the reference's decode inputs, once per
    out_cap and for the narrow rows."""
    c, cs = (torch.from_numpy(x) for x in ref["decode_in"])
    out = {cap: [x.numpy() for x in ans_decode.decompress_batch_plain(c, cs, cap)]
           for cap in (CAP, RAGGED_OUT)}
    n = torch.from_numpy(np.ascontiguousarray(ref["narrow_in"][0]))
    out["narrow"] = [x.numpy() for x in ans_decode.decompress_batch_plain(n, cs, RAGGED_OUT)]
    return out


def _differing(got, want, names):
    got, want = np.asarray(got), np.asarray(want)
    return [names[i] for i in np.nonzero((got != want).reshape(len(names), -1).any(axis=1))[0]]


# ----------------------------------------------------------------- tables ---

def test_tables_equal_reference(ref):
    """``tables_for`` (and so ``quantize_freqs``: stable remainder order,
    four correction rounds) over the edge rows and an entropy ladder."""
    names = list(ROWS) + list(LADDER)
    d, s = (torch.from_numpy(x) for x in _batch({**ROWS, **LADDER}, CAP, SIZES))
    freq, cum = fa.tables_for(d, s)
    for what, g, w in (("freq", freq, ref["tables"][0]), ("cum", cum, ref["tables"][1])):
        bad = _differing(g.numpy(), w, names)
        assert not bad, f"{what} differs on {bad}"
    assert (freq.sum(dim=1) == fa.PROB_SCALE).all()
    rare = names.index("rare")
    assert (freq[rare] == 1).sum() == 255 and int(freq[rare, ord("a")]) == 4096 - 255


# ----------------------------------------------------------------- encode ---

@pytest.mark.parametrize("path", ["wide", "single", "xla"])
def test_encoder_equals_reference(ref, path):
    """The plain encoder's frames, sizes and statuses, whole rows, against the
    reference's wide and single-chunk Pallas wrappers and its XLA program
    (which all agree)."""
    got, want = _port_encode(ans_encode.compress_batch_plain), ref["encode", path]
    for k in range(3):
        bad = _differing(got[k], want[k], list(ROWS))
        assert not bad, f"output {k} differs on {bad}"
    assert (want[2] == Status.SUCCESS).all()
    assert want[1][list(ROWS).index("zeros")] == fa.HEADER_BYTES   # f = 4096: no words


def test_encoder_output_buffer_too_small(ref):
    """A frame longer than out_cap: ERROR_OUTPUT_BUFFER_TOO_SMALL, size 0,
    and the row keeps the frame's first out_cap bytes (``ans.py:221-228``)."""
    got = _port_encode(ans_encode.compress_batch_plain, SMALL_OUT)
    want = ref["encode", "small"]
    for k in range(3):
        bad = _differing(got[k], want[k], list(ROWS))
        assert not bad, f"output {k} differs on {bad}"
    big = want[2] == Status.ERROR_OUTPUT_BUFFER_TOO_SMALL
    assert big.sum() >= 2 and (~big).sum() >= 3
    full = ref["encode", "wide"][0]
    np.testing.assert_array_equal(got[0][big], full[big][:, :SMALL_OUT])   # not zeroed
    assert (got[1][big] == 0).all()


def test_walk_outputs_describe_the_frames(ref):
    """The plain walk's final states and word counts are the frames' header
    fields, its emits count the stream, and rows past the data are zero."""
    d, s = (torch.from_numpy(x) for x in _batch(ROWS, CAP, SIZES))
    freq, cum = fa.tables_for(d, s)
    words, emits, x_fin, wcount = ans_encode.walk_plain(d, s, freq, cum)
    assert words.dtype == torch.int16 and emits.dtype == torch.uint8
    out, osz, _ = ref["encode", "wide"]
    states = out[:, 524:1036].copy().view("<u4").astype(np.int64)
    np.testing.assert_array_equal(x_fin.numpy().astype(np.int64) & 0xFFFFFFFF, states)
    np.testing.assert_array_equal(wcount.numpy(), out[:, 1036:1292].copy().view("<u2"))
    np.testing.assert_array_equal(emits.sum(dim=(1, 2)).numpy(), (osz - fa.HEADER_BYTES) // 2)
    rows_used = (s.to(torch.int64) + 127) // 128
    t = torch.arange(words.shape[1])[None, :, None]
    assert (words.masked_fill(t < rows_used[:, None, None], 0) == 0).all()
    assert ((words == 0) | (emits != 0)).all()


# ----------------------------------------------------------------- decode ---

@pytest.mark.parametrize("path,out_cap", [("wide", CAP), ("single", CAP),
                                          ("wide", RAGGED_OUT), ("narrow", RAGGED_OUT)])
def test_decoder_equals_reference(ref, port_decode, path, out_cap):
    """Rows, sizes and statuses against the Pallas wrappers, on good and
    corrupt frames; at out_cap 65536, at 1000, and on rows cut to 1200 bytes
    (below the header) at 1000."""
    names = ref["decode_names"]
    got = port_decode["narrow" if path == "narrow" else out_cap]
    want = ref["decode", path] if path == "narrow" else ref["decode", path, out_cap]
    for k in range(3):
        bad = _differing(got[k], want[k], names)
        assert not bad, f"output {k} differs on {bad}"


def test_decoder_statuses(ref, port_decode):
    """Good frames decode; header corruptions fail; the two header frames
    follow the Pallas wrappers, which the reference's XLA decoder does not."""
    out, osz, stat = port_decode[CAP]
    names = ref["decode_names"]
    st = dict(zip(names, stat))
    sizes = _batch(ROWS, CAP, SIZES)[1]
    for i, (name, raw) in enumerate(ROWS.items()):
        assert st[name] == Status.SUCCESS, name
        assert out[i, :osz[i]].tobytes() == raw[:sizes[i]], name
    for name in ("bad_magic", "bad_version", "bad_freq", "size_over_cap", "size_top_bit",
                 "truncated", "short_by_one_word", "garbage", "empty_row"):
        assert st[name] == Status.ERROR_CANNOT_DECOMPRESS, name
        assert osz[names.index(name)] == 0 and not out[names.index(name)].any(), name
    assert st["size0_words5"] == Status.SUCCESS and osz[names.index("size0_words5")] == 0
    xla_stat = ref["decode", "xla"][2]
    assert xla_stat.tolist() == [Status.ERROR_CANNOT_DECOMPRESS, Status.SUCCESS]
    small = port_decode[RAGGED_OUT][2]
    assert small[names.index("x")] == Status.SUCCESS
    assert small[names.index("mixed")] == Status.ERROR_CANNOT_DECOMPRESS


def test_golden_frames_decode():
    """``tests/golden/ans.bin`` (the reference's committed frames) decodes."""
    blob = (GOLDEN / "ans.bin").read_bytes()
    n = int(np.frombuffer(blob[:4], np.int32)[0])
    frames, off = [], 4 + 4 * n
    for s in np.frombuffer(blob[4:4 + 4 * n], np.int32):
        frames.append(blob[off:off + s])
        off += s
    raw = (GOLDEN / "input.bin").read_bytes()
    k = len(raw) // 3
    dec, stat = batched.decompress("ans", ChunkBatch.from_chunks(frames, device="cpu"), k)
    assert (stat == Status.SUCCESS).all()
    assert dec.chunk_list() == [raw[:k], raw[k:2 * k], raw[2 * k:]]


# -------------------------------------------------------------------- api ---

def test_sizes_and_bounds(ref):
    for n in (0, 1, 1000, 4096, 65536):
        assert fa.max_compressed_chunk_size(n) == ref_fa.max_compressed_chunk_size(n)
    assert BOUND == 133120 and fa.HEADER_BYTES == ref_fa.HEADER_BYTES
    data, sizes = ref["decode_in"]
    got = batched.get_decompress_size(
        "ans", ChunkBatch(torch.from_numpy(data), torch.from_numpy(sizes)))
    np.testing.assert_array_equal(got.numpy(), ref["sizes"])
    assert (ref["sizes"] < 0).any()                     # the int32 read of the u32 size
    narrow = torch.from_numpy(np.ascontiguousarray(data[:, :6]))
    want = np.asarray(jax.vmap(ref_fa.get_decompress_size)(jnp.asarray(data[:, :6]),
                                                           jnp.asarray(sizes)))
    np.testing.assert_array_equal(fa.get_decompress_size(narrow, torch.from_numpy(sizes))
                                  .numpy(), want)


def test_batched_round_trip_and_kernel_paths():
    buf = ROWS["mortgage"][:30000] + ROWS["bits2"] + ROWS["rare"]
    cb = ChunkBatch.from_bytes(buf, 16384, device="cpu")
    comp, cst = batched.compress("ans", cb)
    dec, dst = batched.decompress("ans", comp, 16384)
    assert (cst == 0).all() and (dst == 0).all() and dec.to_bytes() == buf
    assert batched.get_decompress_size("ans", comp).tolist() == cb.sizes.tolist()
    with pytest.raises(ValueError, match="CUDA"):
        batched.compress("ans", cb, backend="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        batched.decompress("ans", comp, 16384, backend="kernel")
    for fn in (ans_encode.compress_batch, ans_encode.compress_batch_wide,
               ans_decode.decompress_batch, ans_decode.decompress_batch_wide):
        with pytest.raises(ValueError, match="CUDA"):
            fn(cb.data, cb.sizes, 16384)
    z = torch.zeros((cb.num_chunks, 256), dtype=torch.int32)
    for fn in (ans_encode.walk_kernel, ans_encode.walk_kernel_wide):
        with pytest.raises(ValueError, match="CUDA"):
            fn(cb.data, cb.sizes, z, z)


def test_clamped_sizes():
    """Sizes outside [0, cap] are clamped, as the port's other encoders do
    (ROADMAP §C); the reference reads such rows past their end."""
    cb = ChunkBatch.from_chunks([ROWS["bits2"][:4096], b"abc"], 4096, device="cpu")
    want = ans_encode.compress_batch_plain(cb.data, torch.tensor([4096, 0]), 8192)
    got = ans_encode.compress_batch_plain(cb.data, torch.tensor([5000, -3]), 8192)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_manager_frame_equals_reference(ref):
    """The port's Manager frame (COMPUTE_AND_VERIFY) is byte-identical to
    the reference Manager's with its kernel backends; it reads back, and a
    flipped payload byte is a bad checksum."""
    m = Manager("ans", MGR_CHUNK, checksum_policy=ChecksumPolicy.COMPUTE_AND_VERIFY,
                device="cpu")
    frame = m.compress(MGR_DATA)
    assert frame.numpy().tobytes() == ref["mgr_frame"]
    m2 = create_manager(ref["mgr_frame"], device="cpu")
    cfg = m2.configure_decompression(frame)
    assert m2.decompress(frame, cfg).numpy().tobytes() == MGR_DATA
    assert cfg.get_status() == Status.SUCCESS
    bad = frame.clone()
    bad[56 + 12 * cfg.num_chunks + 1300] ^= 0xFF     # in the first chunk's stream
    bcfg = m2.configure_decompression(bad)
    m2.decompress(bad, bcfg)
    assert bcfg.get_status() == Status.ERROR_BAD_CHECKSUM


def test_manager_opts_blob():
    """ANSOpts is empty: 16 zero bytes, read back as the default opts."""
    assert _opts_to_blob("ans", fa.DEFAULT_OPTS) == bytes(16) == ref_manager._opts_to_blob(
        "ans", ref_fa.DEFAULT_OPTS)
    assert _opts_from_blob("ans", bytes(16)) == fa.ANSOpts()
    m = create_manager(Manager("ans", 4096, device="cpu").compress(b"abc" * 100), device="cpu")
    assert (m.format, m.opts) == ("ans", fa.DEFAULT_OPTS)
