"""The port's Zstandard decode path against the JAX reference, on the CPU.

The plain decoder behind both wrappers (``decompress_batch``, row 18, and
``decompress_batch_big``, row 19, which differ only in the literal capacity
``lit_cap``) is held against ``tpucomp``'s Pallas kernel run in interpret
mode through the same two wrappers, on the same numpy inputs: frames from
python-zstandard at levels 1/3/19 over the reference corpus's shapes
(``tests/test_pallas_zstd.py:25-36``), multi-block frames, libzstd's frames,
hand-made and corrupt frames, an ``out_cap`` that is too small, and the
frames where the two wrappers part (statuses 12 and 15).  The size read and
the bound are held against ``tpucomp.formats.zstd``.  Tolerance: exact
equality — every output is bytes, sizes or status codes.

All reference calls run once, in the module fixture (each costs about 10 s
of interpret-mode compile): both wrappers over one batch at ``out_cap``
16384, and the chunk-resident wrapper at a tight ``out_cap`` of 1024.  Keep
this file below 26 cases, so xdist queues it after ``tests/test_zstd.py``
(``ROADMAP.md``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import zstandard

from tpucomp.formats import zstd as ref_fzstd
from tpucomp.ops.pallas import zstd_decode as ref_dec

from tpucomp_torch import batched
from tpucomp_torch.chunk import ChunkBatch
from tpucomp_torch.constants import Status
from tpucomp_torch.formats import zstd as fzstd
from tpucomp_torch.interop import cpu as interop
from tpucomp_torch.ops.cuda import zstd_decode
from tpucomp_torch.utils import synth

# ------------------------------------------------------------------ inputs ---

_RNG = np.random.default_rng(7)
RAWS = {  # the shapes of tests/test_pallas_zstd.py:25-36
    "text": b"hello zstd, hello zstd, hello zstd! " * 30,
    "fse4": bytes(_RNG.integers(0, 4, 3000, dtype=np.uint8)),
    "raw700": bytes(_RNG.integers(0, 256, 700, dtype=np.uint8)),
    "zeros": b"\x00" * 3000,
    "ab": b"ab" * 1200,
    "mixed": synth.mixed_corpus(8000, seed=3).tobytes(),
    "x": b"x",
    "empty": b"",
}
_MIX = synth.mixed_corpus(12000, seed=11).tobytes()
_TEXT = synth.text_like(6000, seed=2).tobytes()
# the frame of the lit_cap split: a level-3 frame of 3000 bytes drawn from 16
# symbols, one compressed block with Huffman literals; and a larger one
_LIT16 = {n: bytes(np.random.default_rng(1).integers(0, 16, n, dtype=np.uint8))
          for n in (3000, 20000)}


def _multiblock(raw: bytes, level: int, pieces: int) -> bytes:
    """One frame of several blocks (flushed between pieces), so later blocks
    can repeat the tables and the Huffman tree of earlier ones."""
    c = zstandard.ZstdCompressor(level=level).compressobj()
    step = -(-len(raw) // pieces)
    out = b"".join(c.compress(raw[i:i + step]) + c.flush(zstandard.COMPRESSOBJ_FLUSH_BLOCK)
                   for i in range(0, len(raw), step))
    return out + c.flush()


def _frame(blocks: bytes, content: int) -> bytes:
    """Magic, a single-segment header with a 1-byte content size, then blocks."""
    return (fzstd.MAGIC.to_bytes(4, "little") + bytes([0x20, content & 0xFF]) + blocks)


def _block(btype: int, size: int, last: bool, body: bytes) -> bytes:
    return (int(last) | (btype << 1) | (size << 3)).to_bytes(3, "little") + body


def _frames() -> tuple[dict, dict]:
    """-> (frames by name, the raw bytes each valid frame decodes to)."""
    f, raw = {}, {}
    for lv in (1, 3, 19):
        for name, r in RAWS.items():
            f[f"zs{lv}_{name}"] = zstandard.ZstdCompressor(level=lv).compress(r)
            raw[f"zs{lv}_{name}"] = r
    for lv in (3, 19):
        f[f"multiblock{lv}"], raw[f"multiblock{lv}"] = _multiblock(_MIX, lv, 4), _MIX
    # sixteen blocks: repeat tables, treeless literals and repeat offsets at
    # block heads, which the block-parallel passes compose across blocks
    f["multiblock1_16"], raw["multiblock1_16"] = _multiblock(_MIX, 1, 16), _MIX
    for lv in (-5, 1, 3, 19):
        f[f"libzstd{lv}"], raw[f"libzstd{lv}"] = interop.zstd_compress(_TEXT, lv), _TEXT
    f["checksum"] = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(_TEXT)
    f["no_content_size"] = zstandard.ZstdCompressor(
        level=3, write_content_size=False).compress(_TEXT)
    raw["checksum"] = raw["no_content_size"] = _TEXT
    for n, r in _LIT16.items():
        f[f"lit16_{n}"] = zstandard.ZstdCompressor(level=3).compress(r)
        raw[f"lit16_{n}"] = r
    f["hand_raw"], raw["hand_raw"] = _frame(_block(0, 5, True, b"hello"), 5), b"hello"
    f["hand_raw_rle"] = _frame(_block(0, 3, False, b"abc") + _block(1, 200, True, b"z"), 203)
    raw["hand_raw_rle"] = b"abc" + b"z" * 200
    f["trailing_bytes"], raw["trailing_bytes"] = f["zs3_text"] + b"\x01\x02\x03", RAWS["text"]
    f["concatenated"], raw["concatenated"] = f["zs3_text"] + f["zs3_ab"], RAWS["text"]
    # corrupt and unsupported frames
    good = f["zs3_mixed"]
    f["bad_magic"] = b"\x00" + good[1:]
    f["skippable"] = (0x184D2A50).to_bytes(4, "little") + b"\x04\x00\x00\x00abcd"
    f["reserved_bit"] = good[:4] + bytes([good[4] | 0x08]) + good[5:]
    f["dictionary_id"] = good[:4] + bytes([good[4] | 0x01, 7]) + good[5:]
    f["block_type3"] = _frame(_block(3, 5, True, b"hello"), 5)
    f["block_too_big"] = _frame(_block(0, (1 << 17) + 1, True, b"abc"), 3)
    f["raw_past_end"] = _frame(_block(0, 50, True, b"abc"), 50)
    f["no_last_block"] = _frame(_block(0, 5, False, b"hello"), 5)
    f["random96"] = bytes(_RNG.integers(0, 256, 96, dtype=np.uint8))
    f["empty_row"] = b""
    for k in (1, 4, 5, 12, len(good) // 2, len(good) - 1):
        f[f"cut{k}"] = good[:k]
    for i in range(10):
        b = bytearray(good)
        b[_RNG.integers(6, len(good))] ^= 1 << _RNG.integers(0, 8)
        f[f"flip{i}"] = bytes(b)
    return f, raw


FRAMES, RAW = _frames()
NAMES = list(FRAMES)
OUT_CAP = 16384
TIGHT = 1024
CASES = {"small": (ref_dec.decompress_batch, zstd_decode.decompress_batch_plain, OUT_CAP),
         "big": (ref_dec.decompress_batch_big, zstd_decode.decompress_batch_big_plain, OUT_CAP),
         "small_tight": (ref_dec.decompress_batch, zstd_decode.decompress_batch_plain, TIGHT)}
CORRUPT = ["bad_magic", "skippable", "reserved_bit", "dictionary_id", "block_type3",
           "block_too_big", "raw_past_end", "no_last_block", "random96", "empty_row", "cut1",
           "cut4", "cut5", "cut12"]


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
    cb = ChunkBatch.from_chunks(list(FRAMES.values()), device="cpu")
    res = {"in": (cb.data.numpy(), cb.sizes.numpy())}
    for case, (fn, _, cap) in CASES.items():
        res[case] = [np.asarray(x) for x in fn(*res["in"], cap, interpret=True)]
    res["size"] = np.asarray(jax.vmap(ref_fzstd.get_decompress_size)(
        *[jnp.asarray(x) for x in _size_headers()]))
    return res


def _size_headers() -> tuple[np.ndarray, np.ndarray]:
    """The decode batch plus headers of every Frame_Content_Size layout:
    flags 0-3, single segment or not, dictionary IDs of 1/2/4 bytes, a
    4-byte size with the top bit set, short chunks."""
    rows = list(FRAMES.values())
    m = fzstd.MAGIC.to_bytes(4, "little")
    tail = bytes(range(200, 212))
    for fhd in (0x00, 0x20, 0x40, 0x60, 0x80, 0xA0, 0xC0, 0xE0, 0x41, 0x62, 0xA3, 0xE3):
        rows.append(m + bytes([fhd]) + tail)
    rows += [m + bytes([0xA0, 0xFF, 0xFF, 0xFF, 0xFF]) + tail, m + b"\x20", m + b"\x20\x07"]
    cb = ChunkBatch.from_chunks(rows, device="cpu")
    return cb.data.numpy(), cb.sizes.numpy()


# ----------------------------------------------------------------- decode ---

@pytest.mark.parametrize("case", list(CASES))
def test_decoder_equals_reference(ref, case):
    data, sizes = ref["in"]
    _, plain, cap = CASES[case]
    got = [x.numpy() for x in plain(torch.from_numpy(data), torch.from_numpy(sizes), cap)]
    want = ref[case]
    for k in range(3):
        bad = [NAMES[i] for i in np.nonzero((got[k] != want[k]).reshape(
            len(NAMES), -1).any(axis=1))[0]]
        assert not bad, f"output {k} differs on {bad}"


def test_decoder_reads_oracle_frames_and_rejects_corrupt_ones(ref):
    out, osz, stat = ref["small"]
    for n, r in RAW.items():
        i = NAMES.index(n)
        if n == "lit16_20000":      # more literals than this wrapper's lit_cap
            assert stat[i] == Status.ERROR_CANNOT_DECOMPRESS
            continue
        assert stat[i] == Status.SUCCESS and out[i, :osz[i]].tobytes() == r, n
    for n in CORRUPT:
        assert stat[NAMES.index(n)] == Status.ERROR_CANNOT_DECOMPRESS, n
    assert (osz[stat != Status.SUCCESS] == 0).all()
    assert not out[stat != Status.SUCCESS].any()
    tight = ref["small_tight"][2]
    assert Status.ERROR_OUTPUT_BUFFER_TOO_SMALL in tight and Status.SUCCESS in tight


def test_lit_cap_splits_the_two_wrappers(ref):
    """The same frame is ERROR_CANNOT_DECOMPRESS (12) under the
    chunk-resident wrapper, whose lit_cap is round_up(out_cap, 128), and
    ERROR_OUTPUT_BUFFER_TOO_SMALL (15) under the 16 MiB one (128 KiB)."""
    i = NAMES.index("lit16_20000")
    assert (ref["small"][2][i], ref["big"][2][i]) == (12, 15)
    i = NAMES.index("lit16_3000")                  # the 3000-byte frame at out_cap 1024
    assert ref["small_tight"][2][i] == 12
    one = ChunkBatch.from_chunks([FRAMES["lit16_3000"]], device="cpu")
    assert zstd_decode.decompress_batch_plain(one.data, one.sizes, TIGHT)[2].tolist() == [12]
    assert zstd_decode.decompress_batch_big_plain(one.data, one.sizes, TIGHT)[2].tolist() == [15]
    assert zstd_decode.lit_cap_of(TIGHT, big=False) == 1024
    assert zstd_decode.lit_cap_of(1000, big=False) == 1024
    assert zstd_decode.lit_cap_of(1 << 20, big=False) == zstd_decode.lit_cap_of(1, big=True)


def test_dispatch_gate_at_the_reference_threshold():
    """``8 * (out_cap + comp_cap) + 2 MiB > 12 MiB`` takes the 16 MiB
    wrapper (``tpucomp/ops/pallas/__init__.py:114-115``): across it, the
    plain entry of ``batched.decompress`` turns 12 into 15 on the frame
    above."""
    edge = (12 << 20) - (2 << 20)                  # 8 * (out_cap + comp_cap) at the gate
    assert not zstd_decode.uses_big(edge // 8 - TIGHT, TIGHT)
    assert zstd_decode.uses_big(edge // 8 - TIGHT + 1, TIGHT)
    frame = FRAMES["lit16_3000"]
    for comp_cap, want in ((edge // 8 - TIGHT, 12), (edge // 8 - TIGHT + 8, 15)):
        cb = ChunkBatch.from_chunks([frame], comp_cap, device="cpu")
        assert cb.max_chunk_bytes == comp_cap
        dec, st = batched.decompress("zstd", cb, TIGHT)
        assert st.tolist() == [want] and dec.sizes.tolist() == [0]


# ---------------------------------------------------------------- sizes, api ---

def test_get_decompress_size_equals_reference(ref):
    data, sizes = _size_headers()
    got = fzstd.get_decompress_size(torch.from_numpy(data), torch.from_numpy(sizes))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref["size"])
    cb = ChunkBatch(torch.from_numpy(data), torch.from_numpy(sizes))
    np.testing.assert_array_equal(batched.get_decompress_size("zstd", cb).numpy(), ref["size"])
    assert (ref["size"] < 0).any()                 # the int32 wrap and the -1 of no size


def test_batched_api_and_bounds():
    for n in (0, 1, 1000, 65536, 131072, 131073, 1 << 24):
        assert fzstd.max_compressed_chunk_size(n) == ref_fzstd.max_compressed_chunk_size(n)
    assert fzstd.max_compressed_chunk_size(65536) == 66560
    assert "zstd" in batched.formats()
    cb = ChunkBatch.from_chunks([FRAMES["zs3_mixed"], FRAMES["zs19_text"]], device="cpu")
    dec, st = batched.decompress("zstd", cb, 8192)
    assert st.tolist() == [0, 0]
    assert dec.chunk_list() == [RAWS["mixed"], RAWS["text"]]
    comp, cst = batched.compress("zstd", ChunkBatch.from_bytes(b"abcdefgh" * 4, 65544,
                                                               device="cpu"))   # above 64 KiB
    assert cst.tolist() == [0] and interop.zstd_decompress(comp.chunk_list()[0]) == b"abcdefgh" * 4
    with pytest.raises(NotImplementedError, match="formats/zstd.py"):
        batched.decompress("zstd", cb, 8192, backend="xla")
    with pytest.raises(ValueError, match="CUDA"):
        batched.decompress("zstd", cb, 8192, backend="kernel")
    for fn in (zstd_decode.decompress_batch, zstd_decode.decompress_batch_big):
        with pytest.raises(ValueError, match="CUDA"):
            fn(cb.data, cb.sizes, 8192)


def test_libzstd_oracle_round_trip():
    assert interop.available()["zstd"]
    for lv in (-5, 1, 3, 19):
        f = interop.zstd_compress(_MIX, lv)
        assert interop.zstd_decompress(f) == _MIX
        assert zstandard.ZstdDecompressor().decompress(f) == _MIX
    f = zstandard.ZstdCompressor(level=3).compress(_TEXT)
    assert interop.zstd_decompress(f, len(_TEXT)) == _TEXT
    with pytest.raises(RuntimeError, match="content size"):
        interop.zstd_decompress(FRAMES["no_content_size"])
