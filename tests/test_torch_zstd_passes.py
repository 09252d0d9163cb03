"""The block-parallel passes of the Zstandard decoder against the frame walk,
on the CPU.

``tpucomp_torch.ops.cuda.zstd_passes`` decodes a frame as passes (the block
chain, entropy decode a block at a time, the frame scan, offset resolution,
the walk for frames that cannot fit, zeroing, execution), each a Hopper
kernel with a plain version.  Here the plain passes, run together, must equal
the walk (``zstd_decode.decompress_batch_big_plain`` and
``decompress_batch_plain``) byte for byte, in sizes and in statuses, on
frames whose blocks depend on each other: flush-block frames of
python-zstandard at levels 1/3/19 (repeat tables, treeless literals,
repeat offsets at block heads), hand-made frames (an RLE table repeated by
later blocks, a repeat offset at a block head, a treeless block with no
tree), bit flips and cuts in later blocks, frames too big for ``out_cap``
with an error in a later block, and the port's own multi-block encoder's
frames.  The walk itself is held against the JAX reference in
``tests/test_torch_zstd.py``; this file makes no reference call.  Pass-level
checks hold the chain's records and the scan's and resolve's repeat offsets
against the walk's own trace.  Tolerance: exact equality (bytes, sizes,
statuses, integers).  The kernels run on the card only
(``tests/test_torch_cuda.py``); here they must refuse CPU tensors.
"""
import numpy as np
import pytest
import torch
import zstandard

from tpucomp_torch.chunk import ChunkBatch
from tpucomp_torch.constants import Status
from tpucomp_torch.formats import zstd as fzstd
from tpucomp_torch.ops.cuda import zstd_decode
from tpucomp_torch.ops.cuda import zstd_passes as zp
from tpucomp_torch.utils import synth

_MIX = synth.mixed_corpus(40000, seed=11).tobytes()
_TEXT = synth.text_like(30000, seed=4).tobytes()


def _multiblock(raw: bytes, level: int, pieces: int) -> bytes:
    """One frame of several blocks (flushed between pieces)."""
    c = zstandard.ZstdCompressor(level=level).compressobj()
    step = -(-len(raw) // pieces)
    out = b"".join(c.compress(raw[i:i + step]) + c.flush(zstandard.COMPRESSOBJ_FLUSH_BLOCK)
                   for i in range(0, len(raw), step))
    return out + c.flush()


def _frame(blocks: bytes, content: int) -> bytes:
    """Magic, a single-segment header with a 1-byte content size, then blocks."""
    return fzstd.MAGIC.to_bytes(4, "little") + bytes([0x20, content & 0xFF]) + blocks


def _block(btype: int, body: bytes, last: bool, size: int | None = None) -> bytes:
    size = len(body) if size is None else size
    return (int(last) | (btype << 1) | (size << 3)).to_bytes(3, "little") + body


def _seq_block(lits: bytes, scm: int, tables: bytes, stream: bytes, last: bool) -> bytes:
    """A compressed block: raw literals (< 32), one sequence, its tables and
    its backward bitstream."""
    return _block(2, bytes([len(lits) << 3]) + lits + bytes([1, scm]) + tables + stream, last)


# LL code 4 (ll 4), ML code 0 (ml 3), every table RLE; the offset code 2
# reads 2 bits: 3 gives offset 4.  Then LL and ML repeat that RLE table
# while OF is RLE code 0 (offset value 1, ll != 0: repeat offset r0 = 4),
# then all three repeat.
HAND_RLE = _frame(
    _seq_block(b"abcd", 0x54, bytes([4, 2, 0]), b"\x07", False)
    + _seq_block(b"wxyz", 0xDC, bytes([0]), b"\x01", False)
    + _block(0, b"RAW", False) + _block(1, b"q", False, size=0)
    + _seq_block(b"1234", 0xFC, b"", b"\x01", True), 24)
HAND_RLE_RAW = b"abcdabc" + b"wxyzwxy" + b"RAW" + b"1234123"
# a treeless literals section (type 3) in the first compressed block
HAND_TREELESS = _frame(_block(2, bytes([3 | (4 << 4), 1 << 6, 0, 0x81, 0]), True), 4)


def _blocks_of(frame: bytes) -> list[tuple[int, int, int]]:
    """(content position, type, size) of each block, from the headers."""
    pos, out = zstd_decode.Row(frame).frame_start(len(frame)), []
    while pos + 3 <= len(frame):
        bh = int.from_bytes(frame[pos:pos + 3], "little")
        pos += 3
        out.append((pos, (bh >> 1) & 3, bh >> 3))
        pos += 1 if (bh >> 1) & 3 == 1 else bh >> 3
        if bh & 1:
            break
    return out


def _later_block_damage(frame: bytes, seed: int) -> list[bytes]:
    """Bit flips in the blocks after the first, cuts inside them, and a later
    block's stream left without its padding marker."""
    rng = np.random.default_rng(seed)
    blocks = _blocks_of(frame)
    start = blocks[1][0]
    out = []
    for _ in range(8):
        b = bytearray(frame)
        b[rng.integers(start, len(frame))] ^= 1 << rng.integers(0, 8)
        out.append(bytes(b))
    out += [frame[:start + 5], frame[:(start + len(frame)) // 2], frame[:-1]]
    R = zstd_decode.Row(frame)
    pos, _, size = next(b for b in reversed(blocks)   # the last block with sequences
                        if b[1] == 2 and R.nseq(R.literals(b[0], b[0] + b[2])[4])[0])
    b = bytearray(frame)
    b[pos + size - 1] = 0
    out.append(bytes(b))
    return out


def _own_frames() -> list[bytes]:
    """The port's multi-block encoder: two 128 KiB blocks, one and a bit,
    one."""
    n = 1 << 18
    raw = synth.mixed_corpus(n + 64, seed=5).tobytes()[:n]
    data = torch.from_numpy(np.frombuffer(raw * 2, np.uint8).copy()).reshape(2, n)
    data = torch.cat([data, data[:1]])
    comp, sizes, st = fzstd.compress_batch(data, torch.tensor([n, (n >> 1) + 500, n >> 1],
                                                              dtype=torch.int32))
    assert st.tolist() == [0, 0, 0]
    return [bytes(comp[i, :sizes[i]].numpy()) for i in range(3)]


def _groups() -> dict:
    g = {"libzstd": [_multiblock(_MIX, lv, p) for lv in (1, 3, 19) for p in (8, 16)]
         + [_multiblock(_TEXT, 19, 12), zstandard.ZstdCompressor(level=3).compress(_MIX)]}
    g["hand"] = [HAND_RLE, HAND_TREELESS, _frame(_block(0, b"", False) * 50
                                                 + _block(0, b"xyz", True), 3)]
    g["damaged"] = (_later_block_damage(g["libzstd"][1], 1)
                    + _later_block_damage(g["libzstd"][5], 2))
    g["own"] = _own_frames()
    return g


GROUPS = _groups()
# out_cap, the 16 MiB wrapper's lit_cap or the chunk-resident one's
CAPS = {"fits": (1 << 18, True), "fits_small_wrapper": (1 << 18, False),
        "too_small": (25000, True), "far_too_small": (2000, True)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Keep this file's torch ops to one thread beside the suite's long files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(frames: list[bytes]) -> ChunkBatch:
    return ChunkBatch.from_chunks(frames, device="cpu")


def _lit_cap(cap: int, big: bool) -> int:
    return zstd_decode.lit_cap_of(cap, big)


@pytest.mark.parametrize("cap", list(CAPS))
@pytest.mark.parametrize("group", list(GROUPS))
def test_passes_equal_the_walk(group, cap):
    """The plain passes run together give the walk's bytes, sizes and
    statuses, through both wrappers' lit_caps and too small out_caps."""
    out_cap, big = CAPS[cap]
    cb = _batch(GROUPS[group])
    lit_cap = _lit_cap(out_cap, big)
    keep = {}
    got = zp.run(cb.data, cb.sizes, out_cap, lit_cap, plain=True, keep=keep)
    want = zstd_decode._plain(cb.data, cb.sizes, out_cap, lit_cap)
    for k in range(3):
        bad = np.nonzero((got[k] != want[k]).reshape(cb.num_chunks, -1).any(1).numpy())[0]
        assert not bad.size, f"output {k} differs on frames {bad.tolist()}"
    if group in ("libzstd", "own") and cap == "fits":
        assert (want[2] == Status.SUCCESS).all()
    if cap == "far_too_small" and group != "hand":  # the walk settled frames past out_cap
        assert keep["totals"][3] > 0


def test_hand_made_frame_repeats_an_rle_table_and_an_offset():
    """Block 1 sets RLE tables; block 2 repeats its LL and ML tables and
    reads repeat offset r0 = 4 at its head; a raw block and an empty RLE
    block (no record) pass on, and block 5 repeats all three tables."""
    cb = _batch([HAND_RLE])
    out, size, st = zp.run(cb.data, cb.sizes, 64, _lit_cap(64, True), plain=True)
    assert st.tolist() == [0] and bytes(out[0, :size[0]].numpy()) == HAND_RLE_RAW
    assert zstd_decode.decompress_batch_big_plain(cb.data, cb.sizes, 64)[2].tolist() == [0]
    fcount, bases, totals = zp.chain_plain(cb.data, cb.sizes, 64, _lit_cap(64, True))
    blk = zp.fill_plain(cb.data, cb.sizes, 64, _lit_cap(64, True), fcount, bases, totals[0])
    assert totals == [4, 3, 12, 0, 4]
    assert blk[:, zp.F_POS].tolist() == [p for p, _, n in _blocks_of(HAND_RLE)[:3] + [
        _blocks_of(HAND_RLE)[4]]]
    srcs = blk[:, zp.F_SRC_LL:zp.F_SRC_ML + 1].tolist()
    assert srcs[0] == [0, 0, 0] and srcs[1] == [0, 1, 0] and srcs[3] == [0, 1, 0]
    assert blk[:, zp.F_SEQ_OFF].tolist() == [0, 1, 0, 2]
    assert blk[:, zp.F_LIT_OFF].tolist() == [0, 4, 0, 8]


def test_treeless_block_without_a_tree_fails_in_the_chain():
    cb = _batch([HAND_TREELESS])
    fcount = zp.chain_plain(cb.data, cb.sizes, 64, _lit_cap(64, True))[0]
    assert fcount.tolist() == [[0, 0, 0, Status.ERROR_CANNOT_DECOMPRESS]]
    for fn in (zstd_decode.decompress_batch_big_plain, zstd_decode.decompress_batch_plain):
        assert fn(cb.data, cb.sizes, 64)[2].tolist() == [Status.ERROR_CANNOT_DECOMPRESS]


def test_too_big_with_a_later_error_is_12():
    """An error in the last block beats ERROR_OUTPUT_BUFFER_TOO_SMALL, both
    where the scan decides (the smallest output fits) and where the walk
    settles the frame (it does not)."""
    good = GROUPS["libzstd"][1]
    bad = _later_block_damage(good, 1)[-1]           # the last stream's marker zeroed
    cb = _batch([good, bad])
    for cap, settled in ((30000, False), (500, True)):
        keep = {}
        _, size, st = zp.run(cb.data, cb.sizes, cap, _lit_cap(cap, True), plain=True, keep=keep)
        assert st.tolist() == [Status.ERROR_OUTPUT_BUFFER_TOO_SMALL,
                               Status.ERROR_CANNOT_DECOMPRESS] and size.tolist() == [0, 0]
        assert (keep["totals"][3] == 2) == settled
        assert zstd_decode.decompress_batch_big_plain(cb.data, cb.sizes, cap)[2].tolist() == \
            st.tolist()


@pytest.mark.parametrize("group", ["libzstd", "own", "hand"])
def test_offsets_and_block_starts_compose_as_the_walk(group):
    """The scan's block starts and incoming repeat offsets (composed from
    each block's symbolic ones) and resolve's concrete offsets equal the
    walk's, block by block and sequence by sequence."""
    frames = [f for f in GROUPS[group] if f is not HAND_TREELESS]
    cb = _batch(frames)
    out_cap = 1 << 18
    keep = {}
    zp.run(cb.data, cb.sizes, out_cap, _lit_cap(out_cap, True), plain=True, keep=keep)
    blk, bases, fcount = keep["blk"], keep["bases"], keep["fcount"]
    offs = keep["offs"].tolist()
    for f in range(cb.num_chunks):
        trace = {"blocks": [], "offs": []}
        zstd_decode._decode_chunk(cb.data[f].numpy().tobytes(), int(cb.sizes[f]), out_cap,
                                  _lit_cap(out_cap, True), trace)
        b0, n = int(bases[f, 0]), int(fcount[f, 0])
        assert n == len(trace["blocks"])
        assert [(int(keep["bstart"][b]), *keep["bin"][b].tolist())
                for b in range(b0, b0 + n)] == [tuple(t) for t in trace["blocks"]]
        s0 = int(bases[f, 1])
        assert offs[s0:s0 + len(trace["offs"])] == trace["offs"]
        assert int(fcount[f, 1]) == len(trace["offs"])
    assert (keep["bsym"] < 0).any() and (keep["bsym"] > 0).any()  # both kinds of codes


def test_scratch_is_sized_by_the_counts():
    """Raw and RLE blocks of size 0 get no record; a frame that cannot fit
    gets none and goes to the walk; literals and sequences are counted from
    the headers."""
    empties = _frame(_block(0, b"", False) * 4000 + _block(1, b"q", False, size=0) * 10
                     + _block(0, b"xyz", True), 3)
    frames = [empties, GROUPS["libzstd"][0], GROUPS["own"][0]]
    cb = _batch(frames)
    keep = {}
    out, size, st = zp.run(cb.data, cb.sizes, 1 << 18, _lit_cap(1 << 18, True), plain=True,
                           keep=keep)
    assert st.tolist() == [0, 0, 0] and bytes(out[0, :3].numpy()) == b"xyz"
    fc = keep["fcount"].tolist()
    assert fc[0] == [1, 0, 0, 0]
    blk = keep["blk"]
    assert list(keep["totals"][:3]) == [len(blk), int(blk[:, zp.F_NSEQ].sum()),
                                  int(blk[:, zp.F_REGEN].sum())]
    fcount = zp.chain_plain(cb.data, cb.sizes, 1000, _lit_cap(1000, True))[0]
    assert fcount[1:, 3].tolist() == [zp.OVERFLOW] * 2 and not fcount[1:, :3].any()


def test_kernels_refuse_cpu_tensors():
    cb = _batch(GROUPS["hand"][:1])
    with pytest.raises(ValueError, match="CUDA"):
        zstd_decode.decompress_batch_big(cb.data, cb.sizes, 64)
    with pytest.raises(ValueError, match="CUDA"):
        zp.chain_kernel(cb.data, cb.sizes, 64, 128)
    with pytest.raises(ValueError, match="CUDA"):
        zp.run(cb.data, cb.sizes, 64, 128)
