"""The port's Zstandard encode path against the JAX reference, on the CPU.

The plain versions of the two walks (``hist`` and ``full``) behind
``compress_batch_plain`` are held against ``tpucomp``'s Pallas encoder run in
interpret mode (``tpucomp.ops.pallas.zstd_encode.compress_batch``) on the
same numpy batch, in exact entropy and in the speed rung: frames, sizes and
statuses.  The batch's capacity, 12288 bytes, is three of the reference's
4096-byte slabs, and its mixed-corpus row has kept matches across bytes 4096
and 8192: the port walks a chunk in one pass, so this holds that the slabs
change nothing.  The table builders (``huf_tree``, ``seq_tables``,
``normalize_counts``, ``fse_enc``, ``serialize_ncount``) are held word for
word against the reference's, the Manager frame against ``tpucomp.manager``'s.
The port's 64 KiB frames are read by python-zstandard, libzstd and the
port's decoder, with no reference call.  Tolerance: exact equality — every
output is bytes, sizes, status codes or table words.

All reference calls run once, in the module fixture (about 90 s on one
worker, nearly all of it interpret-mode and table compiles): the encoder in
both modes, the table builders in one jitted program, and the reference
Manager, whose encoder call (``PALLAS_ENCODERS["zstd"]``) is answered through
a host callback by a direct call of the reference encoder on the Manager's
own rows, of the same shape as the first call, so that it costs no second
interpret-mode compile; the callback checks that the rows are the Manager's.
Keep this file below 26 cases, so xdist queues it after
``tests/test_zstd.py`` (``ROADMAP.md``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import zstandard

import tpucomp.manager as ref_manager
from tpucomp.chunk import ChunkBatch as RefChunkBatch
from tpucomp.formats import zstd as ref_fzstd
from tpucomp.ops import pallas as ref_pallas
from tpucomp.ops.pallas import zstd_encode as ref_enc

from tpucomp_torch import batched
from tpucomp_torch.chunk import ChunkBatch
from tpucomp_torch.constants import Status
from tpucomp_torch.formats import zstd as fzstd
from tpucomp_torch.interop import cpu as interop
from tpucomp_torch.manager import ChecksumPolicy, Manager, create_manager
from tpucomp_torch.ops import match
from tpucomp_torch.ops.cuda import zstd_decode, zstd_encode
from tpucomp_torch.utils import synth

# ------------------------------------------------------------------ inputs ---

CAP = 12288                       # three 4096-byte slabs of the reference kernel
OUT_CAP = fzstd.max_compressed_chunk_size(CAP)
_RNG = np.random.default_rng(3)
_MIX = synth.mixed_corpus(200_000, seed=3)


def _stride(n: int) -> bytes:
    """A period-16 stride with noise each period (tests/test_pallas_zstd.py:201-203):
    every match offset 16, a repeat offset."""
    base = (np.arange(16, dtype=np.uint8) * 7 + 3).tobytes()
    return b"".join(base + bytes([i & 0xFF]) for i in range(n // 17 + 1))[:n]


def _seq_heavy(n: int) -> bytes:
    """4-byte matches back to back (tests/test_pallas_zstd.py:212-226)."""
    rng = np.random.default_rng(5)
    return b"".join(b"abcd" + rng.integers(0, 256, 2, dtype=np.uint8).tobytes()
                    for _ in range(n // 6 + 1))[:n]


ROWS = {
    "empty": b"", "one": b"x",
    "random700": bytes(_RNG.integers(0, 256, 700, dtype=np.uint8)),    # a raw block
    "zeros3000": b"\x00" * 3000, "ab": b"ab" * 1200, "stride": _stride(CAP),
    "mixed": _MIX[:CAP].tobytes(),                 # kept matches across 4096 and 8192
    "seq_heavy": _seq_heavy(CAP),
}
NAMES = list(ROWS)
MODES = {"exact": True, "speed": False}
# the Manager's buffer: as many chunks of CAP as the batch has rows, the last short
MANAGER_DATA = _MIX[20_000:20_000 + (len(ROWS) - 1) * CAP + 5000].tobytes()


def _batch() -> tuple[np.ndarray, np.ndarray]:
    cb = ChunkBatch.from_chunks(list(ROWS.values()), CAP, device="cpu")
    return cb.data.numpy(), cb.sizes.numpy()


def _port_encode(data, sizes, out_cap, exact):
    return [x.numpy() for x in zstd_encode.compress_batch_plain(
        torch.from_numpy(data), torch.from_numpy(sizes), out_cap, exact_entropy=exact)]


def _fse_steps(h):
    """The reference's three FSE builders on one 53-symbol histogram at acc 9."""
    norm, nsym, ok = ref_fzstd._normalize_counts(h, 512)
    return ((norm, nsym, ok), ref_fzstd._fse_enc_traced(norm, nsym, 9),
            ref_fzstd._serialize_ncount(norm, nsym, 9))


def _ref_tables(freq, sch, h):
    """The reference's table builders, vmapped, as one program compiled with
    XLA's backend optimisations off: integer results are the same, the
    compile about a third shorter."""
    def run(f, c, g):
        return (jax.vmap(ref_fzstd._huf_tree)(f), jax.vmap(ref_enc._seq_tables)(c),
                jax.vmap(_fse_steps)(g))
    args = [jnp.asarray(x) for x in (freq, sch, h)]
    compiled = jax.jit(run).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0,
                          "xla_llvm_disable_expensive_passes": True})
    return jax.tree_util.tree_map(np.asarray, compiled(*args))


def _table_inputs(data, sizes):
    """Histograms for the table builders: the port's own hist walk over the
    batch and hand-made ones (two symbols, one symbol, ties, symbols above
    128, which force FSE-compressed Huffman weights, and nothing at all)."""
    d, s = torch.from_numpy(data), torch.from_numpy(sizes)
    freq, sch = zstd_encode.hist_plain(
        d, s, match.candidates2(d, s, window=zstd_encode.MAX_CAP))
    g = np.random.default_rng(1)
    extra = np.zeros((6, 256), np.int32)
    extra[0, [3, 200]] = [10, 5]
    extra[1, 7] = 100
    extra[2, :] = 7
    extra[3, :130] = g.integers(1, 1000, 130)
    extra[4, :60] = g.integers(0, 3, 60)
    freq = np.concatenate([freq.numpy(), zstd_encode.whole_chunk_hist(d, s).numpy(), extra])
    hs = np.zeros((5, 121), np.int32)
    hs[0, [0, 36, 92]] = 20                                         # one symbol each
    hs[1, [1, 2, 40, 41, 90, 91]] = 9                               # two symbols each
    hs[2, :36], hs[2, 36:89], hs[2, 89:100] = 5, 5, 5               # ties
    hs[3, [0, 5, 36, 37, 89, 95, 100]] = [300, 1, 2, 299, 100, 100, 101]
    hs[4] = g.integers(0, 40, 121)
    sch = np.concatenate([sch.numpy(), hs])
    h53 = np.zeros((6, 53), np.int32)
    h53[0] = g.integers(0, 50, 53)
    h53[1, 10] = 9
    h53[2, [0, 52]] = [1, 4000]
    h53[3] = 3
    h53[4, :20] = g.integers(1, 3, 20)
    return freq.astype(np.int32), sch.astype(np.int32), h53


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
    data, sizes = _batch()
    res = {"in": (data, sizes)}
    for mode, exact in MODES.items():
        res[mode] = [np.asarray(x) for x in ref_enc.compress_batch(
            data, sizes, OUT_CAP, interpret=True, exact_entropy=exact)]

    mcb = RefChunkBatch.from_bytes(MANAGER_DATA, CAP)
    mrows, msizes = np.asarray(mcb.data), np.asarray(mcb.sizes)
    assert mrows.shape == data.shape                 # the compile of the first call
    menc = tuple(np.asarray(x) for x in ref_enc.compress_batch(    # the same static arguments
        mrows, msizes, OUT_CAP, interpret=True, exact_entropy=True))

    def encoder(d, s, opts, out_cap):
        def host(d2, s2):
            assert out_cap == OUT_CAP
            assert np.array_equal(d2, mrows) and np.array_equal(s2, msizes)
            return menc
        shapes = tuple(jax.ShapeDtypeStruct(x.shape, x.dtype) for x in menc)
        return jax.pure_callback(host, shapes, d, s)

    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(ref_pallas.PALLAS_ENCODERS, "zstd", encoder)
        mp.setenv("TPUCOMP_DECODE_BACKEND", "pallas")
        mp.setenv("TPUCOMP_ENCODE_BACKEND", "pallas")
        res["manager"] = np.asarray(ref_manager.Manager("zstd", CAP).compress(
            MANAGER_DATA)).tobytes()

    res["tables_in"] = _table_inputs(data, sizes)
    res["tables"] = _ref_tables(*res["tables_in"])
    return res


def _differing(got, want, names):
    return [names[i] for i in np.nonzero((np.asarray(got) != np.asarray(want)).reshape(
        len(names), -1).any(axis=1))[0]]


# ----------------------------------------------------------------- encode ---

@pytest.mark.parametrize("mode", list(MODES))
def test_encoder_equals_reference(ref, mode):
    got = _port_encode(*ref["in"], OUT_CAP, MODES[mode])
    for k in range(3):
        bad = _differing(got[k], ref[mode][k], NAMES)
        assert not bad, f"output {k} differs on {bad}"
    assert (ref[mode][2] == Status.SUCCESS).all()


def test_batch_reaches_every_path(ref):
    """The batch drives what the frames can hold: raw blocks, raw and
    Huffman literals, FSE-compressed Huffman weights, custom FSE tables,
    and (in the one-pass walk) kept matches across both slab boundaries."""
    data, sizes = ref["in"]
    d, s = torch.from_numpy(data), torch.from_numpy(sizes)
    walks = zstd_encode._walks(d, s, match.candidates2(d, s, window=zstd_encode.MAX_CAP))
    crossed, pos = set(), 0
    for ll, ml, _ in walks[NAMES.index("mixed")][2]:
        crossed |= {b for b in (4096, 8192) if pos + ll < b < pos + ll + ml}
        pos += ll + ml
    assert crossed == {4096, 8192}
    out, osz, _ = ref["exact"]
    blocks, lits, fse_weights = set(), set(), set()
    for i in range(len(NAMES)):
        f = out[i, :osz[i]]
        blocks.add((int(f[10]) >> 1) & 3)             # block type: 0 raw, 2 compressed
        if (int(f[10]) >> 1) & 3 == 2:
            lits.add(int(f[13]) & 3)                  # literals: 0 raw, 2 Huffman
            if int(f[13]) & 3 == 2:
                fse_weights.add(int(f[18]) < 128)    # tree header below 128
    sch = torch.from_numpy(ref["tables_in"][1][:len(NAMES)])
    scm = zstd_encode.seq_tables(sch)[0][:, zstd_encode.O2_META + 3].tolist()
    assert blocks == {0, 2} and lits == {0, 2} and True in fse_weights and 0xA8 in scm


@pytest.mark.parametrize("mode", list(MODES))
def test_small_out_cap(ref, mode):
    """A frame longer than ``out_cap`` gives OUTPUT_BUFFER_TOO_SMALL, size 0
    and a zero row; the others are the reference's frames."""
    out, osz, _ = ref[mode]
    cap = int(np.median(osz))
    got_out, got_osz, got_st = _port_encode(*ref["in"], cap, MODES[mode])
    big = osz > cap
    assert big.any() and (~big).any()
    assert (got_st == np.where(big, Status.ERROR_OUTPUT_BUFFER_TOO_SMALL, Status.SUCCESS)).all()
    assert (got_osz == np.where(big, 0, osz)).all()
    assert not got_out[big].any()
    np.testing.assert_array_equal(got_out[~big], out[~big, :cap])


# ----------------------------------------------------------------- tables ---

def test_huf_tree_equals_reference(ref):
    freq = torch.from_numpy(ref["tables_in"][0])
    got = fzstd.huf_tree(freq)
    for k, (g, w) in enumerate(zip(got, ref["tables"][0])):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"output {k}")
    assert not got[4][-5] and got[4][-6]           # one symbol: no table; two: a table
    assert (got[2][:, 0] < 128).any()              # FSE-compressed weights


def test_seq_tables_equal_reference(ref):
    got = zstd_encode.seq_tables(torch.from_numpy(ref["tables_in"][1]))
    for k, (g, w) in enumerate(zip(got, ref["tables"][1])):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"output {k}")
    scm = got[0][:, zstd_encode.O2_META + 3]
    assert (scm == 0).any() and (scm == 0xA8).any()


@pytest.mark.parametrize("step", ["normalize_counts", "fse_enc", "serialize_ncount"])
def test_fse_builders_equal_reference(ref, step):
    h = torch.from_numpy(ref["tables_in"][2])
    norm, nsym, ok = fzstd.normalize_counts(h, 512)
    got = {"normalize_counts": (norm, nsym, ok), "fse_enc": fzstd.fse_enc(norm, nsym, 9),
           "serialize_ncount": fzstd.serialize_ncount(norm, nsym, 9)}[step]
    want = ref["tables"][2][["normalize_counts", "fse_enc", "serialize_ncount"].index(step)]
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"output {k}")


def test_constants_equal_reference():
    for name in ("LL_DEFAULT_TABLE", "ML_DEFAULT_TABLE", "OF_DEFAULT_TABLE"):
        np.testing.assert_array_equal(getattr(fzstd, name), getattr(ref_fzstd, name))
    for name in ("LL_ENC", "ML_ENC", "OF_ENC"):
        for g, w in zip(getattr(fzstd, name), getattr(ref_fzstd, name)):
            np.testing.assert_array_equal(g, w)
    for name in ("MAX_ACC_LOG", "FSE_CAP", "HUF_MAX_BITS", "TREE_CAP"):
        assert getattr(fzstd, name) == getattr(ref_fzstd, name)
    np.testing.assert_array_equal(zstd_encode.CONST, ref_enc._CONST)
    np.testing.assert_array_equal(zstd_encode.PREDEF_FSE_TAB, ref_enc._PREDEF_FSE_TAB)
    for name in ("MIN_MATCH", "MAX_CAP", "O_LLC", "O_MLC", "O_LLX", "O_MLX", "O_LLE", "O_MLE",
                 "O_OFE", "O_LLF", "O_MLF", "O_OFF", "O2_LL", "O2_ML", "O2_OF", "O2_LLF",
                 "O2_MLF", "O2_OFF", "O2_META", "FSE_TT", "NC_CAP"):
        assert getattr(zstd_encode, name) == getattr(ref_enc, name), name


# ---------------------------------------------------------------- manager ---

def test_manager_frame_equals_reference(ref):
    frame = Manager("zstd", CAP, device="cpu").compress(MANAGER_DATA)
    assert frame.numpy().tobytes() == ref["manager"]
    mgr = create_manager(ref["manager"], device="cpu")
    cfg = mgr.configure_decompression(ref["manager"])
    assert mgr.decompress(ref["manager"], cfg).numpy().tobytes() == MANAGER_DATA
    assert cfg.get_status() == Status.SUCCESS


def _last_byte_of_middle_chunk(frame: torch.Tensor) -> int:
    """Where a Manager frame keeps the last byte of its middle chunk: after
    the 56-byte header, the size table, the CRC tables if any, and the
    chunks before it, each padded to 4 bytes."""
    head = frame[:56].numpy()
    n = int(head[24:28].view(np.uint32)[0])
    csz = frame[56:56 + 4 * n].numpy().view(np.uint32).astype(np.int64)
    start = 56 + 4 * n + (8 * n if head[28] else 0) + int(((csz + 3) // 4 * 4)[:n // 2].sum())
    return start + int(csz[n // 2]) - 1


@pytest.mark.parametrize("policy", list(ChecksumPolicy))
def test_manager_checksum_modes(policy):
    """Each policy writes CRC tables or not; a manager that verifies reads
    the frame back, flags a flipped payload byte as ERROR_BAD_CHECKSUM, and
    a frame without tables as ERROR_CANNOT_VERIFY_CHECKSUMS."""
    data = _MIX[150_000:170_000].tobytes()
    frame = Manager("zstd", 8192, checksum_policy=policy, device="cpu").compress(data)
    assert int(frame[28]) == int(policy.computes)
    mgr = create_manager(frame, device="cpu")
    cfg = mgr.configure_decompression(frame)
    assert mgr.decompress(frame, cfg).numpy().tobytes() == data
    assert cfg.get_status() == Status.SUCCESS
    bad = frame.clone()
    bad[_last_byte_of_middle_chunk(frame)] ^= 0xFF
    reader = Manager("zstd", 8192, checksum_policy=ChecksumPolicy.COMPUTE_AND_VERIFY,
                     device="cpu")
    bcfg = reader.configure_decompression(bad)
    reader.decompress(bad, bcfg)
    assert bcfg.get_status() == (Status.ERROR_BAD_CHECKSUM if policy.computes
                                 else Status.ERROR_CANNOT_VERIFY_CHECKSUMS)


# ------------------------------------------------------- 64 KiB, no reference ---

@pytest.mark.parametrize("mode", list(MODES))
def test_64k_frames_read_by_zstandard_libzstd_and_the_port(mode):
    raws = [_MIX[:65536].tobytes(), _seq_heavy(65536),
            bytes(np.random.default_rng(8).integers(0, 256, 65536, dtype=np.uint8))]
    cb = ChunkBatch.from_chunks(raws, 65536, device="cpu")
    out, osz, st = zstd_encode.compress_batch_plain(cb.data, cb.sizes,
                                                    fzstd.max_compressed_chunk_size(65536),
                                                    exact_entropy=MODES[mode])
    assert (st == Status.SUCCESS).all()
    frames = [out[i, :osz[i]].numpy().tobytes() for i in range(len(raws))]
    assert osz[2] == 13 + 65536 and osz[0] < 40000 and osz[1] < 65536   # raw, compressed
    for f, r in zip(frames, raws):
        assert zstandard.ZstdDecompressor().decompress(f) == r
        if interop.available()["zstd"]:
            assert interop.zstd_decompress(f, len(r)) == r
    comp = ChunkBatch.from_chunks(frames, device="cpu")
    dec, dsz, dst = zstd_decode.decompress_batch_plain(comp.data, comp.sizes, 65536)
    assert (dst == Status.SUCCESS).all()
    assert [dec[i, :dsz[i]].numpy().tobytes() for i in range(len(raws))] == raws


# -------------------------------------------------------------------- api ---

def test_batched_api_round_trip():
    cb = ChunkBatch.from_bytes(_MIX[170_000:190_000].tobytes(), 4096, device="cpu")
    comp, st = batched.compress("zstd", cb)
    want = zstd_encode.compress_batch_plain(cb.data, cb.sizes,
                                            fzstd.max_compressed_chunk_size(4096))
    assert torch.equal(comp.data, want[0]) and torch.equal(comp.sizes, want[1])
    assert (st == Status.SUCCESS).all()
    assert torch.equal(batched.get_decompress_size("zstd", comp), cb.sizes)
    dec, dst = batched.decompress("zstd", comp, 4096)
    assert (dst == Status.SUCCESS).all() and dec.to_bytes() == cb.to_bytes()
    assert batched.roundtrip_verify("zstd", cb)


def test_chunks_above_64k_raise_a6():
    """Chunks above 64 KiB take the multi-block encoder, as the reference's
    dispatch (``ops/pallas/__init__.py:253-267``), for every backend that
    runs here: the batched call and a Manager's compress give frames that
    zstd reads (ROADMAP A.6's first item, done); the kernel backend refuses
    CPU tensors at this width too, and the kernel encoder itself refuses
    the width."""
    big = ChunkBatch.from_bytes(_MIX[:20_000].tobytes(), 65544, device="cpu")
    want = fzstd.compress_batch(big.data, big.sizes, fzstd.DEFAULT_OPTS,
                                fzstd.max_compressed_chunk_size(65544))
    for backend in ("auto", "plain"):
        comp, st = batched.compress("zstd", big, backend=backend)
        assert torch.equal(comp.data, want[0]) and (st == Status.SUCCESS).all()
    with pytest.raises(ValueError, match="CUDA"):
        batched.compress("zstd", big, backend="kernel")
    assert b"".join(zstandard.ZstdDecompressor().decompress(f)
                    for f in comp.chunk_list()) == _MIX[:20_000].tobytes()
    with pytest.raises(ValueError, match="cap <= 65536"):
        zstd_encode.compress_batch_plain(big.data, big.sizes, 70000)
    data = _MIX[:30_000].tobytes()
    mgr = Manager("zstd", 131072, device="cpu")
    frame = mgr.compress(data)
    assert bytes(mgr.decompress(frame).numpy()) == data
    frame = Manager("zstd", 65536, device="cpu").compress(data)
    assert mgr.decompress(frame).numpy().tobytes() == data


def test_kernel_entries_need_cuda():
    cb = ChunkBatch.from_chunks([b"abcdabcdabcd"], 16, device="cpu")
    cands = match.candidates2(cb.data, cb.sizes, window=zstd_encode.MAX_CAP)
    with pytest.raises(ValueError, match="CUDA"):
        zstd_encode.hist_kernel(cb.data, cb.sizes, cands)
    meta, tree = zstd_encode.huf_meta(zstd_encode.whole_chunk_hist(cb.data, cb.sizes))
    with pytest.raises(ValueError, match="CUDA"):
        zstd_encode.full_kernel(cb.data, cb.sizes, cands, meta, tree,
                                *zstd_encode.speed_tables(1, "cpu"), 64)
    with pytest.raises(ValueError, match="CUDA"):
        zstd_encode.compress_batch(cb.data, cb.sizes, 64)
    with pytest.raises(ValueError, match="CUDA"):
        batched.compress("zstd", cb, backend="kernel")
