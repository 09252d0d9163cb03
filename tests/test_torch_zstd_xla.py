"""The port's Zstandard multi-block encoder against the JAX reference, on the
CPU: its single-block branch.

``tpucomp_torch.formats.zstd.compress_batch`` (torch ops) is held against
``tpucomp.formats.zstd.compress_batch`` (the reference's XLA encoder) on the
same numpy batch of 8 KiB rows, one 128 KiB block or less, so one
compressed block a frame: frames, sizes and statuses.  The rows: the mixed
and mortgage heads; 2, 4, 16 and 256 byte values each appearing exactly
equally often, shuffled (the float32 entropy of the "economic match" test is
then a whole number in exact arithmetic, so the float32 sums land next to
the boundary); a 3000-byte block repeated (repeat offsets); zeros; size 0;
size ``cap - 1``; random bytes, where the store frame wins.
python-zstandard and libzstd read every port frame.  ``suffix_run_length``
and ``wyllie_path`` are held against the reference's on two rows of 4 KiB;
``_find_matches`` at the zstd parameters unrolls 32 x 24 probes into the
reference's graph, so the frames cover it.  On the port only: the batched
call above 64 KiB chunks and under backend ``xla`` takes this encoder, its
row slices and its trimmed width for short rows change nothing, and a
``Manager("zstd", 131072)`` round trip.
Tolerance: exact equality.

The reference encoder compiles once, in the module fixture (about 85-110 s
on one worker here); the port's loops take a few seconds.  Keep this file
below 26 cases, so xdist queues it after ``tests/test_zstd.py``
(``ROADMAP.md``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import zstandard

from tpucomp.formats import zstd as ref_fzstd
from tpucomp.ops import parallel_lz as ref_plz

from tpucomp_torch import batched
from tpucomp_torch.chunk import ChunkBatch
from tpucomp_torch.constants import Status
from tpucomp_torch.formats import zstd as fzstd
from tpucomp_torch.interop import cpu as interop
from tpucomp_torch.manager import Manager
from tpucomp_torch.ops import parallel_lz as plz
from tpucomp_torch.ops.cuda import zstd_encode
from tpucomp_torch.utils import synth

CAP = 8192
OUT_CAP = fzstd.max_compressed_chunk_size(CAP)
ROW_NAMES = ["mixed", "mortgage", "eq2", "eq4", "eq16", "eq256", "rep3000", "zeros",
             "size0", "cap_minus_1", "random"]


def rows(cap: int, block: int) -> tuple[np.ndarray, np.ndarray]:
    """The test rows at capacity ``cap`` (``ROW_NAMES``), with the
    equal-count rows equal in every ``block`` bytes (the encoder's blocks)."""
    rng = np.random.default_rng(10)
    block = min(block, cap)
    n_eq = (cap // block) * block
    out = [(synth.mixed_corpus(cap + 64, seed=3)[:cap], cap),
           (synth.mortgage_like(cap + 4096, seed=4)[:cap], cap)]
    for k in (2, 4, 16, 256):
        r = np.zeros(cap, np.uint8)
        vals = rng.choice(256, k, replace=False).astype(np.uint8)
        for b0 in range(0, n_eq, block):
            blk = np.repeat(vals, block // k)
            rng.shuffle(blk)
            r[b0:b0 + block] = blk
        out.append((r, n_eq))
    out += [(np.resize(rng.integers(0, 256, 3000, dtype=np.uint8), cap), cap),
            (np.zeros(cap, np.uint8), cap),
            (rng.integers(0, 256, cap, dtype=np.uint8), 0),
            (synth.mixed_corpus(cap + 64, seed=5)[:cap], cap - 1),
            (rng.integers(0, 256, cap, dtype=np.uint8), cap)]
    return np.stack([r for r, _ in out]), np.array([s for _, s in out], np.int32)


def readers_agree(data, sizes, out, out_sizes) -> list:
    """Rows whose frame python-zstandard or libzstd does not read back."""
    bad = []
    for i, (row, n) in enumerate(zip(data, sizes)):
        frame = out[i, :out_sizes[i]].tobytes()
        want = row[:n].tobytes()
        got = zstandard.ZstdDecompressor().decompress(frame, max_output_size=max(n, 1))
        if got != want or (interop.available()["zstd"]
                           and interop.zstd_decompress(frame, int(n)) != want):
            bad.append(i)
    return bad


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side is thousands of small torch ops: on one intra-op
    thread each, this file's torch does not starve the xdist workers beside
    it with spinning threads.  The thread count is restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    data, sizes = rows(CAP, fzstd.ZSTD_BLOCK)
    ref = ref_fzstd.compress_batch(jnp.asarray(data), jnp.asarray(sizes),
                                   ref_fzstd.DEFAULT_OPTS, OUT_CAP)
    port = fzstd.compress_batch(torch.from_numpy(data), torch.from_numpy(sizes),
                                fzstd.DEFAULT_OPTS, OUT_CAP)
    return data, sizes, [np.asarray(a) for a in ref], [a.numpy() for a in port]


@pytest.mark.parametrize("row", ROW_NAMES)
def test_frame_equals_reference(frames, row):
    _, _, ref, port = frames
    i = ROW_NAMES.index(row)
    assert port[1][i] == ref[1][i] and port[2][i] == ref[2][i]
    assert np.array_equal(port[0][i], ref[0][i]), row


def test_sizes_statuses_and_compressed_blocks(frames):
    data, sizes, ref, port = frames
    assert np.array_equal(port[1], ref[1]) and np.array_equal(port[2], ref[2])
    assert (port[2] == Status.SUCCESS).all()
    # a compressed block (type 2) where it wins; the store frame (one raw
    # block) on the random rows, the 256-value row and the empty row
    btype = (port[0][:, 10] >> 1) & 3
    stored = [ROW_NAMES.index(r) for r in ("eq256", "size0", "random")]
    assert [i for i in range(len(ROW_NAMES)) if btype[i] != 2] == stored
    assert all(port[1][i] == 10 + 3 + sizes[i] for i in stored)


def test_python_zstandard_and_libzstd_read_every_frame(frames):
    data, sizes, _, port = frames
    assert readers_agree(data, sizes, port[0], port[1]) == []


def test_row_slices_change_nothing(frames, monkeypatch):
    """Rows go through encode_chunk in slices of ROW_SLICE_BYTES: slices of
    three rows give the one-call frames."""
    data, sizes, _, port = frames
    monkeypatch.setattr(fzstd, "ROW_SLICE_BYTES", 3 * CAP)
    got = fzstd.compress_batch(torch.from_numpy(data), torch.from_numpy(sizes),
                               fzstd.DEFAULT_OPTS, OUT_CAP)
    assert all(np.array_equal(g.numpy(), w) for g, w in zip(got, port))


def test_short_rows_encode_at_a_trimmed_width(monkeypatch):
    """A batch whose sizes are all well under its width is encoded at the
    largest size plus READ_PAST: the same frames as at the full width (the
    bytes past each size are the rows' own, not zeros)."""
    data, _ = rows(CAP, fzstd.ZSTD_BLOCK)
    sizes = torch.tensor([100, 700, 3000, 0, 1, 2000, 2999, 64, 5, 1500, 900],
                         dtype=torch.int32)
    got = fzstd.compress_batch(torch.from_numpy(data), sizes, fzstd.DEFAULT_OPTS, OUT_CAP)
    monkeypatch.setattr(fzstd, "READ_PAST", CAP)
    want = fzstd.compress_batch(torch.from_numpy(data), sizes, fzstd.DEFAULT_OPTS, OUT_CAP)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (got[2] == Status.SUCCESS).all() and int(got[1][2]) < 3000


def test_suffix_run_length_equals_reference():
    rng = np.random.default_rng(11)
    pred = rng.random((2, 4096)) < np.array([[0.3], [0.9]])
    want = jax.vmap(ref_plz.suffix_run_length)(jnp.asarray(pred))
    assert np.array_equal(plz.suffix_run_length(torch.from_numpy(pred)).numpy(),
                          np.asarray(want))


def test_wyllie_path_equals_reference():
    """The chain the port walks equals the reference's ``reach`` (the port
    drops the weight sums, which no caller reads)."""
    rng = np.random.default_rng(12)
    n = 4096
    nxt = np.arange(n)[None] + rng.integers(1, 9, (2, n))
    nxt[1, 3000:] = n + 5                       # terminal positions
    reach, _ = jax.vmap(lambda a: ref_plz.wyllie_path(a, jnp.zeros_like(a), num_rounds=13))(
        jnp.asarray(nxt, jnp.int32))
    assert np.array_equal(plz.wyllie_path(torch.from_numpy(nxt), 13).numpy(), np.asarray(reach))


@pytest.mark.parametrize("backend", ["auto", "plain", "xla"])
def test_batched_compress_above_64k_takes_the_multi_block_encoder(backend):
    cap = 65536 + 4096
    raw = synth.mixed_corpus(20_000, seed=13).tobytes()
    cb = ChunkBatch.from_bytes(raw, cap, device="cpu")
    comp, st = batched.compress("zstd", cb, backend=backend)
    want = fzstd.compress_batch(cb.data, cb.sizes, fzstd.DEFAULT_OPTS,
                                fzstd.max_compressed_chunk_size(cap))
    assert torch.equal(comp.data, want[0]) and torch.equal(comp.sizes, want[1])
    assert (st == Status.SUCCESS).all()
    assert b"".join(zstandard.ZstdDecompressor().decompress(f) for f in comp.chunk_list()) == raw


def test_backend_xla_is_the_multi_block_encoder_at_every_cap():
    cb = ChunkBatch.from_bytes(synth.mixed_corpus(9000, seed=14).tobytes(), 4096,
                               device="cpu")
    comp, st = batched.compress("zstd", cb, backend="xla")
    want = fzstd.compress_batch(cb.data, cb.sizes, fzstd.DEFAULT_OPTS,
                                fzstd.max_compressed_chunk_size(4096))
    assert torch.equal(comp.data, want[0]) and (st == Status.SUCCESS).all()
    with pytest.raises(NotImplementedError, match="formats/zstd.py"):
        batched.decompress("zstd", comp, 4096, backend="xla")
    with pytest.raises(ValueError, match="cap <= 65536"):      # the kernel encoder's own gate
        zstd_encode.compress_batch_plain(torch.zeros((1, 65544), dtype=torch.uint8),
                                         torch.zeros(1, dtype=torch.int32), 70000)


def test_manager_round_trip_at_128k_chunks():
    data = synth.mixed_corpus(60_000, seed=15).tobytes()
    mgr = Manager("zstd", 131072, device="cpu")
    frame = mgr.compress(data)
    assert bytes(mgr.decompress(frame).numpy()) == data
    assert len(frame) < len(data)
