"""The port's GDeflate path against the JAX reference, on the CPU.

The plain versions of the port's encoder (algo 0 fixed tables, algo 1
dynamic tables, algo 2 dynamic tables without matches: the walks, the
dynamic tables, the refill schedule and the tile assembly), of its decoder
(``tile_tables``, the 32-lane parse, the token replay and the status
composition) and ``tile_tables`` itself are held against ``tpucomp``'s Pallas
kernels run in interpret mode (``gdeflate_encode.compress_batch``,
``compress_batch_dyn``, ``gdeflate_vdecode.decompress_batch``) and the
reference's vmapped ``tile_tables`` on the same numpy inputs: 64 KiB rows
(the mixed and mortgage heads of ``synth`` at seed 42 and a row with
distances above 49152), the edge rows of ``tests/test_pallas_gdeflate.py``,
tiles of ``tests/gdeflate_pyref.py`` (btype 0, 1, 2), ``tests/golden/
gdeflate.bin`` and corrupt tiles.  ``gdeflate_pyref`` reads the port's tiles.
Tolerance: exact equality — every output is bytes, sizes, status codes or
table words.

All reference calls run once, in the module fixture (about 45 s on one
worker here: the encoders some 30 s, the decoder some 10 s, ``tile_tables``
compiled with XLA's backend optimisations off some 3 s).  Keep this file
below 26 cases, so xdist queues it after ``tests/test_zstd.py``
(``ROADMAP.md``).
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gdeflate_pyref as pyref
import tpucomp.manager as ref_manager
from tpucomp.formats import gdeflate as ref_fg
from tpucomp.ops.pallas import gdeflate_encode as ref_enc
from tpucomp.ops.pallas import gdeflate_vdecode as ref_dec

from tpucomp_torch import batched
from tpucomp_torch.chunk import ChunkBatch
from tpucomp_torch.constants import Status
from tpucomp_torch.formats import gdeflate as fg
from tpucomp_torch.manager import ChecksumPolicy, Manager, create_manager
from tpucomp_torch.manager import _opts_to_blob
from tpucomp_torch.ops.cuda import gdeflate_encode, gdeflate_vdecode
from tpucomp_torch.utils import synth

CAP = 65536
BOUND = fg.max_compressed_chunk_size(CAP)
ALGOS = [0, 1, 2]
GOLDEN = Path(__file__).parent / "golden"

_SEG = bytes(np.random.default_rng(3).integers(0, 256, 40_000, dtype=np.uint8))
_RNG = np.random.default_rng(7)
EDGE = [  # tests/test_pallas_gdeflate.py:22-32
    b"hello gdeflate, hello gdeflate, hello gdeflate! " * 30,
    bytes(_RNG.integers(0, 4, 3000, dtype=np.uint8)),
    bytes(_RNG.integers(0, 256, 700, dtype=np.uint8)),
    b"\x00" * 3000, b"ab" * 1200, b"x", b""]
ROWS = {  # the encoders' rows (each costs the reference some 0.3 s a call)
    "mixed": synth.mixed_corpus(CAP, seed=42).tobytes()[:CAP],
    "mortgage": synth.mortgage_like(CAP, seed=42).tobytes()[:CAP],
    # distance codes 30/31 (tests/test_pallas_gdeflate.py:63-72)
    "far": _SEG + b"\x00" * 12_000 + _SEG[:12_000],
    **{f"edge{i}": EDGE[i] for i in (0, 2, 5, 6)},   # compressible, incompressible, tiny, empty
}


def _golden() -> tuple[list[bytes], list[bytes]]:
    blob = (GOLDEN / "gdeflate.bin").read_bytes()
    n = int(np.frombuffer(blob[:4], np.int32)[0])
    off, tiles = 4 + 4 * n, []
    for s in np.frombuffer(blob[4:4 + 4 * n], np.int32):
        tiles.append(blob[off:off + s])
        off += s
    raw = (GOLDEN / "input.bin").read_bytes()
    k = len(raw) // 3
    return tiles, [raw[:k], raw[k:2 * k], raw[2 * k:]]


def _corrupt() -> dict:
    """tests/test_pallas_gdeflate.py:85-99, a future framing version, a raw
    size above the output capacity, truncations and bit flips."""
    good = pyref.compress(b"corrupt me " * 50, btype=2)
    c = {"btype3": b"\x03" + b"\x00" * 16, "truncated": good[:24],
         "random": bytes(_RNG.integers(0, 256, 96, dtype=np.uint8)), "empty": b""}
    for name, at, val in (("many_tokens", 2, (1 << 24).to_bytes(4, "little")),
                          ("future_version", 1, b"\x02"),
                          ("raw_too_big", 6, (CAP + 8).to_bytes(4, "little")),
                          ("raw_negative", 6, (0xFFFFFF00).to_bytes(4, "little"))):
        b = bytearray(good)
        b[at:at + len(val)] = val
        c[name] = bytes(b)
    for k in (30, len(good) // 2, len(good) - 1):
        c[f"cut{k}"] = good[:k]
    for i in range(6):
        b = bytearray(good)
        b[_RNG.integers(0, len(good))] ^= 1 << _RNG.integers(0, 8)
        c[f"flip{i}"] = bytes(b)
    return c


PYREF = {f"pyref{b}_{i}": pyref.compress(r, btype=b) for i, r in enumerate(EDGE)
         for b in (0, 1, 2)}
GOLDEN_TILES, GOLDEN_RAWS = _golden()
CORRUPT = _corrupt()
# the 64 KiB tiles the reference decoder reads: one of each algo
BIG_TILES = {"mixed": 0, "mortgage": 1, "far": 2}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """This file runs beside the suite's longest file (xdist queues it after
    ``test_zstd.py``): keep its torch ops to one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows_batch():
    cb = ChunkBatch.from_chunks(list(ROWS.values()), CAP, device="cpu")
    return cb.data.numpy(), cb.sizes.numpy()


def _tiles(res) -> list[bytes]:
    return [res[0][i, :res[1][i]].tobytes() for i in range(len(res[1]))]


@pytest.fixture(scope="module")
def ref():
    """Every reference call of this file, once."""
    res = {}
    d, s = (jnp.asarray(x) for x in _rows_batch())
    calls = {0: lambda: ref_enc.compress_batch(d, s, BOUND, interpret=True),
             1: lambda: ref_enc.compress_batch_dyn(d, s, BOUND, interpret=True),
             2: lambda: ref_enc.compress_batch_dyn(d, s, BOUND, interpret=True,
                                                   entropy_only=True)}
    for algo, call in calls.items():
        res["encode", algo] = [np.asarray(x) for x in call()]
    names, tiles = [], []
    for algo in ALGOS:
        for i, (name, tile) in enumerate(zip(ROWS, _tiles(res["encode", algo]))):
            if name.startswith("edge") or BIG_TILES.get(name) == algo:
                names.append(f"{name}_algo{algo}")
                tiles.append(tile)
    named = {**dict(zip(names, tiles)), **PYREF, **CORRUPT,
             **{f"golden{i}": t for i, t in enumerate(GOLDEN_TILES)}}
    dec = ChunkBatch.from_chunks(list(named.values()), BOUND, device="cpu")
    res["decode_names"] = list(named)
    res["decode_in"] = (dec.data.numpy(), dec.sizes.numpy())
    c, cs = (jnp.asarray(x) for x in res["decode_in"])
    res["decode"] = [np.asarray(x) for x in ref_dec.decompress_batch(c, cs, CAP,
                                                                     interpret=True)]
    tables = jax.jit(jax.vmap(ref_fg.tile_tables)).lower(c, cs).compile(
        compiler_options={"xla_backend_optimization_level": 0,
                          "xla_llvm_disable_expensive_passes": True})(c, cs)
    res["tables"] = [np.asarray(x) for x in jax.tree_util.tree_leaves(tables)]
    res["sizes"] = np.asarray(jax.vmap(ref_fg.get_decompress_size)(c, cs))
    return res


@pytest.fixture(scope="module")
def port(ref):
    """The port's plain decoder, once, over the reference's decode inputs and
    then the port's own tiles of every algo: the parse, the replay and the
    status composition (``gdeflate_vdecode.decompress_batch_plain``'s steps)."""
    own = [t for algo in ALGOS for t in _tiles(_port_encode(algo))]
    names = ref["decode_names"] + [f"port_{n}_algo{a}" for a in ALGOS for n in ROWS]
    data, sizes = ref["decode_in"]
    cb = ChunkBatch.from_chunks([data[i, :sizes[i]].tobytes() for i in range(len(sizes))]
                                + own, BOUND, device="cpu")
    parse = gdeflate_vdecode.parse_plain(cb.data, cb.sizes, CAP)
    tabs, tokens = parse[0], parse[1]
    n_eff = torch.minimum(tabs[:, 1], torch.tensor(tokens.shape[1], dtype=torch.int32))
    replay = gdeflate_vdecode.exec_plain(tokens, n_eff, CAP)
    out = gdeflate_vdecode._compose(cb.data, cb.sizes, CAP, tabs, parse[2], parse[3], *replay)
    return {"names": names, "in": (cb.data, cb.sizes), "parse": parse, "replay": replay,
            "decode": [x.numpy() for x in out]}


def _port_encode(algo, out_cap=BOUND):
    d, s = (torch.from_numpy(x) for x in _rows_batch())
    return [x.numpy() for x in gdeflate_encode.compress_algo(d, s, fg.GdeflateOpts(algo),
                                                             out_cap, plain=True)]


def _differing(got, want, names):
    got, want = np.asarray(got), np.asarray(want)
    return [names[i] for i in np.nonzero((got != want).reshape(len(names), -1).any(axis=1))[0]]


# ----------------------------------------------------------------- encode ---

@pytest.mark.parametrize("algo", ALGOS)
def test_encoder_equals_reference(ref, algo):
    got, want = _port_encode(algo), ref["encode", algo]
    for k in range(3):
        bad = _differing(got[k], want[k], list(ROWS))
        assert not bad, f"output {k} differs on {bad}"
    assert (want[2] == Status.SUCCESS).all()
    btypes = {n: t[0] for n, t in zip(ROWS, _tiles(want))}
    assert btypes["mixed"] == (1 if algo == 0 else 2) and btypes["edge5"] == 0


@pytest.mark.parametrize("algo", ALGOS)
def test_pyref_and_port_decoder_read_port_tiles(port, algo):
    out, osz, stat = _port_encode(algo)
    raws = list(ROWS.values())
    assert [pyref.decompress(t) for t in _tiles((out, osz))] == raws
    dec, dsz, dst = port["decode"]
    for n, r in ROWS.items():
        i = port["names"].index(f"port_{n}_algo{algo}")
        assert dst[i] == Status.SUCCESS and dec[i, :dsz[i]].tobytes() == r, n


def test_encoder_output_buffer_too_small(ref):
    """A tile longer than out_cap: ERROR_OUTPUT_BUFFER_TOO_SMALL, size 0, a
    zero row; the others as at the bound (the reference's rule,
    ``gdeflate_encode.py:696-701``)."""
    small = 4096
    out, osz, stat = _port_encode(1, small)
    want_out, want_sz, _ = ref["encode", 1]
    fits = want_sz <= small
    assert (~fits).sum() >= 2 and fits.sum() >= 3
    np.testing.assert_array_equal(stat, np.where(fits, Status.SUCCESS,
                                                 Status.ERROR_OUTPUT_BUFFER_TOO_SMALL))
    np.testing.assert_array_equal(osz, np.where(fits, want_sz, 0))
    np.testing.assert_array_equal(out, np.where(fits[:, None], want_out[:, :small], 0))


def test_dyn_tables_describe_the_tiles(ref):
    """The dynamic tables of the reference's btype-2 tiles, read back by
    ``tile_tables``, are the lengths the port's ``dyn_tables_gd`` coded."""
    d, s = (torch.from_numpy(x) for x in _rows_batch())
    llh, dh = gdeflate_encode.hist_plain(d, s, gdeflate_encode._candidates(d, s, False))
    tab, desc, hdr_bytes, use_dyn = gdeflate_encode.dyn_tables_gd(llh, dh)
    out, osz, _ = ref["encode", 1]
    tt = fg.tile_tables(torch.from_numpy(out.copy()))
    for i in np.nonzero((out[:, 0] == 2))[0]:
        assert bool(use_dyn[i])
        assert int(out[i, 10]) | (int(out[i, 11]) << 8) == int(hdr_bytes[i])
        lens = (tab[i] >> 16).numpy()
        counts = np.bincount(lens[:288], minlength=16)
        np.testing.assert_array_equal(tt[4][0][i, 1:].numpy(), counts[1:16])
    assert use_dyn.any() and (hdr_bytes == torch.where(use_dyn, hdr_bytes, 0)).all()


# ----------------------------------------------------------------- decode ---

def test_decoder_equals_reference(ref, port):
    n = len(ref["decode_names"])
    for k in range(3):
        bad = _differing(port["decode"][k][:n], ref["decode"][k], ref["decode_names"])
        assert not bad, f"output {k} differs on {bad}"


def test_decoder_statuses(ref):
    out, osz, stat = ref["decode"]
    st = dict(zip(ref["decode_names"], stat))
    raws = {**{f"{n}_algo{a}": r for n, r in ROWS.items() for a in ALGOS},
            **{f"pyref{b}_{i}": r for i, r in enumerate(EDGE) for b in (0, 1, 2)},
            **{f"golden{i}": r for i, r in enumerate(GOLDEN_RAWS)}}
    for i, name in enumerate(ref["decode_names"]):
        if name in raws:
            assert st[name] == Status.SUCCESS, name
            assert out[i, :osz[i]].tobytes() == raws[name], name
    for name in ("btype3", "truncated", "many_tokens", "future_version", "empty", "cut30"):
        assert st[name] == Status.ERROR_CANNOT_DECOMPRESS, name
    assert st["raw_too_big"] == Status.ERROR_OUTPUT_BUFFER_TOO_SMALL


def test_tile_tables_equal_reference(ref):
    data, sizes = ref["decode_in"]
    got = fg.tile_tables(torch.from_numpy(data), torch.from_numpy(sizes))
    got = [x for g in got for x in (g if isinstance(g, tuple) else (g,))]
    fields = ["btype", "n_tokens", "raw_size", "D", "lcount", "lfirst", "loffset", "lsor",
              "dcount", "dfirst", "doffset", "dsor", "dw_start", "tbl_ok"]
    assert len(got) == len(ref["tables"]) == len(fields)
    for name, g, w in zip(fields, got, ref["tables"]):
        bad = _differing(g.numpy(), w, ref["decode_names"])
        assert not bad, f"{name} differs on {bad}"
    assert not ref["tables"][-1].all() and ref["tables"][-1].any()


def test_parse_and_replay_outputs(port):
    """The parse's tables row is ``tile_tables``; tokens past the count are
    0; the replay writes nothing past the first token it cannot write."""
    data, sizes = port["in"]
    tabs, tokens, sp, err = port["parse"]
    tt = fg.tile_tables(data)
    np.testing.assert_array_equal(tabs[:, 1].numpy(), tt[1].numpy())
    np.testing.assert_array_equal(tabs[:, gdeflate_vdecode.T_LSOR:gdeflate_vdecode.T_DSOR]
                                  .numpy(), tt[4][3].numpy())
    n = torch.clamp(torch.minimum(tabs[:, 1], torch.tensor(tokens.shape[1])), min=0)
    live = torch.arange(tokens.shape[1]) < n[:, None]
    assert (tokens[~live] == 0).all()
    assert (err & 2).any() and (err == 0).any()
    toks = torch.tensor([[ord("a"), gdeflate_vdecode.MATCH_FLAG | (3 << 17) | 1, ord("b"),
                          gdeflate_vdecode.MATCH_FLAG | (0 << 17) | 9, ord("c")]],
                        dtype=torch.int32)
    out, op, derr = gdeflate_vdecode.exec_plain(toks, torch.tensor([5]), 16)
    assert bytes(out[0].numpy()) == b"aaaaaaab" + bytes(8)   # nothing after the bad match
    assert (int(op[0]), int(derr[0])) == (12, 1)


# -------------------------------------------------------------------- api ---

def test_sizes_and_bounds(ref):
    for n in (0, 1, 1000, 4096, 65536):
        assert fg.max_compressed_chunk_size(n) == ref_fg.max_compressed_chunk_size(n)
    assert BOUND == 100352
    data, sizes = ref["decode_in"]
    got = fg.get_decompress_size(torch.from_numpy(data), torch.from_numpy(sizes))
    np.testing.assert_array_equal(got.numpy(), ref["sizes"])
    assert batched.get_decompress_size(
        "gdeflate", ChunkBatch(torch.from_numpy(data), torch.from_numpy(sizes))).tolist() \
        == ref["sizes"].tolist()


def test_batched_api_and_kernel_paths():
    buf = ROWS["mixed"][:30000] + ROWS["far"][:20000]
    cb = ChunkBatch.from_bytes(buf, 16384, device="cpu")
    for algo in ALGOS:
        comp, cst = batched.compress("gdeflate", cb, fg.GdeflateOpts(algo))
        dec, dst = batched.decompress("gdeflate", comp, 16384)
        assert (cst == 0).all() and (dst == 0).all() and dec.to_bytes() == buf
    with pytest.raises(ValueError, match="CUDA"):
        batched.compress("gdeflate", cb, backend="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        batched.decompress("gdeflate", cb, 16384, backend="kernel")
    for fn in (gdeflate_encode.compress_batch, gdeflate_vdecode.decompress_batch):
        with pytest.raises(ValueError, match="CUDA"):
            fn(cb.data, cb.sizes, 16384)
    with pytest.raises(ValueError, match="CUDA"):
        gdeflate_vdecode.exec_kernel(torch.zeros((1, 32), dtype=torch.int32),
                                     torch.zeros(1, dtype=torch.int32), 16)


@pytest.mark.parametrize("algo", ALGOS)
def test_manager_round_trip_and_opts_blob(algo):
    data = ROWS["mortgage"][:50000] + EDGE[1]
    m = Manager("gdeflate", 16384, fg.GdeflateOpts(algo),
                checksum_policy=ChecksumPolicy.COMPUTE_AND_VERIFY, device="cpu")
    frame = m.compress(data)
    assert bytes(frame[40:56].numpy()) == ref_manager._opts_to_blob(
        "gdeflate", ref_fg.GdeflateOpts(algo)) == _opts_to_blob("gdeflate", m.opts)
    m2 = create_manager(frame, device="cpu")
    assert (m2.format, m2.opts) == ("gdeflate", fg.GdeflateOpts(algo))
    cfg = m2.configure_decompression(frame)
    assert bytes(m2.decompress(frame, cfg).numpy()) == data
    assert cfg.get_status() == Status.SUCCESS
