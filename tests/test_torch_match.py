"""The port's sort-based match finder against the JAX reference, on the CPU.

``tpucomp_torch.ops.match.candidates`` / ``candidates2`` (torch ops) against
``tpucomp.ops.match`` (XLA) on the same numpy batch, element for element:
every byte the LZ4 emitter writes depends on ``cand``/``cand8``/``nxt``.
Tolerance: exact equality (int32 positions).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tpucomp.ops import match as ref_match

from tpucomp_torch.ops import match
from tpucomp_torch.utils import synth

CAP = 2048
_MIX = synth.mixed_corpus(8400, seed=21)[:8192]


def _signed_order():
    """Equal leading words, second words on both sides of the int32 sign."""
    rng = np.random.default_rng(3)
    tail = rng.choice(np.array([0x00, 0x7F, 0x80, 0xFF], np.uint8), size=(CAP // 8, 4))
    head = np.tile(np.frombuffer(b"WXYZ", np.uint8), (CAP // 8, 1))
    return np.concatenate([head, tail], axis=1).reshape(-1)


ROWS = {  # name -> (function making the row, size); bytes past size stay in the row
    "mixed": (lambda: _MIX[:CAP], CAP),
    "text": (lambda: synth.text_like(CAP, seed=4), CAP),
    "runs": (lambda: synth.runs(CAP, mean_run=40, seed=5), CAP),
    "random": (lambda: synth.gen_data(255, CAP, seed=6), CAP),
    "lowent": (lambda: synth.gen_data(3, CAP, seed=7), CAP),
    "zeros": (lambda: np.zeros(CAP, np.uint8), CAP),
    "signed": (_signed_order, CAP),
    "short_1000": (lambda: _MIX[CAP:2 * CAP], 1000),
    "short_7": (lambda: _MIX[2 * CAP:3 * CAP], 7),
    "short_3": (lambda: _MIX[3 * CAP:4 * CAP], 3),
    "empty": (lambda: _MIX[:CAP], 0),
}
WINDOWS = [65535, 64]
FNS = ["candidates", "candidates2"]


@pytest.fixture(scope="module")
def results():
    data = np.zeros((len(ROWS), CAP), np.uint8)
    sizes = np.zeros(len(ROWS), np.int32)
    for i, (build, size) in enumerate(ROWS.values()):
        data[i] = build()
        sizes[i] = size
    res = {}
    for fn in FNS:
        for w in WINDOWS:
            ref = getattr(ref_match, fn)(jnp.asarray(data), jnp.asarray(sizes), window=w)
            port = getattr(match, fn)(torch.from_numpy(data), torch.from_numpy(sizes),
                                      window=w)
            res[fn, w] = ([np.asarray(r) for r in ref], [p.numpy() for p in port])
    # two whole 64 KiB chunks, the main path's shape
    big = np.stack([synth.mortgage_like(65536, seed=42),
                    synth.mixed_corpus(131200, seed=42)[65536:131072]])
    bsz = np.array([65536, 60000], np.int32)
    res["big"] = ([np.asarray(r) for r in ref_match.candidates2(jnp.asarray(big),
                                                                jnp.asarray(bsz))],
                  [p.numpy() for p in match.candidates2(torch.from_numpy(big),
                                                        torch.from_numpy(bsz))])
    return res


@pytest.mark.parametrize("row", list(ROWS))
@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("fn", FNS)
def test_candidates_equal_reference(results, fn, window, row):
    ref, port = results[fn, window]
    i = list(ROWS).index(row)
    assert len(ref) == len(port)
    for r, p in zip(ref, port):
        assert p.dtype == np.int32
        bad = np.nonzero(p[i] != r[i])[0]
        assert bad.size == 0, (bad[:5], p[i][bad[:5]], r[i][bad[:5]])


@pytest.mark.parametrize("out", ["cand", "cand8", "nxt"])
def test_candidates2_full_chunks_equal_reference(results, out):
    ref, port = results["big"]
    k = ["cand", "cand8", "nxt"].index(out)
    assert np.array_equal(port[k], ref[k])


def test_signed_row_exercises_the_sign_order(results):
    """The signed-order row has 8-byte-prefix candidates: the sort order of
    w1 across the int32 sign decides them."""
    _, port = results["candidates2", 65535]
    i = list(ROWS).index("signed")
    assert (port[1][i] >= 0).sum() > 10
