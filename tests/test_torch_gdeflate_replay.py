"""The GDeflate replay's window kernel (row 14) in its plain pieces, on the CPU.

Where ``out_cap <= 65536``, ``gdeflate_vdecode.exec_kernel`` launches the
window kernel of ``csrc/gdeflate_vdecode.cu``: one CTA a tile, the tokens'
positions by block scans (``replay_positions_plain``: each token's
position, the first token not written, op and the distance error), the
written tokens placed as runs in a 64 KiB window with a source a byte
(``replay_sources_plain``: a match at the distance of the match before it
continues that one's run), then pointer jumping (``replay_jump_plain``).
Here the pieces, composed by ``exec_window_plain``, are held against
``exec_plain`` (the replay's plain version, which ``tests/test_torch_gdeflate.py``
holds against the reference) on ``tests/gdeflate_replay_stress.py``'s token
rows at ``out_cap`` 65536, 1000 and 66560 (the walk's shape on the card:
the pieces are its semantics too) and on the tokens that ``parse_plain``
reads from the port's own tiles of a small corpus in algos 0-2.  No
reference call.  Tolerance: exact (bytes, op, derr, positions).
"""
import numpy as np
import pytest
import torch

import gdeflate_replay_stress as grs
from tpucomp_torch import batched
from tpucomp_torch.chunk import ChunkBatch
from tpucomp_torch.constants import Status
from tpucomp_torch.formats import gdeflate as fg
from tpucomp_torch.ops.cuda import gdeflate_vdecode as gv
from tpucomp_torch.utils import synth

ALGOS = (0, 1, 2)
TILE = 16384          # the small corpus's chunk size
OUT_CAP = 65536       # the main path's out_cap


def _pieces(toks: np.ndarray, n: int, out_cap: int) -> dict:
    """One tile through the plain pieces, each output kept."""
    pos, length, is_m, dist, wend, op, derr = gv.replay_positions_plain(toks, n, out_cap)
    end = min(op if wend is None else wend, out_cap)
    window, src, matched = gv.replay_sources_plain(toks, pos, is_m, dist, end)
    resolved, rounds = gv.replay_jump_plain(src) if matched else (src, 0)
    return {"pos": pos, "len": length, "is_m": is_m, "dist": dist, "wend": wend, "op": op,
            "derr": derr, "end": end, "window": window, "src": src, "resolved": resolved,
            "rounds": rounds}


@pytest.fixture(scope="module")
def replay():
    """The stress rows at each out_cap and the port's tiles: the replay's
    plain version and the window's pieces, once."""
    res = {}
    for out_cap in grs.OUT_CAPS:
        toks, n, names = grs.batch(out_cap)
        t, c = torch.from_numpy(toks), torch.from_numpy(n)
        res[out_cap] = {"names": names, "toks": toks, "n": n,
                        "want": gv.exec_plain(t, c, out_cap),
                        "got": gv.exec_window_plain(t, c, out_cap),
                        "pieces": [_pieces(toks[i], int(n[i]), out_cap) for i in range(len(n))]}
    raw = (synth.mixed_corpus(1 << 20, seed=42).tobytes()[:2 * TILE]
           + synth.mortgage_like(1 << 20, seed=42).tobytes()[:2 * TILE])
    cb = ChunkBatch.from_bytes(raw, TILE, device="cpu")
    for algo in ALGOS:
        comp, cst = batched.compress("gdeflate", cb, fg.GdeflateOpts(algo))
        assert (cst == Status.SUCCESS).all()
        tabs, tokens, sp, perr = gv.parse_plain(comp.data, comp.sizes, OUT_CAP)
        n_eff = torch.minimum(tabs[:, 1], torch.tensor(tokens.shape[1], dtype=torch.int32))
        want = gv.exec_plain(tokens, n_eff, OUT_CAP)
        got = gv.exec_window_plain(tokens, n_eff, OUT_CAP)
        res["algo", algo] = {"cb": cb, "comp": comp, "parse": (tabs, sp, perr), "want": want,
                             "got": got}
    return res


@pytest.mark.parametrize("out_cap", grs.OUT_CAPS)
def test_window_pieces_are_exec_plain(replay, out_cap):
    """The composed pieces give exec_plain's bytes, op and derr on every
    stress row."""
    r = replay[out_cap]
    for k, what in enumerate(("out", "op", "derr")):
        bad = [r["names"][i] for i in range(len(r["names"]))
               if not torch.equal(r["got"][k][i], r["want"][k][i])]
        assert not bad, f"{what} differs on {bad}"


@pytest.mark.parametrize("out_cap", grs.OUT_CAPS)
def test_positions_are_the_serial_replay(replay, out_cap):
    """Each token's position is the bytes of the tokens before it; the first
    token not written is the serial replay's first token that stops it; the
    bytes past the written ones are 0."""
    r = replay[out_cap]
    for i, name in enumerate(r["names"]):
        p = r["pieces"][i]
        op, live, wend, err = 0, True, None, 0
        for j, tok in enumerate(r["toks"][i, :r["n"][i]].tolist()):
            assert p["pos"][j] == op, (name, j)
            m = tok >= grs.MATCH_FLAG
            ln = ((tok >> 17) & 0xFF) + 3 if m else 1
            bad = m and not 1 <= (tok & 0x1FFFF) <= op
            err |= bad
            if live and (bad or (op + ln > out_cap if m else op >= out_cap)):
                live, wend = False, op
            op += ln
        assert (p["wend"], p["op"], p["derr"]) == (wend, op, int(err)), name
        assert not r["got"][0][i, p["end"]:].any(), name


@pytest.mark.parametrize("out_cap", grs.OUT_CAPS)
def test_sources_point_back_to_literals(replay, out_cap):
    """Before jumping, a copied byte's source lies before its run's start
    (so the chains end); after it, every byte's source is a literal's
    byte, its own source, within 16 rounds."""
    r = replay[out_cap]
    for i, name in enumerate(r["names"]):
        p = r["pieces"][i]
        o = np.arange(p["end"])
        lit_pos = p["pos"][(p["pos"] < p["end"]) & ~p["is_m"]]
        own = np.isin(o, lit_pos)
        assert (p["src"][own] == o[own]).all() and (p["src"][~own] < o[~own]).all(), name
        assert (p["resolved"][p["resolved"]] == p["resolved"]).all(), name
        assert np.isin(p["resolved"], lit_pos).all() and p["rounds"] <= 16, name


def test_stress_rows_cover_their_cases(replay):
    """At 64 KiB: the rows reach the cases they are named for."""
    r = replay[OUT_CAP]
    by = {name: (int(r["n"][i]), r["pieces"][i]) for i, name in enumerate(r["names"])}
    cap = grs.ntok_cap(OUT_CAP)
    assert by["no token"][0] == 0 and by["full capacity"][0] == cap
    assert by["distance past op early"][1]["wend"] == 2
    late = by["distance past op late"][1]
    assert late["derr"] == 1 and late["wend"] == OUT_CAP - 10
    assert by["literal at out_cap"][1]["wend"] == OUT_CAP
    mid = by["match past out_cap mid-tile"][1]
    assert mid["wend"] == OUT_CAP - 100 and mid["derr"] == 0
    assert by["distance 0"][1]["derr"] == 1
    eq = by["distance equal to op"][1]
    assert eq["derr"] == 0 and eq["wend"] is None
    assert by["chains of 14 or more jumps"][1]["rounds"] >= 14
    for name, runs in (("periodic runs, distances 1 to 8", sum(range(1, 9)) + 8),
                       ("one distance across slabs", 5 + 1)):
        p = by[name][1]   # a run a literal, one a block of matches at one distance
        assert p["wend"] is None, name
        k = int(np.searchsorted(p["pos"], p["end"]))
        code = np.where(p["is_m"][:k], p["dist"][:k], 0)
        assert int(((code == 0) | (code != np.concatenate([[0], code[:-1]]))).sum()) == runs, name


@pytest.mark.parametrize("algo", ALGOS)
def test_port_tiles(replay, algo):
    """The tokens of the port's own tiles (mixed and mortgage, 16 KiB tiles):
    the pieces give exec_plain's output, which composes to the raw chunks."""
    r = replay["algo", algo]
    assert all(torch.equal(g, w) for g, w in zip(r["got"], r["want"]))
    comp, cb = r["comp"], r["cb"]
    tabs, sp, perr = r["parse"]
    out, osz, stat = gv._compose(comp.data, comp.sizes, OUT_CAP, tabs, sp, perr, *r["got"])
    assert (stat == Status.SUCCESS).all() and torch.equal(osz, cb.sizes)
    assert torch.equal(out[:, :TILE], cb.data)


def test_window_takes_rows_of_at_most_64_kib():
    """The wrappers choose by shape: the window up to 64 KiB of output (the
    walk past it), and neither runs on CPU tensors."""
    assert gv.replay_fits(65536) and not gv.replay_fits(65537)
    for out_cap in (1000, 66560):
        with pytest.raises(ValueError, match="CUDA"):
            gv.exec_kernel(torch.zeros((1, 32), dtype=torch.int32),
                           torch.zeros(1, dtype=torch.int32), out_cap)
    with pytest.raises(ValueError, match="CUDA"):
        gv.exec_walk_kernel(torch.zeros((1, 32), dtype=torch.int32),
                            torch.zeros(1, dtype=torch.int32), 1000)
