"""The Deflate hist, emit and fixed kernels' and the Zstandard hist and full
kernels' plain pieces against the serial walks, on the CPU.

Rows 11, 12 and 10 (``csrc/deflate_encode.cu``'s hist, emit and fixed kernels) parse a
chunk as GDeflate's rows 16-17 do (``csrc/lz_parse.cuh``; plain versions
``lz_parse.next_tokens_plain`` and ``path_plain``); row 11 counts the
tokens' symbols (``lz_parse.hist_from_path_plain``), rows 12 and 10 place every
token's codes by one prefix sum (``deflate_encode.stream_from_path_plain``:
the chunk's table, or the fixed codes).  Row 21
(``csrc/zstd_encode.cu``'s parse) tabulates every candidate position
(``zstd_encode.position_table_plain``), follows the chain the cost gate
gives (``next_kept_plain``) and adds the repeat-offset keeps
(``gated_chain_plain``), and builds the literal streams and the sequence
stream from prefix sums (``huf_offsets_plain``, ``fse_states_plain``,
``frame_from_parse_plain``); row 20 (its hist kernel) counts the same
parse's codes and uncovered bytes (``hist_from_chain_plain``).  Here the pieces are held against the serial
walks ``deflate_encode._walk`` and ``zstd_encode._walk`` (and their
counts, ``deflate_encode._hist_chunk`` and ``zstd_encode.hist_plain``) and
the frames against ``emit_plain``, ``fixed_plain`` and
``full_plain`` (the yardsticks the kernels are
held against on the card), on ``tests/gdeflate_walk_stress.py``'s chunks
(with Deflate's 32 KiB candidates), ``tests/zstd_walk_stress.py``'s and
8 KiB rows of the mixed and mortgage corpora, two of them from mixed's
literal-heavy last fifth, where the gate turns down almost every candidate.
No reference call: the CPU tests of ``tests/test_torch_deflate.py`` and
``tests/test_torch_zstd_encode.py`` hold the walks against the reference.
Tolerance: exact (positions, sequences, counts, bytes, statuses).
"""
import numpy as np
import pytest
import torch

import gdeflate_walk_stress as gws
import zstd_walk_stress as zws
from tpucomp_torch.chunk import ChunkBatch
from tpucomp_torch.formats import deflate as fdeflate
from tpucomp_torch.ops import match
from tpucomp_torch.ops.cuda import deflate_encode as de
from tpucomp_torch.ops.cuda import lz_parse
from tpucomp_torch.ops.cuda import zstd_encode as ze
from tpucomp_torch.utils import synth

CAP_SEQ = ze._cap_seq(65536)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain pieces are loops of small torch ops: on one intra-op thread
    they do not starve the xdist workers beside them.  Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _corpus_rows() -> list[bytes]:
    rows = []
    for fn, at in ((synth.mixed_corpus, (0, 300_000, 860_000, 1_000_000)),
                   (synth.mortgage_like, (0, 500_000))):
        raw = fn(1 << 20, seed=42).tobytes()
        rows += [raw[k:k + 8192] for k in at]
    return rows


def _deflate(cb, names, cands) -> dict:
    """Each row's parse, walk and dynamic tables, computed once."""
    paths, walks = [], []
    for i in range(cb.num_chunks):
        size = int(cb.sizes[i])
        tok = lz_parse.next_tokens_plain(cb.data[i], size, cands[0][i], cands[1][i])
        paths.append(lz_parse.path_plain(tok, size))
        walks.append(de._walk(cb.data[i].numpy().tobytes(), size, *(c[i].tolist() for c in cands)))
    return {"cb": cb, "names": names, "cands": cands, "paths": paths, "walks": walks,
            "tables": de.dyn_tables(*de.hist_plain(cb.data, cb.sizes, cands)),
            "tables_eo": de.dyn_tables(*de.hist_plain(cb.data, cb.sizes, None))}


def _zstd(cb, names, cands) -> dict:
    """Each row's table, gated chain and walk, and both rungs' tables."""
    tabs, chains, walks = [], [], []
    for i in range(cb.num_chunks):
        size = int(cb.sizes[i])
        row = cb.data[i].numpy().tobytes()
        tabs.append(ze.position_table_plain(cb.data[i], size, cands[0][i], cands[1][i]))
        chains.append(ze.gated_chain_plain(row, size, tabs[-1], CAP_SEQ))
        walks.append(ze._walk(row, size, *(c[i].tolist() for c in cands), CAP_SEQ))
    freq, sch = ze.hist_plain(cb.data, cb.sizes, cands)
    rungs = {"exact": (*ze.huf_meta(freq), *ze.seq_tables(sch)),
             "speed": (*ze.huf_meta(ze.whole_chunk_hist(cb.data, cb.sizes)),
                       *ze.speed_tables(cb.num_chunks, "cpu"))}
    return {"cb": cb, "names": names, "cands": cands, "tabs": tabs, "chains": chains,
            "walks": walks, "rungs": rungs, "hist": (freq, sch)}


@pytest.fixture(scope="module")
def deflate_rows():
    cb, names = gws.batch()
    corp = ChunkBatch.from_chunks(_corpus_rows(), 8192, device="cpu")
    return {"stress": _deflate(cb, names, gws.candidates(cb, names, window=de.WINDOW)),
            "corpora": _deflate(corp, [f"row {i}" for i in range(corp.num_chunks)],
                                match.candidates2(corp.data, corp.sizes, window=de.WINDOW))}


@pytest.fixture(scope="module")
def zstd_rows():
    cb, names = zws.batch()
    corp = ChunkBatch.from_chunks(_corpus_rows(), 8192, device="cpu")
    return {"stress": _zstd(cb, names, zws.candidates(cb, names)),
            "corpora": _zstd(corp, [f"row {i}" for i in range(corp.num_chunks)],
                             match.candidates2(corp.data, corp.sizes, window=zws.WINDOW))}


# --- Deflate (row 12) -----------------------------------------------------------------

@pytest.mark.parametrize("which", ["stress", "corpora"])
def test_deflate_parse_is_the_walk(deflate_rows, which):
    """The shared parse (next tokens, then the chain from 0) gives the
    Deflate walk's tokens over the 32 KiB candidates."""
    ps = deflate_rows[which]
    for i, name in enumerate(ps["names"]):
        assert ps["paths"][i][0] == ps["walks"][i][0], name


@pytest.mark.parametrize("which,how", [("stress", "dynamic"), ("stress", "entropy only"),
                                       ("corpora", "dynamic"), ("stress", "fixed"),
                                       ("corpora", "fixed")])
def test_deflate_stream_from_path_is_emit_plain(deflate_rows, which, how):
    """Every token's codes placed by one prefix sum of the bit counts (the
    header first, EOB last, the stored rewrite decided from the total) give
    emit_plain's frames, also at an out_cap too small for most of them; in
    fixed mode (row 10: the fixed codes and the 3-bit header, no table)
    fixed_plain's, the walk's."""
    ps = deflate_rows[which]
    cb = ps["cb"]
    cands, (tab, hw, hb) = (None, ps["tables_eo"]) if how == "entropy only" else \
        (ps["cands"], ps["tables"])
    tabs, hws, hbs = tab.tolist(), hw.tolist(), hb.tolist()
    frames = []
    for i in range(cb.num_chunks):
        size = int(cb.sizes[i])
        path = ps["paths"][i] if cands is not None else ([], [], size)
        codes = (None, None) if how == "fixed" else (tabs[i], (hws[i], hbs[i]))
        frames.append(de.stream_from_path_plain(cb.data[i].numpy().tobytes(), size, *path,
                                                *codes))
    for out_cap in (fdeflate.max_compressed_chunk_size(65536), 1024):
        got = de._frames(frames, out_cap, "cpu")
        want = de.fixed_plain(cb.data, cb.sizes, cands, out_cap) if how == "fixed" else \
            de.emit_plain(cb.data, cb.sizes, cands, tab, hw, hb, out_cap)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), out_cap


@pytest.mark.parametrize("which", ["stress", "corpora"])
@pytest.mark.parametrize("how", ["matches", "entropy only"])
def test_deflate_hist_from_path_is_the_walks(deflate_rows, which, how):
    """Row 11's counting phase over the parse's matches (the bytes no match
    covers, each match's length and distance symbols, EOB once) gives the
    serial walk's counts, with the 32 KiB candidates and entropy only (no
    matches: every byte a literal)."""
    ps = deflate_rows[which]
    cb = ps["cb"]
    for i, name in enumerate(ps["names"]):
        size = int(cb.sizes[i])
        row = cb.data[i].numpy().tobytes()
        matches, (toks, tail) = ((ps["paths"][i][0], ps["walks"][i]) if how == "matches"
                                 else ([], ([], 0)))
        got = lz_parse.hist_from_path_plain(row, size, matches, 30, 1)
        assert got == de._hist_chunk(row, size, toks, tail), name


# --- Zstandard (row 21) ------------------------------------------------------------------

@pytest.mark.parametrize("which", ["stress", "corpora"])
def test_zstd_gated_chain_is_the_walk(zstd_rows, which):
    """The chain over the per-position table (the gate from the tabulated
    level, the repeat stack, the back extension of kept sequences only)
    gives the walk's sequences and literals."""
    ps = zstd_rows[which]
    cb = ps["cb"]
    for i, name in enumerate(ps["names"]):
        chain, tail = ps["chains"][i]
        seqs, lits = ps["walks"][i]
        assert [(ll, ml, ofv) for _, _, ll, ml, ofv, _ in chain] == seqs, name
        row = cb.data[i].numpy().tobytes()
        got = b"".join(row[s:s + ll] for s, _, ll, _, _, _ in chain) + row[tail:int(cb.sizes[i])]
        assert got == lits, name


@pytest.mark.parametrize("which", ["stress", "corpora"])
def test_zstd_next_kept_and_the_repeat_rule(zstd_rows, which):
    """A sequence the gate keeps is next()'s from its anchor (K(s) + lf);
    one kept only through a repeat offset lies before the gate's K(s).  The
    stack after each sequence is its offset moved to the front of the one
    before (no sequence without literals repeats the offset before it), as
    the kernel's block scan of stacks assumes."""
    ps = zstd_rows[which]
    for i, name in enumerate(ps["names"]):
        tab, (chain, _) = ps["tabs"][i], ps["chains"][i]
        nxt = ze.next_kept_plain(tab).tolist()
        lvl, lf, c = tab["lvl"].tolist(), tab["lf"].tolist(), tab["c"].tolist()
        stack = [1, 4, 8]
        for s, k, ll, _, _, after in chain:
            if lvl[k] <= min(3, k - s):
                assert nxt[s] == k + lf[k], name
            else:
                gate = next((p for p in range(s, len(lvl)) if lvl[p] <= min(3, p - s)), None)
                assert c[k] in stack and (gate is None or gate > k), name
            assert not (ll == 0 and c[k] == stack[0]), name
            stack = [c[k]] + [v for v in stack if v != c[k]][:2]
            assert list(after) == stack, name


def test_zstd_stress_rows_cover_their_cases(zstd_rows):
    """Each rule decides some sequence of the stress rows: a repeat offset
    keeps a candidate the gate turns down (the initial 8 among them), the
    back extension alone gets one past the gate, a sequence without
    literals takes a shifted repeat code, a match of 65,532 bytes and ones
    past 258, a literal-only 64 KiB row."""
    ps = zstd_rows["stress"]
    seen = set()
    for i, name in enumerate(ps["names"]):
        tab, (chain, _) = ps["tabs"][i], ps["chains"][i]
        lvl, c = tab["lvl"].tolist(), tab["c"].tolist()
        for j, (s, k, ll, ml, ofv, _) in enumerate(chain):
            if lvl[k] > min(3, k - s):
                seen.add("repeat only, first 8" if j == 0 and c[k] == 8 else "repeat only")
            elif lvl[k] > 0:
                seen.add("back extension only")
            if ll == 0 and ofv <= 3:
                seen.add("no literals, repeat code")
            if ml >= 65532:
                seen.add("65532")
            elif ml > 258:
                seen.add("past 258")
        if name == "random_64k" and not chain:
            seen.add("literals only")
    assert {"repeat only", "repeat only, first 8", "back extension only",
            "no literals, repeat code", "65532", "past 258", "literals only"} <= seen


@pytest.mark.parametrize("which", ["stress", "corpora"])
def test_zstd_hist_from_chain_is_hist_plain(zstd_rows, which):
    """Row 20's counting phase over the gated chain (each sequence's codes,
    the bytes no kept match covers) gives hist_plain's counts, the walk's."""
    ps = zstd_rows[which]
    cb = ps["cb"]
    freq, sch = (t.tolist() for t in ps["hist"])
    for i, name in enumerate(ps["names"]):
        got = ze.hist_from_chain_plain(cb.data[i].numpy().tobytes(), int(cb.sizes[i]),
                                       ps["chains"][i][0])
        assert got == (freq[i], sch[i]), name


@pytest.mark.parametrize("which", ["stress", "corpora"])
def test_zstd_literal_offsets_give_the_streams(zstd_rows, which):
    """Each literal's offset in its stream (a suffix sum of code lengths:
    the streams are written backward) and the streams' bit counts give
    _huf_streams' four streams."""
    ps = zstd_rows[which]
    meta = ps["rungs"]["exact"][0].tolist()
    n = 0
    for i, name in enumerate(ps["names"]):
        lits = ps["walks"][i][1]
        if len(lits) < 64:
            continue
        offs, totals = ze.huf_offsets_plain(lits, meta[i][:256])
        got = ze.huf_streams_from_offsets(lits, meta[i][:256], offs, totals)
        assert got == ze._huf_streams(lits, meta[i][:256]), name
        n += 1
    assert n >= 3


@pytest.mark.parametrize("which,rung", [("stress", "exact"), ("stress", "speed"),
                                        ("corpora", "exact")])
def test_zstd_fse_states_give_the_sequence_stream(zstd_rows, which, rung):
    """The three FSE states after every step, then every step's fields at
    a prefix sum of their widths (a transition's bits the low bits of the
    state), give _seq_stream's bytes, with custom and predefined tables."""
    ps = zstd_rows[which]
    fse = ps["rungs"][rung][2].tolist()
    for i, name in enumerate(ps["names"]):
        seqs = ps["walks"][i][0]
        if seqs:
            states = ze.fse_states_plain(seqs, fse[i])
            got = ze.seq_stream_from_states_plain(seqs, fse[i], states)
            assert got == bytes(ze._seq_stream(seqs, fse[i])), name


@pytest.mark.parametrize("which,rung", [("stress", "exact"), ("corpora", "speed")])
def test_zstd_frames_from_the_parse_are_full_plain(zstd_rows, which, rung):
    """Frames assembled from the parse's pieces equal full_plain's, also at
    an out_cap too small for some."""
    ps = zstd_rows[which]
    cb = ps["cb"]
    meta, tree, fse, nc = ps["rungs"][rung]
    ml, fl, tr, ncs = meta.tolist(), fse.tolist(), tree.numpy(), nc.numpy()
    frames = [ze.frame_from_parse_plain(cb.data[i].numpy().tobytes(), int(cb.sizes[i]),
                                        *ps["chains"][i], ml[i], tr[i].tobytes(), fl[i],
                                        ncs[i].tobytes())
              for i in range(cb.num_chunks)]
    for out_cap in (ze.fzstd.max_compressed_chunk_size(65536), 2048):
        got = de._frames(frames, out_cap, "cpu")
        want = ze.full_plain(cb.data, cb.sizes, ps["cands"], meta, tree, fse, nc, out_cap)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), out_cap
    assert np.count_nonzero(want[2].numpy()) >= 1 or which == "corpora"
