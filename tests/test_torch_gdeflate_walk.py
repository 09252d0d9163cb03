"""The GDeflate token parse's plain pieces against the serial walk, on the CPU.

The kernels of ``csrc/gdeflate_encode.cu`` do not walk a chunk's tokens one
by one: they compute every position's next token at once (plain version
``lz_parse.next_tokens_plain``), follow the chain of next tokens from 0 and
number the tokens (``path_plain``), and count the tokens' symbols
(``hist``, ``lz_parse.hist_from_path_plain``) or code and pack the tokens
at once (``fixed`` and ``emit``, ``lanes_from_path_plain``).  Here those
pieces are held against the serial walk ``deflate_encode._walk`` (its tokens,
and its counts ``gdeflate_encode._hist_chunk``) and the lanes against
``fixed_plain`` / ``emit_plain`` (the yardstick the kernels are held against
on the card), on the chunks of ``tests/gdeflate_walk_stress.py``
and on mixed and mortgage chunks cut to 8 KiB.  No reference call: the
CPU tests of ``tests/test_torch_gdeflate.py`` hold the walk against the
reference.  Tolerance: exact (positions, lengths, distances, counts, lane
words).
"""
import numpy as np
import pytest
import torch

import gdeflate_walk_stress as gws
from tpucomp_torch import batched
from tpucomp_torch.chunk import ChunkBatch
from tpucomp_torch.constants import Status
from tpucomp_torch.formats import gdeflate as fgdeflate
from tpucomp_torch.ops import match
from tpucomp_torch.ops.cuda import gdeflate_encode as ge, lz_parse
from tpucomp_torch.ops.cuda.deflate_encode import _walk
from tpucomp_torch.utils import synth


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain pieces are loops of small torch ops: on one intra-op thread
    they do not starve the xdist workers beside them with spinning threads.
    The thread count is restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _parsed(cb, names, cands) -> dict:
    """A batch with its candidates, and each row's plain next tokens, path
    and serial walk, computed once for every test of the module."""
    toks, paths, walks = [], [], []
    for i in range(cb.num_chunks):
        size = int(cb.sizes[i])
        toks.append(lz_parse.next_tokens_plain(cb.data[i], size, cands[0][i], cands[1][i]))
        paths.append(lz_parse.path_plain(toks[-1], size))
        walks.append(_walk(cb.data[i].numpy().tobytes(), size, cands[0][i].tolist(),
                           cands[1][i].tolist(), cands[2][i].tolist()))
    return {"cb": cb, "names": names, "cands": cands, "toks": toks, "paths": paths,
            "walks": walks}


@pytest.fixture(scope="module")
def stress():
    cb, names = gws.batch()
    return _parsed(cb, names, gws.candidates(cb, names))


@pytest.fixture(scope="module")
def corpora():
    rows = []
    for fn in (synth.mixed_corpus, synth.mortgage_like):
        raw = fn(1 << 20, seed=42).tobytes()
        rows += [raw[k:k + 8192] for k in (0, 300_000, 1_000_000)]
    cb = ChunkBatch.from_chunks(rows, 8192, device="cpu")
    return _parsed(cb, [f"row {i}" for i in range(len(rows))],
                   match.candidates2(cb.data, cb.sizes))


@pytest.mark.parametrize("which", ["stress", "corpora"])
def test_path_of_next_tokens_is_the_walk(request, which):
    """next_tokens_plain + path_plain give the walk's matches (anchor, start,
    length, distance), and each match ends where next() says; the token
    numbers count the literals and matches before each match."""
    ps = request.getfixturevalue(which)
    cb = ps["cb"]
    for i, name in enumerate(ps["names"]):
        size = int(cb.sizes[i])
        tok = ps["toks"][i]
        matches, numbers, tokens = ps["paths"][i]
        toks, tail = ps["walks"][i]
        assert matches == toks, name
        nxt = tok["next"].tolist()
        for s, start, ml, _ in matches:
            assert nxt[s] == start + ml, name
        lits = 0
        for j, (s, start, _, _) in enumerate(matches):
            lits += start - s
            assert numbers[j] == lits + j, name
        assert tokens == lits + len(matches) + size - tail, name


def _step(row: bytes, size: int, c4, c8, nx, s: int) -> int:
    """The end of the walk's match from anchor (and scan) ``s``, -1 if the
    walk finds none: one turn of ``deflate_encode._walk``'s loop."""
    from tpucomp_torch.ops.cuda.lz4_encode2 import _match_len
    nm = nx[s]
    if nm >= size - 3:
        return -1
    p4 = c4[nm] if c4[nm] >= 0 else c8[nm]
    p8 = c8[nm] if c8[nm] >= 0 else p4
    fcap = min(size - (nm + 4), 254)
    l4 = _match_len(row, nm + 4, p4 + 4, fcap)
    l8 = _match_len(row, nm + 4, p8 + 4, fcap) if p8 != p4 else l4
    src = p8 if l8 > l4 else p4
    nm2, src2 = nm, src
    while nm2 > s and src2 > 0 and row[nm2 - 1] == row[src2 - 1]:
        nm2, src2 = nm2 - 1, src2 - 1
    return nm2 + min(nm - nm2 + 4 + max(l4, l8), 258)


def test_next_tokens_at_every_position_start_a_walk(stress):
    """next(s) is the end of the walk's match from anchor s, for every s of
    a few stress rows (not only those on the chain from 0)."""
    cb, names, cands = stress["cb"], stress["names"], stress["cands"]
    for name in ("back_to_0", "thin_text", "thin_repeat", "cand8_wins", "end_at_mflimit_4"):
        i = names.index(name)
        size = int(cb.sizes[i])
        row = cb.data[i].numpy().tobytes()
        tok = stress["toks"][i]
        c4, c8, nx = (c[i].tolist() for c in cands)
        want = [_step(row, size, c4, c8, nx, s) for s in range(size - 3)]
        assert tok["next"].tolist() == want, name


def test_stress_rows_cover_their_cases(stress):
    """Each stress row holds the case its name promises, in the walk's
    tokens: back extension to source 0 and to the anchor, cand8 winning,
    the 258 cap with and without back extension, ends at mflimit - 1,
    mflimit and mflimit + 1, and a match in the largest rows."""
    cb, names, cands = stress["cb"], stress["names"], stress["cands"]
    seen = set()
    for i, name in enumerate(names):
        size = int(cb.sizes[i])
        c4, c8 = cands[0][i].tolist(), cands[1][i].tolist()
        for a, start, ml, dist in stress["walks"][i][0]:
            nm = cands[2][i][a].item()
            if start < nm:
                if nm - dist - (nm - start) == 0:
                    seen.add("back to source 0")
                if start == a:
                    seen.add("back to the anchor")
                if ml == 258:
                    seen.add("cap with back extension")
            elif ml == 258:
                seen.add("cap")
            p4 = c4[nm] if c4[nm] >= 0 else c8[nm]
            if nm - dist != p4:
                seen.add("cand8 wins")
            end = start + ml - (size - 3)
            seen.add(f"end at mflimit {end:+d}" if abs(end) <= 1 else "end")
        if name.startswith("mixed_") and size in (65535, 65536):
            seen.add(f"size {size}")
    assert {"back to source 0", "back to the anchor", "cap with back extension", "cap",
            "cand8 wins", "end at mflimit -1", "end at mflimit +0", "end at mflimit +1",
            "size 65535", "size 65536"} <= seen


@pytest.mark.parametrize("which", ["stress", "corpora"])
def test_lanes_from_path_equal_fixed_plain(request, which):
    """The parse's emission in fixed codes equals fixed_plain's lanes (words,
    field counts, lane counts, meta)."""
    ps = request.getfixturevalue(which)
    cb, cands = ps["cb"], ps["cands"]
    got = ge.parse_lanes_plain(cb.data, cb.sizes, ps["paths"], None)
    want = ge.fixed_plain(cb.data, cb.sizes, cands)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("which,tables", [("stress", "dynamic"), ("stress", "entropy only"),
                                          ("stress", "15-bit codes"), ("corpora", "dynamic")])
def test_lanes_from_path_equal_emit_plain(request, which, tables):
    """The parse's emission with a table equals emit_plain's lanes: the
    walk's own dynamic tables, entropy-only coding (no candidates) and a
    table of 15-bit codes that overflows the random row's lanes."""
    ps = request.getfixturevalue(which)
    cb, names, cands = ps["cb"], ps["names"], ps["cands"]
    if tables == "entropy only":
        cands = None
    if tables == "15-bit codes":
        tab = gws.long_code_table(cb.num_chunks)
    else:
        tab = ge.dyn_tables_gd(*ge.hist_plain(cb.data, cb.sizes, cands))[0]
    paths = ps["paths"]
    if cands is None:   # no candidates: every byte a literal
        paths = [([], [], n) for n in cb.sizes.tolist()]
    got = ge.parse_lanes_plain(cb.data, cb.sizes, paths, tab)
    want = ge.emit_plain(cb.data, cb.sizes, cands, tab)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    over = want[3][:, 1].numpy()
    if tables == "15-bit codes":
        assert np.nonzero(over)[0].tolist() == [names.index("random_64k")]
        assert int(want[2][names.index("random_64k")].max()) > ge.WCAP
    else:
        assert not over.any()


@pytest.mark.parametrize("which", ["stress", "corpora"])
@pytest.mark.parametrize("how", ["matches", "entropy only"])
def test_hist_from_path_is_the_walks(request, which, how):
    """Row 16's counting phase over the parse's matches (the bytes no match
    covers, each match's length and GDeflate distance symbols, no EOB) gives
    the serial walk's counts, with the 64 KiB candidates and entropy only
    (no matches: every byte a literal)."""
    ps = request.getfixturevalue(which)
    cb = ps["cb"]
    for i, name in enumerate(ps["names"]):
        size = int(cb.sizes[i])
        row = cb.data[i].numpy().tobytes()
        matches, (toks, tail) = ((ps["paths"][i][0], ps["walks"][i]) if how == "matches"
                                 else ([], ([], 0)))
        got = lz_parse.hist_from_path_plain(row, size, matches, 32, 0)
        assert got == ge._hist_chunk(row, size, toks, tail), name


def test_small_sizes_have_no_chain(stress):
    """Rows below 4 bytes have no position to match from; rows of 6-8 bytes
    of two letters hold one match."""
    cb, names, cands = stress["cb"], stress["names"], stress["cands"]
    for n in range(9):
        i = names.index(f"size_{n}")
        tok = lz_parse.next_tokens_plain(cb.data[i], n, cands[0][i], cands[1][i])
        assert tok["next"].numel() == max(n - 3, 0)
        matches, _, tokens = lz_parse.path_plain(tok, n)
        assert len(matches) == (1 if n >= 6 else 0) and tokens == n - sum(
            ml - 1 for _, _, ml, _ in matches)


def test_chunk_past_64_kib_gets_its_own_status():
    """``batched.compress("gdeflate")`` on a chunk of 65544 bytes beside a
    small one, in algos 0-2 through the kernels' plain path: the big chunk
    gets ``ERROR_CHUNK_SIZE_TOO_LARGE``, size 0 and a zero row, and the
    small chunk the tile it gets alone (the parse kernel reads at most a
    row's first 64 KiB, and the call goes on chunk by chunk)."""
    small = synth.mixed_corpus(3000, seed=5).tobytes()
    both = ChunkBatch.from_chunks([b"\x07" * (gws.CAP + 8), small], device="cpu")
    alone = ChunkBatch.from_chunks([small], device="cpu")
    for algo in (0, 1, 2):
        opts = fgdeflate.GdeflateOpts(algo)
        got, st = batched.compress("gdeflate", both, opts)
        want, wst = batched.compress("gdeflate", alone, opts)
        assert st.tolist() == [Status.ERROR_CHUNK_SIZE_TOO_LARGE, wst[0]], algo
        assert got.sizes.tolist() == [0, want.sizes[0]], algo
        assert not got.data[0].any(), algo
        n = int(want.sizes[0])
        assert torch.equal(got.data[1, :n], want.data[0, :n]), algo
