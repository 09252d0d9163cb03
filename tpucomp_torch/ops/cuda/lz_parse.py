"""Plain versions of the parallel token parse of ``csrc/lz_parse.cuh``.

The Deflate ``hist`` and ``emit`` kernels (``csrc/deflate_encode.cu``) and
the GDeflate ``hist``, ``fixed`` and ``emit`` kernels
(``csrc/gdeflate_encode.cu``) do not walk a chunk's tokens one by one: the
token that follows a scan position depends on that position alone, so every
position's next token is computed at once (:func:`next_tokens_plain`), then
the chain of next tokens from 0 is followed and its tokens numbered
(:func:`path_plain`); the ``hist`` kernels then count the tokens' symbols
(:func:`hist_from_path_plain`).  These are those passes' plain versions, one
chunk at a time; the CPU tests hold them against the serial walk
``deflate_encode._walk`` and its counts.  Nothing on the card path calls
them.
"""
from __future__ import annotations

import numpy as np
import torch

from tpucomp_torch.ops.cuda.deflate_encode import MAX_MATCH, MIN_MATCH, _dist_sym, _len_sym


def _common_prefix(words: np.ndarray, a: np.ndarray, c: np.ndarray,
                   cap_n: np.ndarray, row: np.ndarray | None = None) -> np.ndarray:
    """Per element, the common-prefix length of the bytes at ``a`` and at
    ``c < a``, at most ``cap_n``, 8 bytes a step: ``words[x]`` holds the 8
    bytes at ``x`` (little-endian), far enough past the last byte that ``a +
    cap_n`` and ``c + cap_n`` stay inside.  Without ``row`` it steps up to
    ``cap_n`` (Deflate's, <= 254).  With ``row`` (the chunk's bytes, for
    zstd's uncapped matches) it steps 64 bytes, then finds the rest a
    distance at a time: the first byte at or past ``a + 64`` that differs
    from the one its distance before."""
    n = np.zeros(a.shape, np.int64)
    live = np.nonzero(cap_n > 0)[0]
    stop = 64 if row is not None else int(cap_n.max()) if cap_n.size else 0
    for k in range(0, stop, 8):
        if not live.size:
            break
        x = words[a[live] + k] ^ words[c[live] + k]
        low = (x & (~x + np.uint64(1))).astype(np.float64)     # the lowest set bit
        first = np.where(x != 0, np.log2(np.maximum(low, 1)).astype(np.int64) >> 3, 8)
        n[live] = k + first
        live = live[(x == 0) & (k + 8 < cap_n[live])]
    if row is not None and live.size:
        size = len(row)
        dist = a[live] - c[live]
        for d in np.unique(dist):
            sel = live[dist == d]
            idx = np.arange(d, size)
            mis = np.where(row[d:] == row[:size - d], size, idx)
            nf = np.minimum.accumulate(mis[::-1])[::-1]         # first mismatch at or past x
            start = a[sel] + 64
            n[sel] = np.where(start < size, nf[np.minimum(start, size - 1) - d], size) - a[sel]
    return np.minimum(n, cap_n)


def next_tokens_plain(row: torch.Tensor, size: int, cand: torch.Tensor,
                      cand8: torch.Tensor) -> dict:
    """The parse kernel's next-token pass, for one chunk (``row uint8[cap]``,
    candidates2's ``cand`` and ``cand8`` rows).

    A position ``p < mflimit`` has a candidate where ``cand`` or ``cand8`` is
    set (where candidates2's ``nxt`` points).  There the walk's forward
    extensions give ``length[p]`` (the longer, cand8 only if longer) from
    ``src[p]``, and the back extension through the positions before ``p``
    that have none gives ``start[p]`` (``A``).  A scan position ``s`` whose
    first candidate at or after it is ``p`` starts its match at ``max(s,
    A)`` and goes on to ``next[s] = min(p + 4 + length, max(s, A) + 258)``;
    -1 where no candidate is left.  Returns those four int64 tensors over
    ``[0, mflimit)`` and ``cand_at`` (``p``, -1 for none)."""
    mflimit = max(size - MIN_MATCH + 1, 0)
    i64 = torch.int64
    padded = np.zeros(size + 16, np.uint8)
    padded[:size] = row[:size].numpy()
    words = np.lib.stride_tricks.sliding_window_view(padded, 8).copy().view("<u8")[:, 0]
    row = torch.cat([row[:size].to(i64), torch.zeros(1, dtype=i64)])
    pos = torch.arange(mflimit, dtype=i64)
    c4, c8 = cand[:mflimit].to(i64), cand8[:mflimit].to(i64)
    isc = (c4 >= 0) | (c8 >= 0)
    p4 = torch.where(c4 >= 0, c4, c8)
    p8 = torch.where(c8 >= 0, c8, p4)
    fcap = torch.where(isc, (size - (pos + MIN_MATCH)).clamp(max=MAX_MATCH - MIN_MATCH), 0)
    two = isc & (p8 != p4)
    a = (pos + MIN_MATCH).numpy()
    l4 = torch.from_numpy(_common_prefix(words, a, (p4 + MIN_MATCH).numpy(), fcap.numpy()))
    l8 = torch.from_numpy(_common_prefix(words, a, (p8 + MIN_MATCH).numpy(),
                                         torch.where(two, fcap, 0).numpy()))
    length = torch.where(two, torch.maximum(l4, l8), l4)
    src = torch.where(two & (l8 > l4), p8, p4)
    bk = torch.zeros_like(pos)
    live = isc.clone()
    k = 0
    while bool(live.any()):
        x, y = pos - 1 - k, src - 1 - k
        ok = live & (x >= 0) & (y >= 0)
        xs, ys = x.clamp(min=0), y.clamp(min=0)
        live = ok & (row[xs] == row[ys]) & ~isc[xs]
        bk += live.to(i64)
        k += 1
    start = pos - bk
    marked = torch.where(isc, pos, mflimit)
    nxt = torch.flip(torch.cummin(torch.flip(marked, [0]), 0).values, [0]) if mflimit else marked
    found = nxt < mflimit
    p = torch.where(found, nxt, 0)
    nexts = torch.minimum(p + MIN_MATCH + length[p], torch.maximum(pos, start[p]) + MAX_MATCH)
    return {"next": torch.where(found, nexts, -1), "cand_at": torch.where(found, nxt, -1),
            "start": start, "length": length, "src": src}


def path_plain(tok: dict, size: int) -> tuple[list, list, int]:
    """The chain of next tokens from position 0 and the token numbering, for
    one chunk: ``(matches, numbers, tokens)``, ``matches`` the walk's
    ``(anchor, start, length, distance)`` along the chain (as
    ``deflate_encode._walk`` gives them), ``numbers[j]`` the token number of
    match ``j`` (the literals and matches before it), ``tokens`` the chunk's
    token count (with the trailing literals)."""
    nxt = tok["next"].tolist()
    mflimit = len(nxt)
    matches, numbers = [], []
    s, lits = 0, 0
    while s < mflimit and nxt[s] >= 0:
        p = int(tok["cand_at"][s])
        start = max(s, int(tok["start"][p]))
        ml = min(p - start + MIN_MATCH + int(tok["length"][p]), MAX_MATCH)
        lits += start - s
        numbers.append(lits + len(matches))
        matches.append((s, start, ml, p - int(tok["src"][p])))
        s = nxt[s]
    end = matches[-1][1] + matches[-1][2] if matches else 0
    return matches, numbers, lits + len(matches) + size - end


def hist_from_path_plain(row: bytes, size: int, matches: list, n_dist: int,
                         eob: int) -> tuple[list, list]:
    """The hist kernels' counting phase for one chunk, from ``path_plain``'s
    ``matches`` (none for entropy-only coding): the bytes no match covers
    counted at their values, each match at ``257 + length symbol`` and at
    its distance symbol, EOB ``eob`` times at 256 -> ``(llh [288], dh
    [n_dist])``, as ``deflate_encode._hist_chunk`` (``n_dist`` 30, ``eob``
    1) and ``gdeflate_encode._hist_chunk`` (32, 0) count the walk's tokens."""
    covered = np.zeros(size, bool)
    llh, dh = np.zeros(288, np.int64), np.zeros(n_dist, np.int64)
    for _, start, ml, dist in matches:
        covered[start:start + ml] = True
        llh[257 + _len_sym(ml)[0]] += 1
        dh[_dist_sym(dist)[0]] += 1
    lits = np.frombuffer(row[:size], np.uint8)[~covered]
    llh[:256] += np.bincount(lits, minlength=256)
    llh[256] += eob
    return llh.tolist(), dh.tolist()
