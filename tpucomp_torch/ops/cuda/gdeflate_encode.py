"""Batched GDeflate encode: sort-matched candidates, the Hopper token parse,
the refill schedule and the tile assembly.

Port of :mod:`tpucomp.ops.pallas.gdeflate_encode` (``_kernel`` in its three
modes, ``_prep``, ``_schedule_and_assemble``, ``_dyn_tables_gd``,
``compress_batch``, ``compress_batch_dyn``).
:func:`tpucomp_torch.ops.match.candidates2` (64 KiB window) finds the match
candidates; ``csrc/gdeflate_encode.cu`` (its header says what it replaces,
what bounds it and how it is built) turns them into tokens in one of three
modes that see the same tokens:

* ``fixed`` — fixed-table codes (algo 0), :func:`fixed_kernel`;
* ``hist`` — litlen/distance symbol counts, :func:`hist_kernel`;
* ``emit`` — codes from the chunk's table of :func:`dyn_tables_gd` (torch
  ops), :func:`emit_kernel`;

``fixed`` and ``emit`` append token ``t``'s codes to lane ``t & 31``'s bit
buffer and record its four field bit counts.  :func:`schedule_and_assemble`
(torch ops over the batch) rebuilds the decoder's refill order from those
counts, interleaves the lane words in it and assembles the tiles, with the
stored fallback.  :func:`compress_batch` is algo 0; :func:`compress_batch_dyn`
is algo 1 (hist, tables, emit) and, with ``entropy_only``, algo 2 (no
matches).

Every mode parses a chunk in parallel, one CTA a chunk: the token that
follows a scan position depends on that position alone, so every position's
next token is computed at once (``lz_parse.next_tokens_plain`` is that
pass's plain version), the chain of next tokens from 0 is found (32 chases
from segment starts, joined by one lane) and its tokens numbered
(``lz_parse.path_plain`` follows it from 0).  ``hist`` then counts the
tokens' symbols in the counting phase it shares with Deflate's
(``lz_parse.hist_from_path_plain``; entropy only, a byte histogram with no
parse); ``fixed`` and ``emit`` code and pack the tokens into the lanes at
once (:func:`lanes_from_path_plain`; :func:`parse_lanes_plain` over a batch).
The plain versions of the whole modes (:func:`fixed_plain`,
:func:`emit_plain`, :func:`hist_plain`) run the serial walk in Python; the
CPU tests hold them against the reference and the parse pieces against the
walk, and ``chip_smoke.py`` holds the kernels against them.

Contract: ``data uint8[B, cap]`` plus ``sizes int32[B]`` (each in ``[0,
cap]``; values outside are clamped) -> ``(out uint8[B, out_cap], out_sizes
int32[B], statuses int32[B])``, tiles byte-identical to the reference's.  A
tile longer than ``out_cap`` gives ``ERROR_OUTPUT_BUFFER_TOO_SMALL``, size 0
and a zero row.  The kernels read at most a row's first 64 KiB (GDeflate's
largest chunk; ``batched.compress`` gives a larger chunk
``ERROR_CHUNK_SIZE_TOO_LARGE``).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from tpucomp_torch.chunk import wrap_i32
from tpucomp_torch.constants import Status
from tpucomp_torch.formats.deflate import (CL_ORDER, FIXED_LIT_LENS, MAX_BITS, assign_codes,
                                           assign_codes_np, huff_lengths, rev_bits)
from tpucomp_torch.formats.gdeflate import FIXED_GDIST_LENS, HDR, N_LANES, PAYLOAD
from tpucomp_torch.ops import match
from tpucomp_torch.ops.cuda import _build
from tpucomp_torch.ops.cuda.deflate_encode import (_FIXED_LIT, _dist_sym, _len_sym, _rev, _rows,
                                                   _walk)
from tpucomp_torch.ops.cuda.lz4_encode2 import _clamped_sizes

NT_CAP = 65536          # tokens a tile may have (all literals of 64 KiB)
WCAP = 832              # dwords a lane may hold; more overflows to a stored tile
DESC_WORDS = 96         # 384-byte table description cap
NTAB = 288 + 32
R4 = NT_CAP // N_LANES * 4   # field events a lane may see
# chunks :func:`schedule_and_assemble` takes at a time: it bounds each of its
# [rows, R4, 32] event grids to 128 MiB of int32
_SCHED_ROWS = 128


# --- the plain walks ---------------------------------------------------------------------

def _candidates(data: torch.Tensor, sizes: torch.Tensor, entropy_only: bool):
    """``match.candidates2`` over the 64 KiB window, or None for entropy-only
    coding (no matches at all, ``gdeflate_encode.py:378-381``)."""
    return None if entropy_only else match.candidates2(data, sizes)


def _hist_chunk(row: bytes, size: int, toks: list, tail: int) -> tuple[list, list]:
    llh, dh = [0] * 288, [0] * 32
    for a, nm2, ml, dist in toks:
        for v in row[a:nm2]:
            llh[v] += 1
        llh[257 + _len_sym(ml)[0]] += 1
        dh[_dist_sym(dist)[0]] += 1
    for v in row[tail:size]:
        llh[v] += 1
    return llh, dh


def _lanes_chunk(row: bytes, size: int, toks: list, tail: int, tab: list | None):
    """One chunk's lane words, field counts, lane dword counts and meta:
    fixed codes when ``tab`` is None, else ``tab``'s."""
    acc, nbits, cnt = [0] * N_LANES, [0] * N_LANES, [0] * N_LANES
    lw = [[0] * WCAP for _ in range(N_LANES)]
    nb16 = [0] * NT_CAP
    over = False
    t = 0
    lit = _FIXED_LIT if tab is None else [(e & 0xFFFF, e >> 16) for e in tab[:256]]

    def put(j: int, v: int, n: int) -> None:
        nonlocal over
        a, m = acc[j] | (v << nbits[j]), nbits[j] + n
        if m >= 32:
            if cnt[j] < WCAP:
                lw[j][cnt[j]] = a & 0xFFFFFFFF
            else:
                over = True
            cnt[j] += 1
            a >>= 32
            m -= 32
        acc[j], nbits[j] = a, m

    def rec(packed: int) -> None:
        nonlocal over
        if t < NT_CAP:
            nb16[t] = packed
        else:
            over = True

    def lits(a: int, b: int) -> None:
        nonlocal t
        for v in row[a:b]:
            code, n = lit[v]
            put(t & 31, code, n)
            rec(n)
            t += 1

    for a, nm2, ml, dist in toks:
        lits(a, nm2)
        li, e, ev = _len_sym(ml)
        dc, de, dv = _dist_sym(dist)
        if tab is None:
            lsym = 257 + li
            code, n1 = (lsym - 256, 7) if lsym < 280 else (0xC0 + lsym - 280, 8)
            code, n3, dcode = _rev(code, n1), 5, _rev(dc, 5)
        else:
            code, n1 = tab[257 + li] & 0xFFFF, tab[257 + li] >> 16
            dcode, n3 = tab[288 + dc] & 0xFFFF, tab[288 + dc] >> 16
        j = t & 31
        put(j, code, n1)
        put(j, ev, e)
        put(j, dcode, n3)
        put(j, dv, de)
        rec(n1 | (e << 4) | (n3 << 8) | (de << 12))
        t += 1
    lits(tail, size)
    dcnt = []
    for j in range(N_LANES):
        if nbits[j] > 0:
            if cnt[j] < WCAP:
                lw[j][cnt[j]] = acc[j] & 0xFFFFFFFF
            else:
                over = True
        dcnt.append(cnt[j] + (nbits[j] > 0))
    return lw, nb16, dcnt, [t, int(over), int(t > NT_CAP), 0]


def _lanes_plain(data, sizes, cands, tab):
    rows, szs, per = _rows(data, sizes, cands)
    tabs = tab.cpu().tolist() if tab is not None else None
    B = len(szs)
    lw = np.zeros((B, N_LANES, WCAP), np.uint32)
    nb16 = np.zeros((B, NT_CAP), np.uint16)
    dcnt = np.zeros((B, N_LANES), np.int32)
    meta = np.zeros((B, 4), np.int32)
    for i, (c4, c8, nx) in enumerate(per):
        row = rows[i].tobytes()
        toks, tail = _walk(row, szs[i], c4, c8, nx)
        w, n16, d, m = _lanes_chunk(row, szs[i], toks, tail, None if tabs is None else tabs[i])
        lw[i], nb16[i], dcnt[i], meta[i] = w, n16, d, m
    dev = data.device
    return (torch.from_numpy(lw.reshape(B, -1).view(np.int32)).to(dev),
            torch.from_numpy(nb16.view(np.int32)).to(dev),
            torch.from_numpy(dcnt).to(dev), torch.from_numpy(meta).to(dev))


def fixed_plain(data, sizes, cands):
    """Plain version of :func:`fixed_kernel`."""
    return _lanes_plain(data, sizes, cands, None)


def emit_plain(data, sizes, cands, tab):
    """Plain version of :func:`emit_kernel`."""
    return _lanes_plain(data, sizes, cands, tab)


def hist_plain(data, sizes, cands):
    """Plain version of :func:`hist_kernel`."""
    rows, szs, per = _rows(data, sizes, cands)
    llh, dh = [], []
    for i, (c4, c8, nx) in enumerate(per):
        row = rows[i].tobytes()
        toks, tail = _walk(row, szs[i], c4, c8, nx)
        lh, d = _hist_chunk(row, szs[i], toks, tail)
        llh.append(lh)
        dh.append(d)
    return (torch.tensor(llh, dtype=torch.int32, device=data.device).reshape(-1, 288),
            torch.tensor(dh, dtype=torch.int32, device=data.device).reshape(-1, 32))


# --- the parse's pieces, plain ------------------------------------------------------------
# The kernels do not walk: they compute every position's next token at
# once, follow the chain of next tokens from 0 (the plain versions of those
# passes are ops/cuda/lz_parse.py's, shared with Deflate's hist and emit),
# and count or code the tokens at once.

def lanes_from_path_plain(row: bytes, size: int, matches: list, numbers: list, tokens: int,
                          tab: list | None):
    """The parse kernel's emission for one chunk: each token's codes (fixed
    when ``tab`` is None) at its bit offset in lane ``t & 31``, the offsets
    a prefix sum of each lane's token bit counts -> ``(lw [32, WCAP] uint32,
    nb16 [NT_CAP] uint16, dcnt [32], meta [4])`` as :func:`fixed_plain` and
    :func:`emit_plain` give them."""
    kind = np.zeros(tokens, np.int64)          # byte value, or 256 + match index
    t_of = np.asarray(numbers, np.int64)
    kind[t_of] = 256 + np.arange(len(matches))
    lit = np.ones(tokens, bool)
    lit[t_of] = False
    covered = np.zeros(size + 1, bool)
    for _, start, ml, _ in matches:
        covered[start:start + ml] = True
    kind[lit] = np.frombuffer(row[:size], np.uint8)[~covered[:size]]
    if tab is None:
        lit_code = np.array([c for c, _ in _FIXED_LIT], np.int64)
        lit_n = np.array([n for _, n in _FIXED_LIT], np.int64)
    else:
        lit_code = np.array([e & 0xFFFF for e in tab[:256]], np.int64)
        lit_n = np.array([e >> 16 for e in tab[:256]], np.int64)
    val = np.zeros(tokens, np.int64)
    nbits = np.zeros(tokens, np.int64)
    packed = np.zeros(tokens, np.int64)
    v = kind[lit]
    val[lit], nbits[lit], packed[lit] = lit_code[v], lit_n[v], lit_n[v]
    for j, (_, _, ml, dist) in enumerate(matches):
        li, e, ev = _len_sym(ml)
        dc, de, dv = _dist_sym(dist)
        if tab is None:
            lsym = 257 + li
            code, n1 = (lsym - 256, 7) if lsym < 280 else (0xC0 + lsym - 280, 8)
            c1, c3, n3 = _rev(code, n1), _rev(dc, 5), 5
        else:
            c1, n1 = tab[257 + li] & 0xFFFF, tab[257 + li] >> 16
            c3, n3 = tab[288 + dc] & 0xFFFF, tab[288 + dc] >> 16
        t = numbers[j]
        val[t] = c1 | (ev << n1) | (c3 << (n1 + e)) | (dv << (n1 + e + n3))
        nbits[t] = n1 + e + n3 + de
        packed[t] = n1 | (e << 4) | (n3 << 8) | (de << 12)
    lane = np.arange(tokens) & (N_LANES - 1)
    off = np.zeros(tokens, np.int64)
    total = np.zeros(N_LANES, np.int64)
    for j in range(N_LANES):
        sel = lane == j
        cs = np.cumsum(nbits[sel])
        off[sel] = cs - nbits[sel]
        total[j] = cs[-1] if cs.size else 0
    words = np.zeros((N_LANES, WCAP + 3), np.uint64)
    k0, sh = off >> 5, (off & 31).astype(np.uint64)
    lo, hi = (val & 0xFFFFFFFF).astype(np.uint64), (val >> 32).astype(np.uint64)
    m32 = np.uint64(0xFFFFFFFF)
    parts = (((lo << sh) & m32), ((lo << sh) >> np.uint64(32)) | ((hi << sh) & m32),
             (hi << sh) >> np.uint64(32))
    dcnt = (total + 31) >> 5
    for i, part in enumerate(parts):
        k = k0 + i
        keep = (k < WCAP) & (k < dcnt[lane])
        np.bitwise_or.at(words, (lane[keep], k[keep]), part[keep])
    nb16 = np.zeros(NT_CAP, np.uint16)
    nb16[:min(tokens, NT_CAP)] = packed[:NT_CAP]
    meta = [tokens, int((dcnt > WCAP).any() or tokens > NT_CAP), int(tokens > NT_CAP), 0]
    return words[:, :WCAP].astype(np.uint32), nb16, dcnt.astype(np.int32), meta


def parse_lanes_plain(data, sizes, paths, tab):
    """:func:`lanes_from_path_plain` over a batch, from each row's
    :func:`path_plain` result -> ``(lw, nb16, dcnt, meta)``, as
    :func:`fixed_plain` (``tab`` None) or :func:`emit_plain` give them."""
    rows, szs, _ = _rows(data, sizes, None)
    tabs = tab.cpu().tolist() if tab is not None else None
    B = len(szs)
    lw = np.zeros((B, N_LANES, WCAP), np.uint32)
    nb16 = np.zeros((B, NT_CAP), np.uint16)
    dcnt = np.zeros((B, N_LANES), np.int32)
    meta = np.zeros((B, 4), np.int32)
    for i in range(B):
        lw[i], nb16[i], dcnt[i], meta[i] = lanes_from_path_plain(
            rows[i].tobytes(), szs[i], *paths[i], None if tabs is None else tabs[i])
    dev = data.device
    return (torch.from_numpy(lw.reshape(B, -1).view(np.int32)).to(dev),
            torch.from_numpy(nb16.view(np.int32)).to(dev),
            torch.from_numpy(dcnt).to(dev), torch.from_numpy(meta).to(dev))


# --- the refill schedule and the tiles (torch ops) -------------------------------------

def _le_bytes(v: torch.Tensor, n: int) -> torch.Tensor:
    """The low ``n`` little-endian bytes of int values ``v [B]`` -> ``[B, n]``."""
    return torch.stack([(v >> (8 * k)) & 0xFF for k in range(n)], dim=1)


def fixed_header(B: int, device) -> tuple:
    """Algo 0's ``(btype, desc_words, hdr_bytes)`` for
    :func:`schedule_and_assemble`: btype 1 (fixed tables), no description."""
    return (torch.ones(B, dtype=torch.int32, device=device),
            torch.zeros((B, DESC_WORDS), dtype=torch.int32, device=device),
            torch.zeros(B, dtype=torch.int32, device=device))


def schedule_and_assemble(lw, nb16, dcnt, meta, data, sizes, out_cap: int,
                          btype, desc_words, hdr_bytes):
    """The decode-order interleave, the tile bytes and the stored fallback
    (``gdeflate_encode.py:485-585,685-702``), torch ops over the batch on
    ``lw``'s device, ``_SCHED_ROWS`` chunks at a time.

    Lane ``j``'s exclusive bit prefix before each field event (round-major,
    field-major, from the packed counts) gives the dwords it holds before the
    event, ``d_ev = min((B + 63) >> 5, D_j)``; word ``w`` of lane ``j`` goes
    where its first event ``e_first = #{e: d_ev[e, j] <= w}`` falls, found by
    ``torch.searchsorted`` on the monotone columns.  One sort of the key
    ``e_first << 15 | j << 10 | w`` (invalid words last) orders the stream.
    A tile holds the 12-byte header (framing version 0, as the reference's
    encoder), the 32 u16 lane counts, ``hdr_bytes`` description bytes padded
    to 4 and the stream.  The stored tile is taken on a lane or token
    overflow, below 16 bytes, or when it is not longer.  Algo 0 passes
    :func:`fixed_header`.
    """
    i32, i64 = torch.int32, torch.int64
    B, cap = data.shape
    dev = data.device
    sizes = _clamped_sizes(data, sizes)
    out = torch.empty((B, out_cap), dtype=torch.uint8, device=dev)
    osz = torch.empty(B, dtype=i32, device=dev)
    stat = torch.empty(B, dtype=i32, device=dev)
    nwords = -(-out_cap // 4)
    k = torch.arange(nwords, device=dev)
    w_ids = torch.arange(WCAP, device=dev)
    key_lane = (torch.arange(N_LANES, device=dev)[:, None] << 10) | w_ids
    pos = torch.arange(out_cap, device=dev)
    for lo in range(0, B, _SCHED_ROWS):
        s = slice(lo, min(B, lo + _SCHED_ROWS))
        b = s.stop - s.start
        ntok, D, size = meta[s, 0], dcnt[s].to(i32), sizes[s]
        # field events [b, R4, 32] from the 4 x 4-bit counts of each token
        tw = nb16[s].contiguous().view(torch.int16).to(i32) & 0xFFFF
        tw = torch.where(torch.arange(NT_CAP, device=dev) < ntok[:, None], tw, 0)
        ev = torch.stack([(tw >> (4 * f)) & 0xF for f in range(4)], dim=2)
        ev = ev.reshape(b, NT_CAP // N_LANES, N_LANES, 4).transpose(2, 3).reshape(b, R4, N_LANES)
        before = torch.cumsum(ev, dim=1, dtype=i32) - ev
        d_ev = torch.minimum((before + 63) >> 5, D[:, None, :])
        e_first = torch.searchsorted(d_ev.transpose(1, 2).contiguous(),
                                     w_ids.expand(b, N_LANES, WCAP).contiguous(), right=True)
        efl = torch.where(w_ids < D[:, :, None], e_first, R4 + 1)
        key = ((efl << 15) | key_lane).reshape(b, -1)
        stream = torch.gather(lw[s], 1, torch.argsort(key, dim=1))

        head = torch.cat([btype[s, None], torch.zeros_like(btype[s, None]), _le_bytes(ntok, 4),
                          _le_bytes(size, 4), _le_bytes(hdr_bytes[s], 2),
                          torch.stack([D & 0xFF, (D >> 8) & 0xFF], dim=2).reshape(b, -1)],
                         dim=1).to(torch.uint8)
        src = torch.cat([head.view(i32), desc_words[s].to(i32), stream.to(i32)], dim=1)
        dws = (PAYLOAD + ((hdr_bytes[s] + 3) & ~3)) // 4
        total = 4 * dws + 4 * D.sum(dim=1, dtype=i32)
        idx = torch.where(k < PAYLOAD // 4, k, torch.where(k < dws[:, None], k,
                                                           PAYLOAD // 4 + DESC_WORDS
                                                           + k - dws[:, None]))
        tile = torch.gather(src, 1, idx.clamp(max=src.shape[1] - 1))
        tile = torch.where(4 * k < total[:, None], tile, 0)
        tile = tile.contiguous().view(torch.uint8)[:, :out_cap]

        stored = torch.zeros((b, max(out_cap, HDR + cap)), dtype=torch.uint8, device=dev)
        stored[:, 6:10] = _le_bytes(size, 4).to(torch.uint8)
        stored[:, HDR:HDR + cap] = torch.where(torch.arange(cap, device=dev) < size[:, None],
                                               data[s], 0)
        stored = stored[:, :out_cap]
        stot = HDR + size
        m = meta[s]
        use_stored = (m[:, 1] != 0) | (m[:, 2] != 0) | (size < 16) | (total >= stot)
        o = torch.where(use_stored, stot, total)
        too_big = o > out_cap
        o = torch.where(too_big, 0, o)
        res = torch.where(use_stored[:, None], stored, tile)
        out[s] = torch.where(pos < o[:, None], res, 0)
        osz[s] = o
        stat[s] = torch.where(too_big, int(Status.ERROR_OUTPUT_BUFFER_TOO_SMALL),
                              int(Status.SUCCESS))
    return out, osz, stat


# --- phase B: dynamic tables and the description (torch ops) ----------------------------

_FIXED_LC = assign_codes_np(FIXED_LIT_LENS, MAX_BITS)
_FIXED_DC = assign_codes_np(FIXED_GDIST_LENS, MAX_BITS)


def dyn_tables_gd(llh: torch.Tensor, dh: torch.Tensor):
    """Per-tile dynamic Huffman tables and the packed description from the
    exact histograms ``llh int32[B, 288]``, ``dh int32[B, 32]``
    (``gdeflate_encode.py:591-665``), on their device.

    Returns ``(tab int32[B, 320], desc_words int32[B, 96], hdr_bytes
    int32[B], use_dyn bool[B])``: ``tab[sym] = bit-reversed code | length <<
    16`` (litlen 0..287, distances at 288..319).  Dynamic codes are used when
    every length construction succeeds and the description plus the dynamic
    payload is shorter than the fixed payload; the description is then
    HLIT 29, HDIST 31, HCLEN 15, all 19 CL lengths in ``CL_ORDER`` and the
    318 CL-coded lengths (no run codes), LSB first.  A tile with no match
    codes distance symbol 0 once.
    """
    i32 = torch.int32
    dev = llh.device
    B = llh.shape[0]
    lit_freq = llh.to(i32)
    dist_freq = dh.to(i32).clone()
    dist_freq[:, 0] += (dh.sum(dim=1) == 0).to(i32)
    # the litlen and dist lengths in one call: a dist row padded with absent
    # symbols gives the unpadded row's lengths
    both = torch.zeros((2 * B, 286), dtype=i32, device=dev)
    both[:B] = lit_freq[:, :286]
    both[B:, :32] = dist_freq
    lens, ok = huff_lengths(both, MAX_BITS)
    dyn_ll = torch.nn.functional.pad(lens[:B], (0, 2))
    dyn_dl = lens[B:, :32]
    all_lens = torch.cat([dyn_ll[:, :286], dyn_dl], dim=1).clamp(0, 15)
    cl_freq = (all_lens[:, :, None] == torch.arange(19, dtype=i32, device=dev)).sum(
        dim=1, dtype=i32)
    cl_lens, ok_c = huff_lengths(cl_freq, 7)
    cl_codes = assign_codes(cl_lens, 7)
    use_dyn = ok[:B] & ok[B:] & ok_c

    fixed_ll = torch.from_numpy(FIXED_LIT_LENS).to(dev)
    fixed_dl = torch.from_numpy(FIXED_GDIST_LENS).to(dev)
    idx = all_lens.to(torch.int64)
    sym_bits = torch.gather(cl_lens, 1, idx)
    cl_hdr_bits = 14 + 19 * 3 + sym_bits.sum(dim=1, dtype=i32)
    pay_fixed = ((lit_freq * fixed_ll).sum(dim=1, dtype=i32)
                 + (dist_freq * fixed_dl).sum(dim=1, dtype=i32))
    pay_dyn = ((lit_freq * dyn_ll).sum(dim=1, dtype=i32)
               + (dist_freq * dyn_dl).sum(dim=1, dtype=i32))
    use_dyn = use_dyn & (cl_hdr_bits + pay_dyn < pay_fixed)

    u = use_dyn[:, None]
    ll = torch.where(u, dyn_ll, fixed_ll)
    dl = torch.where(u, dyn_dl, fixed_dl)
    lc = torch.where(u, assign_codes(dyn_ll, MAX_BITS), torch.from_numpy(_FIXED_LC).to(dev))
    dc = torch.where(u, assign_codes(dyn_dl, MAX_BITS), torch.from_numpy(_FIXED_DC).to(dev))
    tab = torch.cat([rev_bits(lc, ll) | (ll << 16), rev_bits(dc, dl) | (dl << 16)], dim=1)

    clo_val = cl_lens[:, torch.from_numpy(CL_ORDER).to(device=dev, dtype=torch.int64)]
    sym_val = rev_bits(torch.gather(cl_codes, 1, idx), sym_bits)
    vals = torch.cat([torch.tensor([29, 31, 15], dtype=i32, device=dev).expand(B, 3),
                      clo_val, sym_val], dim=1)
    bits = torch.cat([torch.tensor([5, 5, 4] + [3] * 19, dtype=i32, device=dev).expand(B, 22),
                      sym_bits], dim=1)
    bits = torch.where(u, bits, 0)
    ends = torch.cumsum(bits, dim=1, dtype=i32)
    off = (ends - bits).to(torch.int64)
    word, sh = off >> 5, off & 31
    v = vals.to(torch.int64)
    live = bits > 0
    part0 = torch.where(live, (v << sh) & 0xFFFFFFFF, 0)
    part1 = torch.where(live & (sh > 0), v >> (32 - sh), 0)
    words = torch.zeros((B, DESC_WORDS + 1), dtype=torch.int64, device=dev)
    words.scatter_add_(1, word.clamp(max=DESC_WORDS), part0)
    words.scatter_add_(1, (word + 1).clamp(max=DESC_WORDS), part1)
    desc_words = wrap_i32(words[:, :DESC_WORDS]).to(i32)
    hdr_bytes = torch.where(use_dyn, (ends[:, -1] + 7) >> 3, 0).to(i32)
    return tab.to(i32), desc_words, hdr_bytes, use_dyn


# --- the kernels ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int


def _inputs(data, sizes, cands) -> list:
    """The checked launch arguments the three modes share: data, sizes, the
    three candidate arrays (None for none), B, cap."""
    if data.device.type != "cuda":
        raise ValueError(f"the GDeflate encode kernel needs CUDA tensors, got {data.device}")
    if data.dtype != torch.uint8 or data.dim() != 2:
        raise ValueError(f"data must be uint8[B, cap], got {data.dtype}{list(data.shape)}")
    B, cap = data.shape
    for name, t in zip(("cand", "cand8", "nxt"), cands or ()):
        if t.shape != (B, cap) or t.dtype != torch.int32 or t.device != data.device:
            raise ValueError(f"{name} must be int32[{B}, {cap}] on {data.device}")
    cands = [t.contiguous() for t in cands] if cands is not None else [None] * 3
    return [data.contiguous(), _clamped_sizes(data, sizes).contiguous(), *cands, B, cap]


@functools.cache
def _entry(mode: str, n_more: int):
    """``tpucomp_gdeflate_encode_<mode>`` with its argument and result types
    (``n_more`` pointers after the common ones), resolved once a process."""
    fn = getattr(_build.load("gdeflate_encode"), f"tpucomp_gdeflate_encode_{mode}")
    fn.argtypes = [_P] * 5 + [_I, _I] + [_P] * n_more + [_P]
    fn.restype = _I
    return fn


def _call(mode: str, n_more: int, args: list, device) -> None:
    """Launch mode ``mode``; ``args`` holds the tensors (passed as pointers,
    None as null) and keeps them alive through the launch."""
    ptrs = [a.data_ptr() if torch.is_tensor(a) else a for a in args]
    with torch.cuda.device(device):
        rc = _entry(mode, n_more)(*ptrs, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gdeflate_encode ({mode}) kernel launch failed: cudaError {rc}")


def _lane_outputs(data):
    B, dev = data.shape[0], data.device
    return (torch.empty((B, N_LANES * WCAP), dtype=torch.int32, device=dev),
            torch.empty((B, NT_CAP // 2), dtype=torch.int32, device=dev),
            torch.empty((B, N_LANES), dtype=torch.int32, device=dev),
            torch.empty((B, 4), dtype=torch.int32, device=dev))


def fixed_kernel(data, sizes, cands):
    """Launch the ``fixed`` parse of ``csrc/gdeflate_encode.cu`` (algo 0) over
    ``cands`` (``match.candidates2``'s three tensors) on ``data``'s card, on
    the current stream -> ``(lw int32[B, 32 * 832], nb16 int32[B, 32768],
    dcnt int32[B, 32], meta int32[B, 4])``."""
    args = _inputs(data, sizes, cands)
    outs = _lane_outputs(data)
    _call("fixed", 4, args + list(outs), data.device)
    fixed_kernel.launches += 1
    return outs


def hist_kernel(data, sizes, cands):
    """Launch the ``hist`` kernel -> ``(llh int32[B, 288], dh int32[B, 32])``:
    the parse of each row's first 64 KiB and its symbol counts (no EOB), or
    with ``cands`` None the bytes' histogram.  A row past 64 KiB is counted
    over its first 64 KiB only (``batched.compress`` gives such a chunk
    ``ERROR_CHUNK_SIZE_TOO_LARGE``); :func:`hist_plain` walks it whole."""
    args = _inputs(data, sizes, cands)
    llh = torch.empty((data.shape[0], 288), dtype=torch.int32, device=data.device)
    dh = torch.empty((data.shape[0], 32), dtype=torch.int32, device=data.device)
    _call("hist", 2, args + [llh, dh], data.device)
    hist_kernel.launches += 1
    return llh, dh


def emit_kernel(data, sizes, cands, tab):
    """Launch the ``emit`` parse against :func:`dyn_tables_gd`'s ``tab``."""
    args = _inputs(data, sizes, cands)
    B, dev = data.shape[0], data.device
    if tab.shape != (B, NTAB) or tab.dtype != torch.int32 or tab.device != dev:
        raise ValueError(f"tab must be int32[{B}, {NTAB}] on {dev}")
    outs = _lane_outputs(data)
    _call("emit", 5, args + [tab.contiguous()] + list(outs), dev)
    emit_kernel.launches += 1
    return outs


fixed_kernel.launches = 0
hist_kernel.launches = 0
emit_kernel.launches = 0


# --- the batched entries -----------------------------------------------------------------

def _on_card(data: torch.Tensor) -> None:
    """Raise before ``candidates2`` runs on the host for a batch that is not
    on the card (the kernels' own check comes only after it)."""
    if data.device.type != "cuda":
        raise ValueError(f"the GDeflate encode kernels need CUDA tensors, got {data.device}")


def _compress(walk, data, sizes, out_cap):
    sizes = _clamped_sizes(data, sizes)
    lanes = walk(data, sizes, _candidates(data, sizes, False))
    return schedule_and_assemble(*lanes, data, sizes, out_cap,
                                 *fixed_header(data.shape[0], data.device))


def _compress_dyn(hist, emit, data, sizes, out_cap, entropy_only):
    sizes = _clamped_sizes(data, sizes)
    cands = _candidates(data, sizes, entropy_only)
    tab, desc, hdr_bytes, use_dyn = dyn_tables_gd(*hist(data, sizes, cands))
    lanes = emit(data, sizes, cands, tab)
    btype = torch.where(use_dyn, 2, 1).to(torch.int32)
    return schedule_and_assemble(*lanes, data, sizes, out_cap, btype, desc, hdr_bytes)


def compress_batch(data: torch.Tensor, sizes: torch.Tensor, out_cap: int):
    """Algo 0 on the card: the candidates, the ``fixed`` kernel, the schedule."""
    _on_card(data)
    return _compress(fixed_kernel, data, sizes, out_cap)


def compress_batch_plain(data: torch.Tensor, sizes: torch.Tensor, out_cap: int):
    """Plain version of :func:`compress_batch` (candidates and schedule on
    ``data``'s device, the walk in Python); tensors on ``data``'s device."""
    return _compress(fixed_plain, data, sizes, out_cap)


def compress_batch_dyn(data: torch.Tensor, sizes: torch.Tensor, out_cap: int,
                       entropy_only: bool = False):
    """Algos 1 and 2 on the card: candidates (none for ``entropy_only``), the
    ``hist`` kernel, :func:`dyn_tables_gd`, the ``emit`` kernel, the schedule."""
    _on_card(data)
    return _compress_dyn(hist_kernel, emit_kernel, data, sizes, out_cap, entropy_only)


def compress_batch_dyn_plain(data: torch.Tensor, sizes: torch.Tensor, out_cap: int,
                             entropy_only: bool = False):
    """Plain version of :func:`compress_batch_dyn`."""
    return _compress_dyn(hist_plain, emit_plain, data, sizes, out_cap, entropy_only)


def compress_algo(data: torch.Tensor, sizes: torch.Tensor, opts, out_cap: int,
                  plain: bool = False):
    """The reference's algo ladder (``tpucomp/ops/pallas/__init__.py:235-252``):
    ``opts.algo`` 0 fixed tables, 1 per-tile dynamic tables, 2 dynamic tables
    without matches.  ``plain`` runs the plain versions."""
    algo = getattr(opts, "algo", 0) if opts is not None else 0
    if algo in (1, 2):
        fn = compress_batch_dyn_plain if plain else compress_batch_dyn
        return fn(data, sizes, out_cap, entropy_only=algo == 2)
    return (compress_batch_plain if plain else compress_batch)(data, sizes, out_cap)
