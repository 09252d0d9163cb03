"""Batched raw Deflate encode: sort-matched candidates, then the Hopper kernels.

Port of :mod:`tpucomp.ops.pallas.deflate_encode` (``_kernel`` in its three
modes, ``_prep``, ``compress_batch``, ``_dyn_tables``, ``compress_batch_dyn``).
:func:`tpucomp_torch.ops.match.candidates2` (32 KiB window) finds the match
candidates; ``csrc/deflate_encode.cu`` (its header says what it replaces,
what bounds it and how it is built) turns them into tokens in one of three
modes that see the same tokens:

* ``fixed`` — one fixed-Huffman block (algo 0), :func:`fixed_kernel`;
* ``hist`` — litlen/dist symbol counts, :func:`hist_kernel`;
* ``emit`` — one block with the chunk's dynamic tables and the pre-packed
  header from :func:`dyn_tables` (torch ops), :func:`emit_kernel`;

and rewrites a stream longer than stored blocks as stored blocks.  All three
parse a chunk in parallel, one CTA a chunk, as GDeflate's kernels do
(``csrc/lz_parse.cuh``; plain pieces in :mod:`tpucomp_torch.ops.cuda.lz_parse`):
``hist`` then counts the tokens' symbols in the counting phase it shares with
GDeflate (``lz_parse.hist_from_path_plain`` is its plain version; entropy
only, a byte histogram with no parse), and ``emit`` and ``fixed``, one
kernel body in two modes, place every token's codes by one prefix sum of
their bit counts (:func:`stream_from_path_plain` is that emission's plain
version, with the chunk's table or the fixed codes).  All three read at
most a row's first 64 KiB (Deflate's largest chunk; ``batched.compress``
gives a larger chunk ``ERROR_CHUNK_SIZE_TOO_LARGE``).
:func:`compress_batch` is algo 0; :func:`compress_batch_dyn` is algo 1
(hist, tables, emit) and, with ``entropy_only``, algo 2 (no matches).  The
plain versions run the same walks in Python; the CPU tests hold them against
the reference and ``chip_smoke.py`` holds the kernels against them.

Contract: ``data uint8[B, cap]`` plus ``sizes int32[B]`` (each in ``[0,
cap]``; values outside are clamped) -> ``(out uint8[B, out_cap], out_sizes
int32[B], statuses int32[B])``, raw RFC 1951 frames byte-identical to the
reference's.  A frame longer than ``out_cap`` gives
``ERROR_OUTPUT_BUFFER_TOO_SMALL``, size 0 and a zero row.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpucomp_torch.chunk import wrap_i32
from tpucomp_torch.constants import Status
from tpucomp_torch.formats.deflate import (CL_ORDER, FIXED_DIST_LENS, FIXED_LIT_LENS,
                                           MAX_BITS, assign_codes, assign_codes_np,
                                           huff_lengths, rev_bits)
from tpucomp_torch.ops import match
from tpucomp_torch.ops.cuda import _build
from tpucomp_torch.ops.cuda.lz4_encode2 import _clamped_sizes, _match_len

MIN_MATCH = 4
MAX_MATCH = 258
WINDOW = 32768
HDR_WORDS = 80  # >= ceil((3 + 14 + 57 + 316 * 7) / 32) dynamic-header words
NTAB = 288 + 30


def _rev(v: int, n: int) -> int:
    return int(f"{v:0{n}b}"[::-1], 2) if n else 0


_FIXED_LIT = [(_rev(0x30 + v, 8), 8) if v < 144 else (_rev(0x190 + v - 144, 9), 9)
              for v in range(256)]
# the fixed codes as an emit table (bit-reversed code | length << 16; litlen
# 0..287, distances at 288..317) and the fixed block's 3-bit header 011
_FIXED_TAB = ([c | n << 16 for c, n in _FIXED_LIT]
              + [_rev(s - 256, 7) | 7 << 16 for s in range(256, 280)]
              + [_rev(0xC0 + s - 280, 8) | 8 << 16 for s in range(280, 288)]
              + [_rev(d, 5) | 5 << 16 for d in range(30)])
_FIXED_HDR = ([0b011], 3)


def _len_sym(ml: int) -> tuple[int, int, int]:
    """Match length -> (length symbol index 0..28, extra bits, extra value)."""
    m = ml - 3
    if m < 8:
        return m, 0, 0
    if ml == MAX_MATCH:
        return 28, 0, 0
    e = m.bit_length() - 3
    return ((e + 1) << 2) | ((m >> e) - 4), e, m & ((1 << e) - 1)


def _dist_sym(dist: int) -> tuple[int, int, int]:
    """Distance -> (distance symbol 0..29, extra bits, extra value)."""
    d = dist - 1
    if d < 4:
        return d, 0, 0
    e = d.bit_length() - 2
    return ((e + 1) << 1) | ((d >> e) - 2), e, d & ((1 << e) - 1)


def _walk(row: bytes, size: int, cand, cand8, nxt) -> tuple[list, int]:
    """The token-rate walk over one chunk -> ([(anchor, start, length,
    distance) for each match], the anchor of the trailing literals)."""
    toks = []
    mflimit = size - MIN_MATCH + 1
    anchor = scan = 0
    while nxt is not None and scan < mflimit:
        nm = nxt[scan]
        if nm >= mflimit:
            break
        p4 = cand[nm] if cand[nm] >= 0 else cand8[nm]
        p8 = cand8[nm] if cand8[nm] >= 0 else p4
        fcap = min(size - (nm + MIN_MATCH), MAX_MATCH - MIN_MATCH)
        l4 = _match_len(row, nm + MIN_MATCH, p4 + MIN_MATCH, fcap)
        l8 = _match_len(row, nm + MIN_MATCH, p8 + MIN_MATCH, fcap) if p8 != p4 else l4
        src = p8 if l8 > l4 else p4
        nm2, src2 = nm, src
        while nm2 > anchor and src2 > 0 and row[nm2 - 1] == row[src2 - 1]:
            nm2 -= 1
            src2 -= 1
        ml = min(nm - nm2 + MIN_MATCH + max(l4, l8), MAX_MATCH)
        toks.append((anchor, nm2, ml, nm - src))
        anchor = scan = nm2 + ml
    return toks, anchor


def _hist_chunk(row: bytes, size: int, toks: list, tail: int) -> tuple[list, list]:
    llh, dh = [0] * 288, [0] * 30
    for a, nm2, ml, dist in toks:
        for v in row[a:nm2]:
            llh[v] += 1
        llh[257 + _len_sym(ml)[0]] += 1
        dh[_dist_sym(dist)[0]] += 1
    for v in row[tail:size]:
        llh[v] += 1
    llh[256] += 1      # EOB
    return llh, dh


def _emit_chunk(row: bytes, size: int, toks: list, tail: int, tab: list | None,
                hdr: tuple[list, int] | None) -> bytearray:
    """One chunk's frame: fixed codes when ``tab`` is None, else ``tab``'s
    codes after the ``hdr`` bits; then the stored rewrite when shorter."""
    out = bytearray()
    acc = nb = 0

    def put(v: int, n: int) -> None:
        nonlocal acc, nb
        acc |= v << nb
        nb += n
        if nb >= 32:
            out.extend((acc & 0xFFFFFFFF).to_bytes(4, "little"))
            acc >>= 32
            nb -= 32

    if tab is None:
        lit = _FIXED_LIT
        put(0b011, 3)                                    # BFINAL=1, BTYPE=01
    else:
        lit = [(e & 0xFFFF, e >> 16) for e in tab[:256]]
        words, hn = hdr
        for i in range(0, hn, 16):
            n = min(hn - i, 16)
            put(((words[i >> 5] & 0xFFFFFFFF) >> (i & 31)) & ((1 << n) - 1), n)

    def put_match(ml: int, dist: int) -> None:
        li, e, ev = _len_sym(ml)
        di, de, dv = _dist_sym(dist)
        if tab is None:
            lsym = 257 + li
            code, n = (lsym - 256, 7) if lsym < 280 else (0xC0 + lsym - 280, 8)
            put(_rev(code, n), n)
            put(ev, e)
            put(_rev(di, 5), 5)
        else:
            ent, dent = tab[257 + li], tab[288 + di]
            put(ent & 0xFFFF, ent >> 16)
            put(ev, e)
            put(dent & 0xFFFF, dent >> 16)
        put(dv, de)

    for a, nm2, ml, dist in toks:
        for v in row[a:nm2]:
            put(*lit[v])
        put_match(ml, dist)
    for v in row[tail:size]:
        put(*lit[v])
    if tab is None:
        put(0, 7)                                        # EOB: symbol 256, code 0
    else:
        put(tab[256] & 0xFFFF, tab[256] >> 16)
    while nb > 0:                                        # whole bytes of the rest
        out.append(acc & 0xFF)
        acc >>= 8
        nb = max(nb - 8, 0)

    n_blocks = max((size + 65534) // 65535, 1)
    if size + 5 * n_blocks < len(out):                   # stored blocks are shorter
        return _stored(row, size)
    return out


def _stored(row: bytes, size: int) -> bytearray:
    """The stored-block rewrite: blocks of at most 65535 bytes, headers
    ``[last, n & 255, n >> 8, nlen & 255, nlen >> 8]``; size 0 gives one
    empty final block."""
    out = bytearray()
    src = 0
    while True:
        n = min(size - src, 65535)
        last = int(size - src == n)
        nlen = 0xFFFF - n
        out += bytes((last, n & 0xFF, n >> 8, nlen & 0xFF, nlen >> 8)) + row[src:src + n]
        src += n
        if src >= size:
            return out


def stream_from_path_plain(row: bytes, size: int, matches: list, numbers: list, tokens: int,
                           tab: list | None, hdr: tuple[list, int] | None) -> bytearray:
    """The emit kernel's frame of one chunk from its parse
    (``lz_parse.path_plain``'s ``matches``, ``numbers``, ``tokens``): every
    token's code bits (a literal's code, or a match's length code, length
    extra, distance code, distance extra), their offsets a prefix sum that
    starts after the ``hdr`` bits, the end-of-block code last; the byte
    count ``ceil(bits / 8)`` decides the stored-block rewrite before any
    bit is placed.  ``tab`` and ``hdr`` None: the fixed kernel's frame (the
    fixed codes after the header 011)."""
    if tab is None:
        tab, hdr = _FIXED_TAB, _FIXED_HDR
    words_h, hn = hdr
    t_of = np.asarray(numbers, np.int64)
    lit = np.ones(tokens, bool)
    lit[t_of] = False
    covered = np.zeros(size + 1, bool)
    for _, start, ml, _ in matches:
        covered[start:start + ml] = True
    code = np.array([e & 0xFFFF for e in tab[:256]], np.int64)
    width = np.array([e >> 16 for e in tab[:256]], np.int64)
    val = np.zeros(tokens, np.int64)
    nbits = np.zeros(tokens, np.int64)
    v = np.frombuffer(row[:size], np.uint8)[~covered[:size]].astype(np.int64)
    val[lit], nbits[lit] = code[v], width[v]
    for t, (_, _, ml, dist) in zip(numbers, matches):
        li, e, ev = _len_sym(ml)
        di, de, dv = _dist_sym(dist)
        c1, n1 = tab[257 + li] & 0xFFFF, tab[257 + li] >> 16
        c3, n3 = tab[288 + di] & 0xFFFF, tab[288 + di] >> 16
        val[t] = c1 | (ev << n1) | (c3 << (n1 + e)) | (dv << (n1 + e + n3))
        nbits[t] = n1 + e + n3 + de
    off = hn + np.cumsum(nbits) - nbits
    total = hn + int(nbits.sum()) + (tab[256] >> 16)
    nbytes = (total + 7) >> 3
    n_blocks = max((size + 65534) // 65535, 1)
    if size + 5 * n_blocks < nbytes:
        return _stored(row, size)
    words = np.zeros((total + 31) // 32 + 3, np.uint64)
    for i in range((hn + 31) // 32):
        words[i] = (words_h[i] & 0xFFFFFFFF) & ((1 << min(hn - 32 * i, 32)) - 1)
    val = np.append(val, tab[256] & 0xFFFF).astype(np.uint64)
    off = np.append(off, total - (tab[256] >> 16))
    k0, sh = off >> 5, (off & 31).astype(np.uint64)
    m32 = np.uint64(0xFFFFFFFF)
    lo, hi = val & m32, val >> np.uint64(32)
    for i, part in enumerate(((lo << sh) & m32, ((lo << sh) >> np.uint64(32)) | ((hi << sh) & m32),
                              (hi << sh) >> np.uint64(32))):
        np.bitwise_or.at(words, k0 + i, part)
    return bytearray(words.astype("<u4").tobytes()[:nbytes])


# --- candidates ------------------------------------------------------------------------

def _candidates(data: torch.Tensor, sizes: torch.Tensor, entropy_only: bool):
    """``match.candidates2`` over a 32 KiB window, or None for entropy-only
    coding (no matches at all, ``deflate_encode.py:465-477``)."""
    if entropy_only:
        return None
    return match.candidates2(data, sizes, window=WINDOW)


def _rows(data, sizes, cands):
    """Host copies for the plain walks: (rows, sizes, per-chunk candidates)."""
    rows = data.cpu().numpy()
    szs = sizes.cpu().tolist()
    if cands is None:
        per = [(None, None, None)] * len(szs)
    else:
        c4, c8, nx = (c.cpu().tolist() for c in cands)
        per = list(zip(c4, c8, nx))
    return rows, szs, per


def _frames(frames: list, out_cap: int, device):
    B = len(frames)
    out = np.zeros((B, out_cap), np.uint8)
    osz = np.zeros(B, np.int32)
    stat = np.zeros(B, np.int32)
    for i, f in enumerate(frames):
        if len(f) > out_cap:
            stat[i] = Status.ERROR_OUTPUT_BUFFER_TOO_SMALL
        else:
            out[i, :len(f)] = np.frombuffer(bytes(f), np.uint8)
            osz[i] = len(f)
    return (torch.from_numpy(out).to(device), torch.from_numpy(osz).to(device),
            torch.from_numpy(stat).to(device))


def fixed_plain(data, sizes, cands, out_cap: int):
    """Plain version of :func:`fixed_kernel`."""
    rows, szs, per = _rows(data, sizes, cands)
    frames = []
    for i, (c4, c8, nx) in enumerate(per):
        row = rows[i].tobytes()
        toks, tail = _walk(row, szs[i], c4, c8, nx)
        frames.append(_emit_chunk(row, szs[i], toks, tail, None, None))
    return _frames(frames, out_cap, data.device)


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
            torch.tensor(dh, dtype=torch.int32, device=data.device).reshape(-1, 30))


def emit_plain(data, sizes, cands, tab, hdr_words, hdr_bits, out_cap: int):
    """Plain version of :func:`emit_kernel`."""
    rows, szs, per = _rows(data, sizes, cands)
    tab, hw, hn = tab.cpu().tolist(), hdr_words.cpu().tolist(), hdr_bits.cpu().tolist()
    frames = []
    for i, (c4, c8, nx) in enumerate(per):
        row = rows[i].tobytes()
        toks, tail = _walk(row, szs[i], c4, c8, nx)
        frames.append(_emit_chunk(row, szs[i], toks, tail, tab[i], (hw[i], hn[i])))
    return _frames(frames, out_cap, data.device)


# --- phase B: dynamic tables and the packed header (torch ops) -------------------------

_FIXED_LC = assign_codes_np(FIXED_LIT_LENS, MAX_BITS)
_FIXED_DC = assign_codes_np(FIXED_DIST_LENS, MAX_BITS)


def dyn_tables(llh: torch.Tensor, dh: torch.Tensor):
    """Per-chunk dynamic Huffman tables and the packed block header from the
    exact histograms ``llh int32[B, 288]``, ``dh int32[B, 30]``
    (``deflate_encode.py:564-657``), on their device.

    Returns ``(tab int32[B, 318], hdr_words int32[B, 80], hdr_bits
    int32[B])``: ``tab[sym] = bit-reversed code | length << 16`` (litlen
    0..287, distances at 288..317), the header's bits LSB-first in the words.
    A chunk falls back to the fixed tables (a 3-bit header) when a length
    construction fails or dynamic coding does not pay.  All int32, as the
    reference (the header words are assembled in 64 bits and wrapped).
    """
    i32 = torch.int32
    dev = llh.device
    B = llh.shape[0]
    lit_freq = llh.to(i32)
    dist_freq = dh.to(i32).clone()
    dist_freq[:, 0] += (dh.sum(dim=1) == 0).to(i32)
    # the litlen and dist lengths in one call: a dist row padded with absent
    # symbols gives the unpadded row's lengths (an absent symbol never wins
    # a step, and ties go to the lower, real index)
    both = torch.zeros((2 * B, 286), dtype=i32, device=dev)
    both[:B] = lit_freq[:, :286]
    both[B:, :30] = dist_freq
    lens, ok = huff_lengths(both, MAX_BITS)
    dyn_ll = torch.nn.functional.pad(lens[:B], (0, 2))
    dyn_dl = torch.nn.functional.pad(lens[B:, :30], (0, 2))
    ok_l, ok_d = ok[:B], ok[B:]
    dyn_lc = assign_codes(dyn_ll, MAX_BITS)
    dyn_dc = assign_codes(dyn_dl, MAX_BITS)

    all_lens = torch.cat([dyn_ll[:, :286], dyn_dl[:, :30]], dim=1).clamp(0, 15)
    cl_freq = (all_lens[:, :, None] == torch.arange(19, dtype=i32, device=dev)).sum(
        dim=1, dtype=i32)
    cl_lens, ok_c = huff_lengths(cl_freq, 7)
    cl_codes = assign_codes(cl_lens, 7)
    use_dyn = ok_l & ok_d & ok_c

    fixed_ll = torch.from_numpy(FIXED_LIT_LENS).to(dev)
    fixed_lc = torch.from_numpy(_FIXED_LC).to(dev)
    fixed_dl = torch.from_numpy(FIXED_DIST_LENS).to(dev)
    fixed_dc = torch.from_numpy(_FIXED_DC).to(dev)

    idx = all_lens.to(torch.int64)
    sym_bits = torch.gather(cl_lens, 1, idx)
    cl_hdr_bits = 14 + 19 * 3 + sym_bits.sum(dim=1, dtype=i32)
    pay_fixed = ((lit_freq * fixed_ll).sum(dim=1, dtype=i32)
                 + (dist_freq * fixed_dl[:30]).sum(dim=1, dtype=i32))
    pay_dyn = ((lit_freq * dyn_ll).sum(dim=1, dtype=i32)
               + (dist_freq * dyn_dl[:, :30]).sum(dim=1, dtype=i32))
    use_dyn = use_dyn & (cl_hdr_bits + pay_dyn < pay_fixed)

    u = use_dyn[:, None]
    ll = torch.where(u, dyn_ll, fixed_ll)
    lc = torch.where(u, dyn_lc, fixed_lc)
    dl = torch.where(u, dyn_dl, fixed_dl)[:, :30]
    dc = torch.where(u, dyn_dc, fixed_dc)[:, :30]
    tab = torch.cat([rev_bits(lc, ll) | (ll << 16), rev_bits(dc, dl) | (dl << 16)], dim=1)

    # header fields: BFINAL+BTYPE, then (dynamic only) HLIT HDIST HCLEN, the
    # 19 CL lengths in CL_ORDER and the 316 CL-coded lengths
    hdr3 = torch.where(use_dyn, 0b101, 0b011).to(i32)[:, None]
    clo_val = cl_lens[:, torch.from_numpy(CL_ORDER).to(device=dev, dtype=torch.int64)]
    sym_val = rev_bits(torch.gather(cl_codes, 1, idx), sym_bits)
    fixed_fields = torch.tensor([29, 29, 15], dtype=i32, device=dev).expand(B, 3)
    vals = torch.cat([hdr3, fixed_fields, clo_val, sym_val], dim=1)
    head_bits = torch.tensor([3, 5, 5, 4] + [3] * 19, dtype=i32, device=dev).expand(B, 23)
    bits = torch.cat([head_bits, sym_bits], dim=1)
    bits = torch.where(u, bits, torch.nn.functional.pad(bits[:, :1], (0, bits.shape[1] - 1)))

    ends = torch.cumsum(bits, dim=1, dtype=i32)
    total = ends[:, -1]
    off = (ends - bits).to(torch.int64)
    word, sh = off >> 5, off & 31
    v = vals.to(torch.int64)
    live = bits > 0
    part0 = torch.where(live, (v << sh) & 0xFFFFFFFF, 0)
    part1 = torch.where(live & (sh > 0), v >> (32 - sh), 0)
    words = torch.zeros((B, HDR_WORDS + 1), dtype=torch.int64, device=dev)
    words.scatter_add_(1, word, part0).scatter_add_(1, word + 1, part1)
    hdr_words = wrap_i32(words[:, :HDR_WORDS]).to(i32)
    return tab.to(i32), hdr_words, total.to(i32)


# --- the kernels -------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int


def _inputs(data, sizes, cands) -> list:
    """The checked launch arguments the three modes share: data, sizes, the
    three candidate arrays (None for none), B, cap."""
    if data.device.type != "cuda":
        raise ValueError(f"the Deflate encode kernel needs CUDA tensors, got {data.device}")
    if data.dtype != torch.uint8 or data.dim() != 2:
        raise ValueError(f"data must be uint8[B, cap], got {data.dtype}{list(data.shape)}")
    B, cap = data.shape
    for name, t in zip(("cand", "cand8", "nxt"), cands or ()):
        if t.shape != (B, cap) or t.dtype != torch.int32 or t.device != data.device:
            raise ValueError(f"{name} must be int32[{B}, {cap}] on {data.device}")
    cands = [t.contiguous() for t in cands] if cands is not None else [None] * 3
    return [data.contiguous(), _clamped_sizes(data, sizes).contiguous(), *cands, B, cap]


def _int32(name: str, t: torch.Tensor, shape: tuple, device) -> torch.Tensor:
    if t.shape != shape or t.dtype != torch.int32 or t.device != device:
        raise ValueError(f"{name} must be int32{list(shape)} on {device}")
    return t.contiguous()


def _frame_outputs(data, out_cap: int):
    B, dev = data.shape[0], data.device
    return (torch.empty((B, out_cap), dtype=torch.uint8, device=dev),
            torch.empty((B,), dtype=torch.int32, device=dev),
            torch.empty((B,), dtype=torch.int32, device=dev))


def _call(mode: str, argtypes: list, args: list, device) -> None:
    """Launch mode ``mode``; ``args`` holds the tensors (passed as pointers,
    None as null) and keeps them alive through the launch."""
    fn = getattr(_build.load("deflate_encode"), f"tpucomp_deflate_encode_{mode}")
    fn.argtypes = [_P] * 5 + [_I, _I] + argtypes + [_P]
    fn.restype = _I
    ptrs = [a.data_ptr() if torch.is_tensor(a) else a for a in args]
    with torch.cuda.device(device):
        rc = fn(*ptrs, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"deflate_encode ({mode}) kernel launch failed: cudaError {rc}")


def fixed_kernel(data, sizes, cands, out_cap: int):
    """Launch ``csrc/deflate_encode.cu``'s ``fixed`` mode (algo 0) over
    ``cands`` (``match.candidates2``'s three tensors, or None for no
    matches) on ``data``'s card, on the current stream: the parse of each
    row's first 64 KiB and the fixed codes of its tokens."""
    args = _inputs(data, sizes, cands)
    out, osz, stat = _frame_outputs(data, out_cap)
    _call("fixed", [_P, _I, _P, _P],
          args + [out, out_cap, osz, stat], data.device)
    fixed_kernel.launches += 1
    return out, osz, stat


def hist_kernel(data, sizes, cands):
    """Launch the ``hist`` kernel -> ``(llh int32[B, 288], dh int32[B, 30])``:
    the parse of each row's first 64 KiB and its symbol counts (EOB once),
    or with ``cands`` None the bytes' histogram.  A row past 64 KiB is
    counted over its first 64 KiB only (``batched.compress`` gives such a
    chunk ``ERROR_CHUNK_SIZE_TOO_LARGE``); :func:`hist_plain` walks it whole."""
    args = _inputs(data, sizes, cands)
    llh = torch.empty((data.shape[0], 288), dtype=torch.int32, device=data.device)
    dh = torch.empty((data.shape[0], 30), dtype=torch.int32, device=data.device)
    _call("hist", [_P, _P], args + [llh, dh], data.device)
    hist_kernel.launches += 1
    return llh, dh


def emit_kernel(data, sizes, cands, tab, hdr_words, hdr_bits, out_cap: int):
    """Launch the ``emit`` kernel (the parse) against :func:`dyn_tables`' output."""
    args = _inputs(data, sizes, cands)
    B, dev = data.shape[0], data.device
    tables = [_int32("tab", tab, (B, NTAB), dev),
              _int32("hdr_words", hdr_words, (B, HDR_WORDS), dev),
              _int32("hdr_bits", hdr_bits, (B,), dev)]
    out, osz, stat = _frame_outputs(data, out_cap)
    _call("emit", [_P, _P, _P, _P, _I, _P, _P],
          args + tables + [out, out_cap, osz, stat], dev)
    emit_kernel.launches += 1
    return out, osz, stat


fixed_kernel.launches = 0
hist_kernel.launches = 0
emit_kernel.launches = 0


# --- the batched entries -----------------------------------------------------------------

def _on_card(data: torch.Tensor) -> None:
    if data.device.type != "cuda":
        raise ValueError(f"the Deflate encode kernels need CUDA tensors, got {data.device}")


def compress_batch(data: torch.Tensor, sizes: torch.Tensor, out_cap: int):
    """Algo 0: the candidates, then the ``fixed`` kernel, all on the card."""
    _on_card(data)
    sizes = _clamped_sizes(data, sizes)
    return fixed_kernel(data, sizes, _candidates(data, sizes, False), out_cap)


def compress_batch_plain(data: torch.Tensor, sizes: torch.Tensor, out_cap: int):
    """Plain version of :func:`compress_batch` (candidates on ``data``'s
    device, the walk in Python); tensors on ``data``'s device."""
    sizes = _clamped_sizes(data, sizes)
    return fixed_plain(data, sizes, _candidates(data, sizes, False), out_cap)


def compress_batch_dyn(data: torch.Tensor, sizes: torch.Tensor, out_cap: int,
                       entropy_only: bool = False):
    """Algos 1 and 2 on the card: candidates (none for ``entropy_only``), the
    ``hist`` kernel, :func:`dyn_tables`, the ``emit`` kernel."""
    _on_card(data)
    sizes = _clamped_sizes(data, sizes)
    cands = _candidates(data, sizes, entropy_only)
    llh, dh = hist_kernel(data, sizes, cands)
    tab, hdr_words, hdr_bits = dyn_tables(llh, dh)
    return emit_kernel(data, sizes, cands, tab, hdr_words, hdr_bits, out_cap)


def compress_batch_dyn_plain(data: torch.Tensor, sizes: torch.Tensor, out_cap: int,
                             entropy_only: bool = False):
    """Plain version of :func:`compress_batch_dyn`."""
    sizes = _clamped_sizes(data, sizes)
    cands = _candidates(data, sizes, entropy_only)
    llh, dh = hist_plain(data, sizes, cands)
    tab, hdr_words, hdr_bits = dyn_tables(llh, dh)
    return emit_plain(data, sizes, cands, tab, hdr_words, hdr_bits, out_cap)


def compress_algo(data: torch.Tensor, sizes: torch.Tensor, opts, out_cap: int,
                  plain: bool = False):
    """The reference's algo ladder (``tpucomp/ops/pallas/__init__.py:214-232``):
    ``opts.algo`` 0 fixed codes, 1 dynamic codes (hist, tables, emit), 2
    dynamic codes without matches.  ``plain`` runs the plain
    versions."""
    algo = getattr(opts, "algo", 0) if opts is not None else 0
    if algo in (1, 2):
        fn = compress_batch_dyn_plain if plain else compress_batch_dyn
        return fn(data, sizes, out_cap, entropy_only=algo == 2)
    return (compress_batch_plain if plain else compress_batch)(data, sizes, out_cap)
