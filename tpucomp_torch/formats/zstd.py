"""Zstandard (RFC 8878) frames: code tables, options, size bound, the size
read, the tables of the kernel encoder, and the reference's multi-block
encoder.

Port of :mod:`tpucomp.formats.zstd` but its XLA decoder
(``tpucomp/formats/zstd.py:42-360,1086-1907``).  The decoder runs in the
Hopper kernel of :mod:`tpucomp_torch.ops.cuda.zstd_decode`, the encoder of
chunks up to 64 KiB in that of :mod:`tpucomp_torch.ops.cuda.zstd_encode`
(each with its plain version).  That encoder's tables are built here, in
torch ops batched over a leading chunk dimension: the custom FSE tables of
the sequence codes (:func:`normalize_counts`, :func:`fse_build`,
:func:`fse_enc`, :func:`serialize_ncount`, :func:`seq_table`) and the
literal Huffman table with its tree description (:func:`huf_tree`).  They
give the reference's table words exactly: its stable sorts are
``stable=True`` argsorts, its first-index ``argmax`` a masked minimum of
indices, and its masked scatters go to the dump slots of
:mod:`tpucomp_torch.ops.parallel_lz`.

:func:`compress_batch` is the reference's XLA encoder (``encode_chunk``,
``_encode_block_body``, ``_huf_literals``, ``_encode_store``), which its
dispatch runs for chunks above 64 KiB, in torch ops on the batch's device:
frames byte-identical to the reference's, up to 16 MiB chunks.  Not ported
yet: the XLA decoder (``decode_chunk``, ``decompress_batch``; ROADMAP A.6).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from tpucomp_torch.chunk import wrap_i32
from tpucomp_torch.constants import Status
from tpucomp_torch.formats.deflate import _first_argmax, huff_lengths
from tpucomp_torch.ops.parallel_lz import (DUMP_SLOTS, dump_spread, prefix_run_length,
                                            wyllie_path)

MAGIC = 0xFD2FB528
MAX_ACC_LOG = 9           # LL/ML max 9, OF max 8
FSE_CAP = 1 << MAX_ACC_LOG
HUF_MAX_BITS = 11
TREE_CAP = 176            # direct <= 65 B; FSE-compressed weights <= 128 B (header included)

# --- sequence code tables (RFC 8878 3.1.1.3.2.1) -------------------------------------

LL_BITS = np.array([0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11,
                    12, 13, 14, 15, 16], np.int32)
LL_BASE = np.array(list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64,
                    128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536],
                   np.int32)
ML_BITS = np.array([0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10,
                    11, 12, 13, 14, 15, 16], np.int32)
ML_BASE = np.array(list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67,
                    83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387,
                    32771, 65539], np.int32)

LL_DEFAULT = np.array([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                       2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1,
                       -1], np.int32)
ML_DEFAULT = np.array([1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                       1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                       1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1,
                       -1], np.int32)
OF_DEFAULT = np.array([1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                       1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1], np.int32)
LL_DEFAULT_ACC, ML_DEFAULT_ACC, OF_DEFAULT_ACC = 6, 6, 5


# --- the predefined FSE tables, decode and encode side (numpy, at import) -----------

def _fse_build_np(norm: np.ndarray, acc_log: int) -> np.ndarray:
    """Decode table as ``int32[FSE_CAP]`` packed ``symbol | nbits << 8 |
    baseline << 16`` (RFC 8878 4.1.1's spread and state assignment)."""
    size = 1 << acc_log
    table_sym = np.zeros(size, np.int32)
    high = size - 1
    for s, p in enumerate(norm):          # "less than 1" symbols: one slot each at the end
        if p == -1:
            table_sym[high] = s
            high -= 1
    pos = 0
    step = (size >> 1) + (size >> 3) + 3
    for s, p in enumerate(norm):
        for _ in range(max(int(p), 0)):
            table_sym[pos] = s
            pos = (pos + step) & (size - 1)
            while pos > high:
                pos = (pos + step) & (size - 1)
    sym_next = np.array([1 if p == -1 else max(int(p), 0) for p in norm], np.int64)
    packed = np.zeros(FSE_CAP, np.int32)
    for i in range(size):
        s = table_sym[i]
        x = sym_next[s]
        sym_next[s] += 1
        nbits = acc_log - (int(x).bit_length() - 1)
        base = (int(x) << nbits) - size
        packed[i] = s | (nbits << 8) | (base << 16)
    return packed


LL_DEFAULT_TABLE = _fse_build_np(LL_DEFAULT, LL_DEFAULT_ACC)
ML_DEFAULT_TABLE = _fse_build_np(ML_DEFAULT, ML_DEFAULT_ACC)
OF_DEFAULT_TABLE = _fse_build_np(OF_DEFAULT, OF_DEFAULT_ACC)


def _fse_enc_np(packed: np.ndarray, acc: int, n_sym: int):
    """Encode-side lookup from a decode table: for (symbol s, next state x),
    the slot y with sym(y) == s and x in [base_y, base_y + 2^nb_y).

    Returns ``(state_tab[n_sym, 2^acc] = y, nb_tab, base_tab, first_slot[n_sym])``.
    """
    size = 1 << acc
    state_tab = np.zeros((n_sym, size), np.int32)
    nb_tab = np.zeros((n_sym, size), np.int32)
    base_tab = np.zeros((n_sym, size), np.int32)
    first = np.full(n_sym, -1, np.int32)
    for y in range(size):
        e = int(packed[y])
        sym, nb, base = e & 0xFF, (e >> 8) & 0xFF, (e >> 16) & 0xFFFF
        if sym >= n_sym:
            continue
        if first[sym] < 0:
            first[sym] = y
        for x in range(base, base + (1 << nb)):
            state_tab[sym, x] = y
            nb_tab[sym, x] = nb
            base_tab[sym, x] = base
    return state_tab, nb_tab, base_tab, first


LL_ENC = _fse_enc_np(LL_DEFAULT_TABLE, LL_DEFAULT_ACC, 36)
ML_ENC = _fse_enc_np(ML_DEFAULT_TABLE, ML_DEFAULT_ACC, 53)
OF_ENC = _fse_enc_np(OF_DEFAULT_TABLE, OF_DEFAULT_ACC, 29)


@dataclasses.dataclass(frozen=True)
class ZstdOpts:
    """Analog of the empty ``nvcompBatchedZstdOpts_t``."""


DEFAULT_OPTS = ZstdOpts()


def max_compressed_chunk_size(max_chunk_bytes: int, opts: ZstdOpts = DEFAULT_OPTS) -> int:
    """The reference's bound: frame header, a 3-byte header per block of at
    most 128 KiB plus one, the data and a margin, rounded up to 1024."""
    nblocks = max(1, -(-max_chunk_bytes // (1 << 17)))
    n = 8 + 3 * (nblocks + 1) + max_chunk_bytes + 32
    return (n + 1023) & ~1023


def get_decompress_size(comp: torch.Tensor, comp_sizes: torch.Tensor) -> torch.Tensor:
    """Frame_Content_Size of each frame (``GetDecompressSizeAsync`` analog).

    ``comp uint8[B, cap]`` + ``comp_sizes int32[B]`` -> ``int32[B]``, on
    ``comp``'s device.  As the reference: byte indices clipped to the row;
    the field follows the window byte (absent for single-segment frames) and
    the dictionary ID; an 8-byte field reads its low 4 bytes, a 2-byte field
    adds 256, a missing field reads -1; the value wraps to int32; a chunk
    below 6 bytes or without the magic reads 0.
    """
    B, cap = comp.shape
    dev = comp.device

    def gb(o):
        idx = o.to(torch.int64).clamp(0, cap - 1)[:, None]
        return torch.gather(comp, 1, idx)[:, 0].to(torch.int64)

    zero = torch.zeros(B, dtype=torch.int64, device=dev)
    magic = gb(zero) | (gb(zero + 1) << 8) | (gb(zero + 2) << 16) | (gb(zero + 3) << 24)
    fhd = gb(zero + 4)
    fcs_flag = fhd >> 6
    single_seg = (fhd >> 5) & 1
    did = fhd & 3
    o = 5 + torch.where(single_seg == 1, 0, 1)
    o = o + torch.where(did == 0, 0, torch.where(did == 1, 1, torch.where(did == 2, 2, 4)))
    fcs1 = gb(o)
    fcs2 = fcs1 | (gb(o + 1) << 8)
    fcs4 = fcs2 | (gb(o + 2) << 16) | (gb(o + 3) << 24)
    fcs = torch.where(fcs_flag == 0, torch.where(single_seg == 1, fcs1, -1),
                      torch.where(fcs_flag == 1, fcs2 + 256, fcs4))
    sizes = comp_sizes.to(device=dev, dtype=torch.int64)
    ok = (sizes >= 6) & (magic == MAGIC)
    return torch.where(ok, wrap_i32(fcs), 0).to(torch.int32)


# =====================================================================================
# the encoder's tables, in torch ops over a leading chunk dimension B
# =====================================================================================

def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, device=like.device, dtype=torch.int64)


def _bitlen(x: torch.Tensor, cap: int) -> torch.Tensor:
    """``min(bit length of x, cap)``, 0 for ``x <= 0``: the count of ``k <
    cap`` with ``(x >> k) > 0``, as the reference's unrolled loops count it
    (exact below 2^53)."""
    e = torch.frexp(x.to(torch.float64)).exponent.to(torch.int64)
    return torch.where(x > 0, e.clamp(max=cap), 0)


def _excl_cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, dim=-1) - x


def normalize_counts(freq: torch.Tensor, size: int):
    """Symbol counts ``int[B, max_sym]`` -> an FSE distribution of ``size``
    slots (``tpucomp/formats/zstd.py:243-282``): ``(norm int64[B, max_sym],
    nsym int64[B], ok bool[B])``.

    Present symbols get ``norm >= 1``; absent symbols below ``nsym`` get -1
    (one slot each), so the description needs no zero-repeat flags.
    Largest-remainder rounding (ties to the lower symbol), then four rounds
    of exact-sum correction on the first largest entry.
    """
    B, max_sym = freq.shape
    freq = freq.to(torch.int64)
    ids = _arange(max_sym, freq)
    present = freq > 0
    nsym = torch.where(present, ids, -1).max(dim=1).values + 1
    below = ids < nsym[:, None]
    absent = below & ~present
    target = (size - absent.sum(dim=1)).clamp(min=0)
    total = freq.sum(dim=1).clamp(min=1)

    scaled = freq * target[:, None]
    base = scaled // total[:, None]
    rem = scaled - base * total[:, None]
    base = torch.where(present & (base == 0), 1, base)
    budget = target - torch.where(present, base, 0).sum(dim=1)
    order = torch.argsort(torch.where(present, -rem, 1 << 40), dim=1, stable=True)
    bonus = torch.zeros_like(base).scatter_(1, order, (ids[None] < budget[:, None]).to(torch.int64))
    norm = base + torch.where(present, bonus, 0)
    rows = _arange(B, freq)
    for _ in range(4):
        resid = target - torch.where(present, norm, 0).sum(dim=1)
        top = _first_argmax(torch.where(present, norm, 0))
        delta = torch.maximum(resid, 1 - norm[rows, top])
        norm = norm.index_put((rows, top), norm[rows, top] + delta)
        norm = torch.where(present, norm, 0)
    norm = torch.where(absent, -1, torch.where(present, norm, 0))
    ok = torch.where(below, norm.abs(), 0).sum(dim=1) == size
    ok &= nsym >= 2                    # degenerate alphabets use RLE or the predefined tables
    ok &= torch.where(present, norm, 1).min(dim=1).values >= 1
    return norm, nsym, ok


def fse_build(norm: torch.Tensor, nsym: torch.Tensor, acc_log: int):
    """FSE decode tables from ``norm int[B, max_sym]`` (-1 for less than one,
    0 at and past ``nsym``) -> ``(packed int64[B, FSE_CAP] = symbol | nbits
    << 8 | baseline << 16, ok bool[B])`` (``tpucomp/formats/zstd.py:163-229``).

    The spread walk ``pos_{k+1} = (pos_k + step) mod size`` visits
    ``(k * step) mod size``; skipping the low-probability tail is a filter
    over that permutation, and the k-th assigned symbol is a search over the
    counts' prefix sums.
    """
    B, max_sym = norm.shape
    norm = norm.to(torch.int64)
    nsym = nsym.to(torch.int64)
    size = 1 << acc_log
    ks = _arange(FSE_CAP, norm)
    sym_ids = _arange(max_sym, norm)
    active = sym_ids[None] < nsym[:, None]
    is_m1 = (norm == -1) & active
    high = size - 1 - is_m1.sum(dim=1)
    pos_counts = torch.where(active, norm.clamp(min=0), 0)
    cum_counts = torch.cumsum(pos_counts, dim=1)
    total_pos = cum_counts[:, -1]

    # -1 symbols take the tail slots in symbol order, from the top down; the
    # extra column FSE_CAP takes every write aimed nowhere and is cut off
    m1_rank = torch.cumsum(is_m1.to(torch.int64), dim=1) - 1
    at = torch.where(is_m1, size - 1 - m1_rank, FSE_CAP).clamp(0, FSE_CAP)
    m1_sym_at = torch.zeros((B, FSE_CAP + 1), dtype=torch.int64, device=norm.device)
    m1_sym_at.scatter_(1, at, sym_ids.expand(B, max_sym).contiguous())

    step = (size >> 1) + (size >> 3) + 3
    perm = (ks * step) & (size - 1)
    keep = (ks < size)[None] & (perm[None] <= high[:, None])
    k_of_j = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    sym_of_k = torch.searchsorted(cum_counts, k_of_j.clamp(0, size - 1).contiguous(),
                                  right=True).clamp(0, max_sym - 1)
    assigned = keep & (k_of_j < total_pos[:, None])
    table_sym = torch.zeros((B, FSE_CAP + 1), dtype=torch.int64, device=norm.device)
    table_sym.scatter_(1, torch.where(assigned, perm[None], FSE_CAP), sym_of_k)
    table_sym = torch.where(_arange(FSE_CAP + 1, norm)[None] > high[:, None], m1_sym_at,
                            table_sym)[:, :FSE_CAP]

    # per-slot nbits / baseline: the slot's rank within its symbol, in slot order
    valid_slot = (ks < size)[None]
    key = torch.where(valid_slot, table_sym, max_sym) * FSE_CAP + ks[None]
    order = torch.argsort(key, dim=1, stable=True)
    sym_sorted = torch.gather(table_sym, 1, order)
    same = torch.nn.functional.pad(sym_sorted[:, 1:] == sym_sorted[:, :-1], (1, 0))
    rank = torch.empty_like(order).scatter_(1, order, prefix_run_length(same))
    start = torch.where(is_m1, 1, pos_counts)
    x = torch.gather(start, 1, table_sym.clamp(0, max_sym - 1)) + rank
    nbits = (acc_log - (_bitlen(x, MAX_ACC_LOG + 2) - 1)).clamp(0, 31)
    base = (x << nbits) - size
    packed = table_sym | (nbits << 8) | (base.clamp(0, (1 << 15) - 1) << 16)
    packed = torch.where(valid_slot, packed, 0)
    ok = torch.where(active, norm.abs(), 0).sum(dim=1) == size
    return packed, ok


def fse_enc(norm: torch.Tensor, nsym: torch.Tensor, acc_log: int):
    """Encode tables from a distribution (``tpucomp/formats/zstd.py:285-325``)
    -> ``(st, nb, bs int64[B, max_sym, 2^acc_log], first int64[B, max_sym],
    ok bool[B])``, indexed by (symbol, next decode state) as
    :func:`_fse_enc_np`'s, plus each symbol's initial slot."""
    B, max_sym = norm.shape
    size = 1 << acc_log
    norm = norm.to(torch.int64)
    packed, ok = fse_build(torch.nn.functional.pad(norm, (0, 64 - max_sym)), nsym, acc_log)
    sym_slot = packed[:, :size] & 0xFF

    # slot_of[s, r]: the rank-r slot of symbol s, in ascending slot order
    ks = _arange(size, norm)
    order = torch.argsort(sym_slot * size + ks[None], dim=1, stable=True)
    sym_sorted = torch.gather(sym_slot, 1, order)
    same = torch.nn.functional.pad(sym_sorted[:, 1:] == sym_sorted[:, :-1], (1, 0))
    at = (sym_sorted * size + prefix_run_length(same)).clamp(0, max_sym * size - 1)
    slot_of = torch.zeros((B, max_sym * size), dtype=torch.int64, device=norm.device)
    slot_of.scatter_(1, at, order)

    counts = torch.where(norm == -1, 1, norm.clamp(min=0))
    c = counts.clamp(min=1)[:, :, None]
    xp = ks[None, None]
    nbA = (acc_log - (_bitlen(c, acc_log + 1) - 1)).clamp(0, 31)
    xA = (xp + size) >> nbA
    okA = (xA >= c) & (xA < 2 * c)
    nb = torch.where(okA, nbA, nbA - 1).clamp(0, 31)
    xv = (xp + size) >> nb
    r = (xv - c).clamp(0, size - 1)
    srow = _arange(max_sym, norm)[None, :, None]
    st = torch.gather(slot_of, 1, (srow * size + r).clamp(0, max_sym * size - 1)
                      .reshape(B, -1)).reshape(B, max_sym, size)
    bs = (xv << nb) - size
    first = slot_of[:, ::size]
    return st, nb, bs, first, ok


def serialize_ncount(norm: torch.Tensor, nsym: torch.Tensor, acc_log: int):
    """An FSE table description (RFC 8878 4.1.1; ``tpucomp/formats/zstd.py:
    328-359``) -> ``(vals int64[B, 1 + max_sym], bits int64[B, 1 + max_sym],
    total_bits int64[B])``: the accuracy field, then one variable-width field
    per symbol while the remaining probability exceeds 1.

    The reference walks the symbols in order; the remaining probability only
    falls (every step takes at least 0), so the walk is a prefix sum and the
    fields are computed all at once.
    """
    B, max_sym = norm.shape
    norm = norm.to(torch.int64)
    size = 1 << acc_log
    active = _arange(max_sym, norm)[None] < nsym.to(torch.int64)[:, None]
    cnt = torch.where(norm < 0, 0, norm + 1)
    dec = torch.where(active, torch.where(cnt == 0, 1, cnt - 1), 0)
    rem = size + 1 - _excl_cumsum(dec)
    emit = active & (rem > 1)
    nbb = _bitlen(rem, MAX_ACC_LOG + 2)
    thr = torch.ones_like(nbb) << (nbb - 1).clamp(0, 15)
    mx = (2 * thr - 1) - rem
    small = cnt < mx
    v = torch.where(small, cnt, torch.where(cnt < thr, cnt, cnt + mx))
    w = torch.where(small, nbb - 1, nbb)
    head = torch.full((B, 1), acc_log - 5, dtype=torch.int64, device=norm.device)
    vals = torch.cat([head, torch.where(emit, v, 0)], dim=1)
    bits = torch.cat([torch.full_like(head, 4), torch.where(emit, w, 0)], dim=1)
    return vals, bits, bits.sum(dim=1)


WTREE_CAP = 160


def _wchain(wst, wfirst, wseq, wvalid):
    """The two interleaved FSE chains of the compressed Huffman weights
    (``wchain`` at ``tpucomp/formats/zstd.py:1243-1261``), both at once.

    ``wseq``/``wvalid [B, 2, 128]`` hold the even and the odd positions.  Each
    chain is walked backward from its last valid position, whose state is the
    symbol's first slot; every earlier valid position takes a transition.
    Returns the final states ``[B, 2]`` and the state carried into each
    position ``[B, 2, 128]`` (0 until the chain starts).

    The reference's scan is 128 steps of one table lookup each; here a step
    is one gather from an extended table: rows 0-12 the symbols' transitions,
    row 13 the identity (invalid positions keep the state), rows 14-26 the
    symbols' first slots in every column (a chain's last position, where the
    state is still 0).
    """
    B = wst.shape[0]
    dev = wst.device
    ident = _arange(64, wst).expand(B, 1, 64)
    firsts = wfirst[:, :, None].expand(B, 13, 64)
    ext = torch.cat([wst, ident, firsts], dim=1).reshape(B, 1, -1).expand(B, 2, -1)
    nxt_valid = torch.nn.functional.pad(wvalid[..., 1:], (0, 1))
    row = torch.where(~wvalid, 13, torch.where(nxt_valid, wseq, 14 + wseq)) * 64
    s = torch.zeros((B, 2, 1), dtype=torch.int64, device=dev)
    carried = [None] * 128
    for p in range(127, -1, -1):
        carried[p] = s
        s = torch.gather(ext, 2, row[..., p:p + 1] + s)
    return s[..., 0], torch.cat(carried, dim=2)


def huf_tree(freq: torch.Tensor):
    """Canonical zstd Huffman table and serialized tree description from
    ``freq int[B, 256]`` (``tpucomp/formats/zstd.py:1177-1314``).

    Returns ``(codes int32[B, 256], nb int32[B, 256], tree uint8[B,
    TREE_CAP], tree_bytes int32[B], ok bool[B])``: ``tree`` is the header
    byte plus direct 4-bit weights or FSE-compressed weights (two
    interleaved chains), whichever is smaller or applicable.
    """
    B = freq.shape[0]
    lens, ok = huff_lengths(freq, HUF_MAX_BITS)
    lens = lens.to(torch.int64)
    ids = _arange(256, lens)
    present = lens > 0
    max_bits = lens.max(dim=1).values[:, None]
    max_sym = torch.where(present, ids, -1).max(dim=1).values
    weights = torch.where(present, max_bits + 1 - lens, 0)
    ok = ok & (present.sum(dim=1) >= 2)
    direct_ok = max_sym <= 128

    # canonical codes in zstd's order: (nbits descending, symbol ascending)
    nb = torch.where(present, lens, 0)
    shift = (max_bits - nb).clamp(0, 11)
    span = torch.where(present, torch.ones_like(nb) << shift, 0)
    order = torch.argsort(torch.where(present, -nb * 512 + ids, 1 << 40), dim=1, stable=True)
    start = torch.empty_like(order).scatter_(
        1, order, _excl_cumsum(torch.gather(span, 1, order)))
    codes = start >> shift

    # direct description: 4-bit weights of symbols 0..max_sym-1, two a byte
    n_explicit = max_sym[:, None]
    wk2 = 2 * _arange(128, lens)[None]
    whi = weights[:, 0::2]
    wlo = torch.where(wk2 + 1 < n_explicit, weights[:, 1::2], 0)
    tree_nib = ((whi << 4) | wlo) & 0xFF
    direct_bytes = 1 + ((max_sym + 1) >> 1)

    # FSE-compressed weights (header byte < 128, RFC 8878 4.2.1.1)
    wvalid = ids[None] < n_explicit
    wseq = torch.where(wvalid, weights.clamp(0, 12), 0)
    whist = (torch.where(wvalid, wseq, 13)[:, :, None]
             == _arange(13, lens)[None, None]).sum(dim=1)
    wnorm, wnsym, wnok = normalize_counts(whist, 64)
    wst, wnb, wbs, wfirst, wtok = fse_enc(wnorm, wnsym, 6)
    wdv, wdb, wdl = serialize_ncount(wnorm, wnsym, 6)
    wd_bytes = (wdl + 7) >> 3

    pair = lambda t: torch.stack([t[:, 0::2], t[:, 1::2]], dim=1)   # noqa: E731
    sym2, valid2 = pair(wseq), pair(wvalid)
    s_fin, s_in = _wchain(wst, wfirst, sym2, valid2)
    emit2 = valid2 & torch.nn.functional.pad(valid2[..., 1:], (0, 1))
    at = (sym2 * 64 + s_in).reshape(B, -1)
    tb = torch.where(emit2, s_in - torch.gather(wbs.reshape(B, -1), 1, at).reshape(B, 2, 128), 0)
    tn = torch.where(emit2, torch.gather(wnb.reshape(B, -1), 1, at).reshape(B, 2, 128), 0)

    # the weight region: [description, forward bits][chains, backward bitstream]
    wf_val = torch.cat([s_fin, tb.transpose(1, 2).reshape(B, 256)], dim=1)
    wf_nb = torch.cat([torch.full((B, 2), 6, dtype=torch.int64, device=lens.device),
                       tn.transpose(1, 2).reshape(B, 256)], dim=1)
    wtotal = wf_nb.sum(dim=1, keepdim=True)
    all_v = torch.cat([wdv, wf_val], dim=1)
    all_n = torch.cat([wdb, wf_nb], dim=1)
    all_o = torch.cat([_excl_cumsum(wdb),
                       wd_bytes[:, None] * 8 + (wtotal - _excl_cumsum(wf_nb) - wf_nb)], dim=1)
    emit = all_n > 0
    words = torch.zeros((B, WTREE_CAP // 4 + DUMP_SLOTS), dtype=torch.int64, device=lens.device)
    shifted = all_v << (all_o & 31)
    lane = _arange(all_o.shape[1], lens)[None]
    for w in range(2):
        at = torch.where(emit, ((all_o >> 5) + w).clamp(0, WTREE_CAP // 4 - 1),
                         dump_spread(lane, WTREE_CAP // 4))
        words.scatter_add_(1, at, (shifted >> (32 * w)) & 0xFFFFFFFF)
    wpb = wd_bytes * 8 + wtotal[:, 0]         # the sentinel bit atop the backward stream
    words.scatter_add_(1, (wpb >> 5).clamp(0, WTREE_CAP // 4 - 1)[:, None],
                       (torch.ones_like(wpb) << (wpb & 31))[:, None])
    words = words[:, :WTREE_CAP // 4] & 0xFFFFFFFF
    wtree = ((words[:, :, None] >> (8 * _arange(4, lens))) & 0xFF).reshape(B, WTREE_CAP)
    wthdr = wd_bytes + ((wtotal[:, 0] + 1 + 7) >> 3)
    fse_ok = wnok & wtok & (wthdr < 128) & (max_sym >= 2)

    use_fse = fse_ok & (~direct_ok | (1 + wthdr < direct_bytes))
    ok = ok & (direct_ok | fse_ok)
    tree_hdr = torch.where(use_fse, wthdr, 127 + max_sym)
    tree_bytes = torch.where(use_fse, 1 + wthdr, direct_bytes)
    tp = _arange(TREE_CAP, lens)[None]
    payload = torch.where(use_fse[:, None], wtree[:, (tp[0] - 1).clamp(0, WTREE_CAP - 1)],
                          tree_nib[:, (tp[0] - 1).clamp(0, 127)])
    tree = torch.where(tp == 0, tree_hdr[:, None] & 0xFF, payload)
    tree = torch.where(tp < tree_bytes[:, None], tree, 0)
    return (codes.to(torch.int32), nb.to(torch.int32), tree.to(torch.uint8),
            tree_bytes.to(torch.int32), ok)


def _flog2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2 x) for x >= 1, at most 9 (the reference's unrolled count)."""
    return sum((x >= (1 << k)).to(torch.int64) for k in range(1, 10))


def seq_table(freq, nseq, acc: int, def_norm, def_acc: int, def_enc, size_c: int):
    """One sequence code's FSE table (``custom_stream`` and ``pick``,
    ``tpucomp/formats/zstd.py:1593-1641``): the custom table where it is
    valid and its estimated cost, description included, is below the
    predefined table's, for blocks of at least 16 sequences; else the
    predefined one, zero-padded to ``size_c`` states.

    ``freq int[B, max_sym]`` (the codes' histogram), ``nseq int[B]`` ->
    ``(use bool[B], st, nb, bs int64[B, max_sym, size_c], first int64[B,
    max_sym], acc_used int64[B], dvals, dbits int64[B, 1 + max_sym])``, the
    description's fields zero where the predefined table is used.
    """
    B, max_sym = freq.shape
    dev = freq.device
    freq = freq.to(torch.int64)
    norm, nsym, nok = normalize_counts(freq, 1 << acc)
    stc, nbc, bsc, firstc, tok = fse_enc(norm, nsym, acc)
    dvals, dbits, dlen = serialize_ncount(norm, nsym, acc)
    cost_c = (freq * (acc - _flog2(norm.clamp(min=1)))).sum(dim=1) + dlen + 7 + acc
    dn = torch.from_numpy(np.abs(def_norm).astype(np.int64)[:max_sym]).to(dev)
    cost_p = (freq * (def_acc - _flog2(dn.clamp(min=1)))).sum(dim=1) + def_acc
    use = nok & tok & (cost_c < cost_p) & (nseq >= 16)

    std, nbd, bsd = (torch.from_numpy(np.pad(a.astype(np.int64),
                                             ((0, 0), (0, size_c - a.shape[1])))).to(dev)
                     for a in def_enc[:3])
    firstd = torch.from_numpy(def_enc[3].astype(np.int64)).to(dev)
    u = use[:, None, None]
    return (use, torch.where(u, stc, std), torch.where(u, nbc, nbd), torch.where(u, bsc, bsd),
            torch.where(use[:, None], firstc, firstd), torch.where(use, acc, def_acc),
            dvals, torch.where(use[:, None], dbits, 0))


# =====================================================================================
# the multi-block encoder (tpucomp/formats/zstd.py:1086-1150,1317-1906), torch ops
# =====================================================================================
#
# The reference vmaps encode_chunk over the rows and lax.maps
# _encode_block_body over each row's 128 KiB blocks.  Here every block of a
# slice of rows (ROW_SLICE_BYTES) is one row of one batch: the match finder
# and the parse run on slices of blocks (their temporaries are some 300
# bytes a position), the sequence side on all blocks at once.  Its four
# sequential scans (the repeat-offset stack and the three FSE state chains)
# are torch loops over the sequences, each step acting on every block; they
# run to the batch's largest sequence count, which is read on the host once.

ZSTD_BLOCK = 1 << 17            # 128 KiB zstd block limit (RFC 8878 3.1.1.2.3)
SLICE_POSITIONS = 1 << 23       # block positions the match finder takes at once
ROW_SLICE_BYTES = 1 << 26       # chunk bytes one encode_chunk call takes (512 blocks)
# The block body reads no byte more than 263 past a block's size (the 24-word
# probe, the 64-word extension and its 3-byte tail), so a batch of blocks
# whose sizes are all well under its width is encoded at the largest size
# plus this margin: the same bodies for less work (a chunk's short tail).
READ_PAST = 512
_FAR = 2**30                    # the reference's sort sentinel


def _ceil_log2(n: int) -> int:
    return max(1, math.ceil(math.log2(max(n, 2))))


def _compact(mask: torch.Tensor, vals: torch.Tensor, width: int, fill: int) -> torch.Tensor:
    """The entries of ``vals [1 or B, n]`` where ``mask [B, n]``, in order,
    into ``[B, width]``, ``fill`` after them: the reference's sort of the
    kept entries with a large sentinel, clipped (writes past ``width`` go to
    the dump slots)."""
    B = mask.shape[0]
    rank = torch.cumsum(mask, dim=1) - 1
    lane = _arange(mask.shape[1], mask)[None]
    at = torch.where(mask & (rank < width), rank, dump_spread(lane, width))
    out = torch.full((B, width + DUMP_SLOTS), fill, dtype=torch.int64, device=mask.device)
    return out.scatter_(1, at, vals.expand(B, -1))[:, :width]


def _frame_header(size: torch.Tensor) -> torch.Tensor:
    """``int64[B, 10]``: magic, FHD (4-byte FCS), the window descriptor of
    ``ceil(log2 size)`` in [10, 24], the size (``zstd.py:1800-1813``)."""
    size = size.to(torch.int64)
    wl = _bitlen(size - 1, 24).clamp(min=10)
    magic = torch.tensor([MAGIC >> (8 * b) & 0xFF for b in range(4)] + [0x80],
                         device=size.device).expand(size.shape[0], 5)
    fcs = (size[:, None] >> (8 * _arange(4, size))) & 0xFF
    return torch.cat([magic, ((wl - 10) << 3)[:, None], fcs], dim=1)


def _blocks_frame(hdr, active, bh, out_sizes, body_byte, out_cap: int):
    """The frame bytes ``int64[B, out_cap]`` and total size ``[B]``: ``hdr``,
    then each active block's 3-byte header ``bh`` and its ``out_sizes - 3``
    body bytes, ``body_byte(kblk, r)`` giving byte ``r`` of block ``kblk``
    (each output byte classifies itself against the block layout)."""
    B, nb = bh.shape
    out_off = 10 + _excl_cumsum(out_sizes)
    total = 10 + out_sizes.sum(dim=1)
    pos = _arange(out_cap, bh)[None]
    key = torch.where(active, out_off, _FAR)
    kblk = (torch.searchsorted(key, pos.expand(B, out_cap).contiguous(), right=True)
            - 1).clamp(0, nb - 1)
    r = pos - torch.gather(out_off, 1, kblk)
    bh_byte = (torch.gather(bh, 1, kblk) >> (8 * r.clamp(0, 2))) & 0xFF
    body = torch.where(r < 3, bh_byte, body_byte(kblk, r - 3))
    out = torch.where(pos < 10, hdr[:, pos[0].clamp(max=9)], 0)
    return torch.where((pos >= 10) & (pos < total[:, None]), body, out), total


def _encode_store(data: torch.Tensor, size: torch.Tensor, out_cap: int):
    """Store-mode frames, 64 KiB raw blocks (``zstd.py:1086-1150``) ->
    ``(out uint8[B, out_cap], out_size int32[B], status int32[B])``.  A frame
    above ``out_cap`` keeps the bytes that fit, with size 0 and
    ``ERROR_OUTPUT_BUFFER_TOO_SMALL``, as the reference."""
    B, cap = data.shape
    BLK = 1 << 16
    size = size.to(torch.int64)
    bi = _arange(max(1, -(-cap // BLK)), size)[None]
    blk_start = bi * BLK
    blk_size = (size[:, None] - blk_start).clamp(0, BLK)
    n_blocks = (blk_size > 0).sum(dim=1, keepdim=True).clamp(min=1)
    active = (blk_size > 0) | (bi == 0)
    bh = (bi == n_blocks - 1).to(torch.int64) | (blk_size << 3)
    d = data.to(torch.int64)

    def raw(kblk, r):
        return torch.gather(d, 1, (torch.gather(blk_start.expand(B, -1), 1, kblk) + r)
                            .clamp(0, cap - 1))

    out, total = _blocks_frame(_frame_header(size), active, bh,
                               torch.where(active, 3 + blk_size, 0), raw, out_cap)
    too_big = total > out_cap
    return (out.to(torch.uint8), torch.where(too_big, 0, total).to(torch.int32),
            torch.where(too_big, int(Status.ERROR_OUTPUT_BUFFER_TOO_SMALL),
                        int(Status.SUCCESS)).to(torch.int32))


def _bytes_of(words: torch.Tensor) -> torch.Tensor:
    """Little-endian bytes ``int64[B, 4n]`` of 32-bit words ``[B, n]``."""
    B = words.shape[0]
    return ((words[:, :, None] >> (8 * _arange(4, words))) & 0xFF).reshape(B, -1)


def _scatter_fields(vals, nbits, bit_off, n_words: int, parts: int) -> torch.Tensor:
    """Bit fields ``vals`` of ``nbits`` bits at ``bit_off`` into 32-bit words
    ``int64[B, n_words]``: each field's word parts added (fields are
    disjoint, so the sums are ORs), fields of no bits to the dump slots."""
    B, n = vals.shape
    words = torch.zeros((B, n_words + DUMP_SLOTS), dtype=torch.int64, device=vals.device)
    shifted = vals << (bit_off & 31)
    lane = _arange(n, vals)[None]
    for w in range(parts):
        at = torch.where(nbits > 0, ((bit_off >> 5) + w).clamp(0, n_words - 1),
                         dump_spread(lane, n_words))
        words.scatter_add_(1, at, (shifted >> (32 * w)) & 0xFFFFFFFF)
    return words


def _huf_literals(lit_bytes: torch.Tensor, n_lit: torch.Tensor, cap: int):
    """A Huffman-compressed 4-stream literal section (``zstd.py:1317-1426``):
    ``lit_bytes uint8[B, cap]``, ``n_lit int[B]`` -> ``(section int64[B,
    cap + 64] uint8, section_len int64[B], ok bool[B])``; ``ok`` is False where
    Huffman coding does not apply or does not win (the caller then emits raw
    literals).  The table and tree come from :func:`huf_tree`; each of the
    four backward streams is laid out by offset arithmetic and a scatter."""
    B = lit_bytes.shape[0]
    li = _arange(cap, lit_bytes)[None]
    n_lit = n_lit.to(torch.int64)[:, None]
    valid = li < n_lit
    lit = lit_bytes.to(torch.int64)
    freq = torch.zeros((B, 256), dtype=torch.int64, device=lit.device)
    freq.scatter_add_(1, lit, valid.expand(B, cap).to(torch.int64))
    codes, nb, tree, tree_bytes, ok = huf_tree(freq)
    codes, nb, tree_bytes = codes.to(torch.int64), nb.to(torch.int64), tree_bytes.to(torch.int64)
    ok = ok & (n_lit[:, 0] >= 64)

    # four streams: 3 x ceil(n / 4), then the rest
    per = (n_lit + 3) >> 2
    counts = torch.cat([per, per, per, n_lit - 3 * per], dim=1)
    offs = torch.cat([0 * per, per, 2 * per, 3 * per], dim=1)
    sidx = torch.where(valid, li // per.clamp(min=1), 0).clamp(0, 3)
    sidx = torch.where(li >= 3 * per, 3, sidx)
    code_l = torch.gather(codes, 1, lit)
    nb_l = torch.where(valid, torch.gather(nb, 1, lit), 0)

    # each stream's bits, the first literal at the top: a segmented prefix sum
    cum = _excl_cumsum(nb_l)
    at_start = torch.where(counts > 0, torch.gather(cum, 1, offs.clamp(0, cap - 1)), 0)
    in_stream = cum - torch.gather(at_start, 1, sidx)
    ends = (offs + counts - 1).clamp(0, cap - 1)
    total_bits = torch.where(counts > 0, torch.gather(cum, 1, ends)
                             + torch.gather(nb_l, 1, ends) - at_start, 0)
    sbytes = (total_bits + 1 + 7) >> 3
    soff = _excl_cumsum(sbytes)
    bit_off = (torch.gather(soff, 1, sidx) * 8 + torch.gather(total_bits, 1, sidx)
               - in_stream - nb_l)
    n_words = cap // 2 + 8
    words = _scatter_fields(code_l, nb_l, bit_off, n_words, 2)
    pb = soff * 8 + total_bits                  # each stream's padding bit
    words.scatter_add_(1, (pb >> 5).clamp(0, n_words - 1),
                       torch.where(counts > 0, 1 << (pb & 31), 0))
    stream_u8 = _bytes_of(words[:, :n_words] & 0xFFFFFFFF)

    streams_total = sbytes.sum(dim=1)
    csize = tree_bytes + 6 + streams_total
    ok = ok & (csize + 5 < n_lit[:, 0]) & (sbytes < (1 << 16)).all(dim=1)

    # [5-byte header: compressed, 4 streams, 18-bit sizes][tree][jump table][streams]
    po = _arange(cap + 64, lit)[None]
    w0 = 2 | (3 << 2) | ((n_lit[:, 0] & 0x3FFFF) << 4) | ((csize & 0x3FFFF) << 22)
    sec = torch.where(po < 5, (w0[:, None] >> (8 * po.clamp(max=4))) & 0xFF, 0)
    tb = tree_bytes[:, None]
    sec = torch.where((po >= 5) & (po < 5 + tb),
                      tree.to(torch.int64)[:, (po[0] - 5).clamp(0, TREE_CAP - 1)], sec)
    jump = torch.stack([sbytes[:, k // 2] >> (8 * (k % 2)) for k in range(6)], dim=1) & 0xFF
    jo = 5 + tb
    sec = torch.where((po >= jo) & (po < jo + 6),
                      torch.gather(jump, 1, (po - jo).clamp(0, 5)), sec)
    so = jo + 6
    sec = torch.where((po >= so) & (po < so + streams_total[:, None]),
                      torch.gather(stream_u8, 1, (po - so).clamp(0, 4 * n_words - 1)), sec)
    return sec.to(torch.uint8), 5 + csize, ok


def _block_tokens(data: torch.Tensor, size: torch.Tensor) -> dict:
    """The parse of a slice of blocks (``zstd.py:1448-1540``): matches,
    the entropy-aware greedy parse, the merged sequences and the literal
    section.  ``data uint8[S, cap]``, ``size int[S]``."""
    from tpucomp_torch.formats import lz4
    S, cap = data.shape
    dev = data.device
    size = size.to(torch.int64)
    sz = size[:, None]
    # a deeper candidate list than the byte-LZ encoders: zstd's entropy
    # stage amortizes the match quality
    mlen, moff = lz4._find_matches(data, size, run_dists=(1, 2, 4, 8), ext_words=64,
                                   n_cands=32, probe_words=24)
    p = _arange(cap, data)[None]

    # entropy-aware match economics: a match whose coded cost exceeds the
    # Huffman cost of its bytes as literals is dropped; float32 throughout,
    # as the reference
    histb = torch.zeros((S, 256), dtype=torch.float32, device=dev)
    histb.scatter_add_(1, data.to(torch.int64), (p < sz).to(torch.float32).expand(S, cap))
    pr = histb / sz.clamp(min=1).to(torch.float32)
    log2 = torch.log(pr.clamp(min=1e-9)) / torch.log(torch.tensor(2.0, device=dev))
    hbits = (-torch.where(pr > 0, pr * log2, 0.0).sum(dim=1)).clamp(min=1.0)
    ofb = (_bitlen(moff + 3, 18) - 1).clamp(min=0)
    economic = mlen.to(torch.float32) * hbits[:, None] >= (ofb + 12).to(torch.float32)

    has_match = (mlen >= 4) & economic
    ml_next = torch.nn.functional.pad(mlen[:, 1:], (0, 1))
    hm_next = torch.nn.functional.pad(has_match[:, 1:], (0, 1))
    has_match = has_match & ~(hm_next & (ml_next > mlen))      # one-step lazy matching
    nxt = torch.where(p < sz, torch.where(has_match, p + mlen, p + 1), cap)
    reach = wyllie_path(nxt, num_rounds=_ceil_log2(cap) + 1) & (p < sz)
    is_tok = reach & has_match
    nseq = is_tok.sum(dim=1)
    W = max(int(nseq.max()), 1)

    t_pos = _compact(is_tok, p, W, cap - 1)
    t_ml = torch.gather(mlen, 1, t_pos)
    t_off = torch.gather(moff, 1, t_pos).clamp(min=1)
    ti = _arange(W, data)[None]
    t_valid = ti < nseq[:, None]
    prev_end = torch.nn.functional.pad((t_pos + t_ml)[:, :-1], (1, 0))
    t_ll = torch.where(t_valid, t_pos - prev_end, 0)
    t_ml = torch.where(t_valid, t_ml, 0)

    # merge same-offset chains of no literals: one match the extension cap split
    prev_off = torch.nn.functional.pad(t_off[:, :-1], (1, 0))
    head = ~(t_valid & (ti > 0) & (t_ll == 0) & (t_off == prev_off))
    gid = torch.cumsum(head, dim=1) - 1
    ml_sum = torch.zeros((S, W), dtype=torch.int64, device=dev).scatter_add_(
        1, gid.clamp(0, W - 1), t_ml)
    vhead = head & t_valid
    nseq = vhead.sum(dim=1)
    hsel = _compact(vhead, ti, W, W - 1)
    t_valid = ti < nseq[:, None]
    t_ll = torch.where(t_valid, torch.gather(t_ll, 1, hsel), 0)
    t_off = torch.gather(t_off, 1, hsel)
    t_ml = torch.where(t_valid, ml_sum, 0)

    is_lit = reach & ~has_match
    n_lit = is_lit.sum(dim=1)
    lit_bytes = torch.gather(data, 1, _compact(is_lit, p, cap, cap - 1))
    sec, sec_len, huf_ok = _huf_literals(lit_bytes, n_lit, cap)
    return dict(t_ll=t_ll, t_ml=t_ml, t_off=t_off, nseq=nseq, lit_bytes=lit_bytes,
                n_lit=n_lit, sec=sec, sec_len=sec_len, huf_ok=huf_ok)


def _rep_codes(t_off, t_ll, t_valid, first, n: int) -> torch.Tensor:
    """Offset values with the 3-deep repeat-offset stack (``rep_step``,
    ``zstd.py:1548-1579``): a torch loop over the first ``n`` sequences,
    each step on every block.  Offset_Value 1-3 name the stack's entries
    (shifted by one without literals), else ``offset + 3``; ``first`` blocks
    start from the (1, 4, 8) stack, later ones from sentinels."""
    o3 = t_off + 3
    if n == 0:
        return o3
    offs, o3c = t_off[:, :n].T.contiguous(), o3[:, :n].T.contiguous()
    wl = (t_ll[:, :n] > 0).T.contiguous()
    b1, b2 = 1 + wl.to(torch.int64), 2 + wl.to(torch.int64)
    r0 = torch.where(first, 1, -1).to(torch.int64)
    r1 = torch.where(first, 4, -2).to(torch.int64)
    r2 = torch.where(first, 8, -3).to(torch.int64)
    out = torch.empty_like(offs)
    one = torch.ones((), dtype=torch.int64, device=offs.device)
    for i in range(n):
        off = offs[i]
        e0 = (off == r0) & wl[i]
        e1 = off == r1
        torch.where(e0, one, torch.where(e1, b1[i], torch.where(off == r2, b2[i], o3c[i])),
                    out=out[i])
        # code 1 with literals keeps the stack; code 2 swaps; the rest push
        r0, r1, r2 = off, torch.where(e0, r1, r0), torch.where(e0 | e1, r2, r1)
    ofv = o3.clone()
    ofv[:, :n] = torch.where(t_valid[:, :n], out.T, o3[:, :n])
    return ofv


def _fse_chains(syms, st, first, nseq, n: int):
    """The FSE state chains of the three sequence codes (``chain``,
    ``zstd.py:1643-1667``), walked backward from each block's last sequence,
    all three and every block at once.  ``syms [N, 3, W]``, ``st [N, 3,
    R, S]`` (next state by symbol and state), ``first [N, 3, R]``.  Returns
    the final states ``[N, 3]`` and the state carried into each sequence
    ``[N, 3, W]`` (0 until the chain starts)."""
    N, _, R, S = st.shape
    W = syms.shape[2]
    tab = st.reshape(N, 3, R * S)
    ti = _arange(W, syms)[None]
    last = nseq[:, None] - 1
    hold = (ti >= last)[:, None, :].expand(N, 3, W)            # no transition here
    init = torch.where((ti == last)[:, None, :], torch.gather(first, 2, syms), 0)
    s = torch.zeros((N, 3), dtype=torch.int64, device=syms.device)
    s_in = torch.zeros((W, N, 3), dtype=torch.int64, device=syms.device)
    if n:
        symS = (syms[..., :n] * S).permute(2, 0, 1).contiguous()
        hold_t = hold[..., :n].permute(2, 0, 1).contiguous()
        init_t = init[..., :n].permute(2, 0, 1).contiguous()
        for i in range(n - 1, -1, -1):
            s_in[i] = s
            s = torch.where(hold_t[i], init_t[i],
                            torch.gather(tab, 2, (symS[i] + s)[..., None])[..., 0])
    return s, s_in.permute(1, 2, 0)


def _encode_block_body(data: torch.Tensor, size: torch.Tensor, first_block: torch.Tensor):
    """Compressed-block bodies (``zstd.py:1429-1797``) of ``data uint8[N,
    cap]`` (``cap <= ZSTD_BLOCK``), ``size int[N]``, ``first_block bool[N]``
    -> ``(body uint8[N, cap + 64], body_len int64[N], ok bool[N])``, no frame
    or block headers; ``ok`` False means the caller emits a raw block.

    Literals are Huffman-coded (4 streams) where that wins, else raw; the
    sequences use per-block custom FSE tables where they pay, else the
    predefined ones.  The repeat-offset stack carries across a frame's
    blocks, so only a frame's first block claims the initial (1, 4, 8) stack.
    """
    N, full = data.shape
    dev = data.device
    cap = min(full, int(size.max()) + READ_PAST)
    data = data[:, :cap]
    per = max(1, SLICE_POSITIONS // cap)
    parts = [_block_tokens(data[i:i + per], size[i:i + per]) for i in range(0, N, per)]
    W = max(x["t_ll"].shape[1] for x in parts)

    def cat(key, fill=None):      # the token columns padded to the widest slice's
        return torch.cat([x[key] if fill is None else torch.nn.functional.pad(
            x[key], (0, W - x[key].shape[1]), value=fill) for x in parts])

    t_ll, t_ml, t_off = cat("t_ll", 0), cat("t_ml", 0), cat("t_off", 1)
    nseq, n_lit, lit_bytes = cat("nseq"), cat("n_lit"), cat("lit_bytes")
    huf_sec, huf_len, huf_ok = cat("sec"), cat("sec_len"), cat("huf_ok")
    del parts
    n = int(nseq.max())
    ti = _arange(W, data)[None]
    t_valid = ti < nseq[:, None]

    # ---- per-sequence codes, the repeat offsets -------------------------------------
    ll_base = torch.from_numpy(LL_BASE.astype(np.int64)).to(dev)
    ml_base = torch.from_numpy(ML_BASE.astype(np.int64)).to(dev)
    ll_code = (torch.searchsorted(ll_base, t_ll, right=True) - 1).clamp(0, 35)
    ml3 = t_ml.clamp(min=3)
    ml_code = (torch.searchsorted(ml_base, ml3, right=True) - 1).clamp(0, 52)
    ll_x = t_ll - ll_base[ll_code]
    ml_x = ml3 - ml_base[ml_code]
    ofv = _rep_codes(t_off, t_ll, t_valid, first_block.to(dev), n)
    of_code = (_bitlen(ofv, 18) - 1).clamp(min=0)
    of_x = ofv - (1 << of_code)

    # ---- the FSE tables: custom (mode 2) where they beat the predefined ones --------
    def hist(codes, max_sym):
        h = torch.zeros((N, max_sym + 1), dtype=torch.int64, device=dev)
        h.scatter_add_(1, torch.where(t_valid, codes.clamp(0, max_sym - 1), max_sym),
                       torch.ones_like(codes))
        return h[:, :max_sym]

    tabs = [seq_table(hist(c, ms), nseq, acc, dn, da, enc, sc)
            for c, ms, acc, dn, da, enc, sc in (
                (ll_code, 36, MAX_ACC_LOG, LL_DEFAULT, LL_DEFAULT_ACC, LL_ENC, FSE_CAP),
                (ml_code, 53, MAX_ACC_LOG, ML_DEFAULT, ML_DEFAULT_ACC, ML_ENC, FSE_CAP),
                (of_code, 29, 8, OF_DEFAULT, OF_DEFAULT_ACC, OF_ENC, 256))]

    def padded(t, rows=53, cols=FSE_CAP):
        return torch.nn.functional.pad(t, (0, cols - t.shape[-1], 0, rows - t.shape[-2]))

    syms = torch.stack([ll_code, ml_code, of_code], dim=1)
    s0, s_in = _fse_chains(syms, torch.stack([padded(t[1]) for t in tabs], dim=1),
                           torch.stack([torch.nn.functional.pad(t[4], (0, 53 - t[4].shape[1]))
                                        for t in tabs], dim=1), nseq, n)
    moves = ti < (nseq[:, None] - 1)                 # a transition's bits are written
    ub, un = [], []
    for k, t in enumerate(tabs):
        S = t[1].shape[2]
        at = syms[:, k] * S + s_in[:, k]
        un.append(torch.where(moves, torch.gather(t[2].reshape(N, -1), 1, at), 0))
        ub.append(torch.where(moves, s_in[:, k] - torch.gather(t[3].reshape(N, -1), 1, at), 0))

    # ---- the bitstream: fields in decode order, read top-down -----------------------
    ll_bits = torch.from_numpy(LL_BITS.astype(np.int64)).to(dev)
    ml_bits = torch.from_numpy(ML_BITS.astype(np.int64)).to(dev)
    f_val = torch.stack([of_x, ml_x, ll_x, ub[0], ub[1], ub[2]], dim=2).reshape(N, -1)
    f_nb = torch.stack([torch.where(t_valid, of_code, 0), torch.where(t_valid, ml_bits[ml_code], 0),
                        torch.where(t_valid, ll_bits[ll_code], 0), un[0], un[1], un[2]],
                       dim=2).reshape(N, -1)
    head_val = torch.stack([s0[:, 0], s0[:, 2], s0[:, 1]], dim=1)     # LL, OF, ML
    head_nb = torch.where((nseq > 0)[:, None],
                          torch.stack([tabs[0][5], tabs[2][5], tabs[1][5]], dim=1), 0)
    vals = torch.cat([head_val, f_val], dim=1)
    nbs = torch.cat([head_nb, f_nb], dim=1)
    total_bits = nbs.sum(dim=1)
    bit_off = total_bits[:, None] - _excl_cumsum(nbs) - nbs
    stream_bytes = (total_bits + 1 + 7) // 8
    n_words = cap // 4 + 16
    words = _scatter_fields(vals, nbs, bit_off, n_words, 3)
    words.scatter_add_(1, (total_bits >> 5).clamp(0, n_words - 1)[:, None],
                       (1 << (total_bits & 31))[:, None])        # the padding 1-bit
    stream_u8 = _bytes_of(words[:, :n_words] & 0xFFFFFFFF)

    # ---- the table descriptions (LL, OF, ML), each byte-aligned ---------------------
    DESC_W = 3 * 96 // 4
    dv = [tabs[0][6], tabs[2][6], tabs[1][6]]
    db = [tabs[0][7], tabs[2][7], tabs[1][7]]
    lens_b = [(b.sum(dim=1) + 7) >> 3 for b in db]
    starts = [0 * lens_b[0], lens_b[0] * 8, (lens_b[0] + lens_b[1]) * 8]
    region = torch.cat([s[:, None].expand(-1, b.shape[1]) for s, b in zip(starts, db)], dim=1)
    local = torch.cat([_excl_cumsum(b) for b in db], dim=1)
    desc_words = _scatter_fields(torch.cat(dv, dim=1), torch.cat(db, dim=1), region + local,
                                 DESC_W, 2)
    desc_u8 = _bytes_of(desc_words[:, :DESC_W] & 0xFFFFFFFF)
    desc_total = lens_b[0] + lens_b[1] + lens_b[2]

    # ---- the body: [literal section][nseq][scm][descriptions][bitstream] ------------
    has_seq = (nseq > 0)[:, None]
    nseq_hdr = torch.where(nseq == 0, 1, 2)
    seq_sec = nseq_hdr + torch.where(nseq > 0, 1 + desc_total + stream_bytes, 0)
    lit_len = torch.where(huf_ok, huf_len, 3 + n_lit)
    body_len = lit_len + seq_sec
    pos = _arange(cap + 64, data)[None]
    raw_lit = ~huf_ok[:, None]
    nl = n_lit[:, None]
    lit_hdr = (3 << 2) | (nl << 4)            # raw literals, 20-bit size
    out = torch.where(raw_lit & (pos < 3), (lit_hdr >> (8 * pos.clamp(max=2))) & 0xFF, 0)
    out = torch.where(raw_lit & (pos >= 3) & (pos < 3 + nl),
                      lit_bytes.to(torch.int64)[:, (pos[0] - 3).clamp(0, cap - 1)], out)
    out = torch.where(~raw_lit & (pos < huf_len[:, None]), huf_sec.to(torch.int64), out)
    o1 = lit_len[:, None]
    out = torch.where(pos == o1, torch.where(nseq == 0, 0, 128 + (nseq >> 8))[:, None] & 0xFF,
                      out)
    out = torch.where((pos == o1 + 1) & has_seq, (nseq & 0xFF)[:, None], out)
    o2 = o1 + nseq_hdr[:, None]
    scm = sum(torch.where(t[0], 2, 0) << sh for t, sh in ((tabs[0], 6), (tabs[2], 4),
                                                          (tabs[1], 2)))
    out = torch.where((pos == o2) & has_seq, scm[:, None], out)
    out = torch.where(has_seq & (pos >= o2 + 1) & (pos < o2 + 1 + desc_total[:, None]),
                      torch.gather(desc_u8, 1, (pos - o2 - 1).clamp(0, 4 * DESC_W - 1)), out)
    o3 = o2 + 1 + desc_total[:, None]
    out = torch.where(has_seq & (pos >= o3) & (pos < body_len[:, None]),
                      torch.gather(stream_u8, 1, (pos - o3).clamp(0, 4 * n_words - 1)), out)
    ok = (nseq <= 32511) & (n_lit < (1 << 20)) & (body_len <= cap + 64)
    return torch.nn.functional.pad(out.to(torch.uint8), (0, full - cap)), body_len, ok


def encode_chunk(data: torch.Tensor, size: torch.Tensor, opts: ZstdOpts, out_cap: int):
    """Zstandard frames of a batch of chunks (``zstd.py:1819-1903``), ``data
    uint8[B, cap]``, ``size int[B]`` -> ``(out uint8[B, out_cap], out_size
    int32[B], status int32[B])``.

    A chunk of at most 128 KiB is one compressed block; a wider one is split
    into 128 KiB blocks, each compressed or raw, whichever is smaller,
    matches found within each block (up to nvCOMP's 16 MiB chunks).  The
    store-mode frame is the fallback where nothing wins.
    """
    B, cap = data.shape
    dev = data.device
    size = size.to(device=dev, dtype=torch.int64)
    store_out, store_size, store_status = _encode_store(data, size, out_cap)
    ok_status = int(Status.SUCCESS)

    if cap <= ZSTD_BLOCK:
        body, body_len, ok = _encode_block_body(
            data, size, torch.ones(B, dtype=torch.bool, device=dev))
        total = 13 + body_len
        bh = 1 | (2 << 1) | (body_len << 3)
        hdr = torch.cat([_frame_header(size), (bh[:, None] >> (8 * _arange(3, bh))) & 0xFF],
                        dim=1)
        pos = _arange(out_cap, data)[None]
        out = torch.where(pos < 13, hdr[:, pos[0].clamp(max=12)], 0)
        out = torch.where((pos >= 13) & (pos < total[:, None]),
                          body.to(torch.int64)[:, (pos[0] - 13).clamp(0, cap + 63)], out)
        use = ok & (total <= out_cap) & (total < store_size)
        return (torch.where(use[:, None], out.to(torch.uint8), store_out),
                torch.where(use, total, store_size).to(torch.int32),
                torch.where(use, ok_status, store_status).to(torch.int32))

    # ---- multi-block frame -----------------------------------------------------------
    nb = -(-cap // ZSTD_BLOCK)
    blocks = torch.nn.functional.pad(data, (0, nb * ZSTD_BLOCK - cap)).reshape(B * nb, ZSTD_BLOCK)
    bi = _arange(nb, data)[None]
    bsize = (size[:, None] - bi * ZSTD_BLOCK).clamp(0, ZSTD_BLOCK)
    # blocks past a chunk's end take no part in its frame: skipped
    live = (bsize > 0).reshape(-1).nonzero()[:, 0]
    bodies = torch.zeros((B * nb, ZSTD_BLOCK + 64), dtype=torch.uint8, device=dev)
    body_lens = torch.zeros(B * nb, dtype=torch.int64, device=dev)
    oks = torch.zeros(B * nb, dtype=torch.bool, device=dev)
    if live.numel():
        b, bl, o = _encode_block_body(blocks[live], bsize.reshape(-1)[live],
                                      (bi == 0).expand(B, nb).reshape(-1)[live])
        bodies[live], body_lens[live], oks[live] = b, bl, o
    body_lens, oks = body_lens.reshape(B, nb), oks.reshape(B, nb)

    active = (bsize > 0) | (bi == 0)
    n_blocks = (bsize > 0).sum(dim=1, keepdim=True).clamp(min=1)
    use_comp = oks & (body_lens < bsize)
    csize = torch.where(use_comp, body_lens, bsize)
    bh = ((bi == n_blocks - 1).to(torch.int64) | (torch.where(use_comp, 2, 0) << 1)
          | (csize << 3))
    d = data.to(torch.int64)
    flat = bodies.reshape(-1)
    rows = _arange(B, data)[:, None] * nb

    def body_byte(kblk, r):
        raw = torch.gather(d, 1, (kblk * ZSTD_BLOCK + r).clamp(0, cap - 1))
        comp = flat[(rows + kblk) * (ZSTD_BLOCK + 64) + r.clamp(0, ZSTD_BLOCK + 63)]
        return torch.where(torch.gather(use_comp, 1, kblk), comp.to(torch.int64), raw)

    out, total = _blocks_frame(_frame_header(size), active, bh,
                               torch.where(active, 3 + csize, 0), body_byte, out_cap)
    use = (total <= out_cap) & (total < store_size)
    return (torch.where(use[:, None], out.to(torch.uint8), store_out),
            torch.where(use, total, store_size).to(torch.int32),
            torch.where(use, ok_status, store_status).to(torch.int32))


def compress_batch(data: torch.Tensor, sizes: torch.Tensor, opts: ZstdOpts = DEFAULT_OPTS,
                   out_cap: int | None = None):
    """The reference's XLA encoder (``zstd.py:1905-1907``), on ``data``'s
    device: frames byte-identical to ``tpucomp.formats.zstd.compress_batch``
    at every chunk size up to 16 MiB.  Sizes outside ``[0, cap]`` are
    clamped, as the port's other encoders do.  The rows go through
    :func:`encode_chunk` in slices of ``ROW_SLICE_BYTES``, which bound the
    temporaries (a few GB on the card at 64 MiB)."""
    if out_cap is None:
        out_cap = max_compressed_chunk_size(data.shape[1], opts)
    if data.shape[0] == 0:
        return (torch.zeros((0, out_cap), dtype=torch.uint8, device=data.device),
                torch.zeros(0, dtype=torch.int32, device=data.device),
                torch.zeros(0, dtype=torch.int32, device=data.device))
    B, cap = data.shape
    sizes = sizes.to(device=data.device, dtype=torch.int64).clamp(0, cap)
    step = max(1, ROW_SLICE_BYTES // max(cap, 1))
    if B <= step:
        return encode_chunk(data, sizes, opts, out_cap)
    outs = [encode_chunk(data[i:i + step], sizes[i:i + step], opts, out_cap)
            for i in range(0, B, step)]
    return tuple(torch.cat(parts) for parts in zip(*outs))
