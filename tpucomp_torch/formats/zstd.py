"""Zstandard (RFC 8878) frames: code tables, options, size bound, the size
read, and the table builders of the encoder.

Port of the parts of :mod:`tpucomp.formats.zstd` that the batched kernel
paths need (``tpucomp/formats/zstd.py:42-360,1153-1316``).  The decoder runs
in the Hopper kernel of :mod:`tpucomp_torch.ops.cuda.zstd_decode`, the
encoder in that of :mod:`tpucomp_torch.ops.cuda.zstd_encode` (each with its
plain version).  The encoder's tables are built here, in torch ops batched
over a leading chunk dimension: the custom FSE tables of the sequence codes
(:func:`normalize_counts`, :func:`fse_build`, :func:`fse_enc`,
:func:`serialize_ncount`) and the literal Huffman table with its tree
description (:func:`huf_tree`).  They give the reference's table words
exactly: its stable sorts are ``stable=True`` argsorts, its first-index
``argmax`` a masked minimum of indices, and its scatters into dump slots
writes that land in a column cut off afterwards.  Not ported yet: the
reference's XLA decoder and multi-block encoder (``decode_chunk``,
``encode_chunk``, ``compress_batch``, ``decompress_batch``; ROADMAP A.6).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpucomp_torch.chunk import wrap_i32
from tpucomp_torch.formats.deflate import _first_argmax, huff_lengths

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


def prefix_run_length(pred: torch.Tensor) -> torch.Tensor:
    """For each i, the number of consecutive True values of ``pred[..., :i+1]``
    that end at i (``tpucomp/ops/parallel_lz.py:53-63``)."""
    idx = _arange(pred.shape[-1], pred).expand(pred.shape)
    last_false = torch.cummax(torch.where(pred, -1, idx), dim=-1).values
    return idx - last_false


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
    words = torch.zeros((B, WTREE_CAP // 4 + 1), dtype=torch.int64, device=lens.device)
    shifted = all_v << (all_o & 31)
    for w in range(2):
        at = torch.where(emit, ((all_o >> 5) + w).clamp(0, WTREE_CAP // 4 - 1), WTREE_CAP // 4)
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
