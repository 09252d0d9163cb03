"""Deflate (RFC 1951): tables, options, size bound and the code-length helpers.

Port of the part of :mod:`tpucomp.formats.deflate` that the kernel path needs
(``tpucomp/formats/deflate.py:42-79,469-555,880-897``).  The codec itself
runs in the Hopper kernels of :mod:`tpucomp_torch.ops.cuda` (and their plain
versions); the reference's log-depth XLA program (``_walk_blocks``,
``decode_chunk``, ``encode_chunk``, ``get_decompress_size``) is not ported
yet (``ROADMAP.md``, queue A).

:func:`canonical` and :func:`decode_sym` are the reference's canonical
decode tables and range-compare symbol decoder (``tpucomp/formats/deflate.py:
90-142``), which GDeflate's tile decoder uses.

The helpers that build dynamic Huffman tables (:func:`huff_lengths`,
:func:`assign_codes`, :func:`rev_bits`) are torch ops batched over a leading
chunk dimension, in int32 as the reference runs them; ties between equal
frequencies go to the first index, as ``jnp.argmin``/``jnp.argmax`` give
them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# --- RFC 1951 constant tables --------------------------------------------------------

LEN_BASE = np.array([3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35,
                     43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258], np.int32)
LEN_EXTRA = np.array([0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
                      4, 4, 4, 4, 5, 5, 5, 5, 0], np.int32)
DIST_BASE = np.array([1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193,
                      257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145,
                      8193, 12289, 16385, 24577], np.int32)
DIST_EXTRA = np.array([0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8,
                       9, 9, 10, 10, 11, 11, 12, 12, 13, 13], np.int32)
CL_ORDER = np.array([16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14,
                     1, 15], np.int32)

FIXED_LIT_LENS = np.concatenate([np.full(144, 8), np.full(112, 9),
                                 np.full(24, 7), np.full(8, 8)]).astype(np.int32)
FIXED_DIST_LENS = np.full(32, 5, np.int32)

MAX_BITS = 15


@dataclasses.dataclass(frozen=True)
class DeflateOpts:
    """Analog of ``nvcompBatchedDeflateOpts_t{ int algo }``: 0 fixed Huffman
    codes, 1 per-chunk dynamic codes, 2 dynamic codes without matches."""

    algo: int = 0


DEFAULT_OPTS = DeflateOpts()


def max_compressed_chunk_size(max_chunk_bytes: int,
                              opts: DeflateOpts = DEFAULT_OPTS) -> int:
    """Fixed-Huffman worst case (about 9 bits a byte) plus block overhead,
    rounded up to a multiple of 1024 (the reference's value)."""
    n = max_chunk_bytes + max_chunk_bytes // 2 + 64
    return (n + 1023) & ~1023


# --- canonical decode tables and the range-compare decoder (torch ops over B) ---------

def canonical(lens: torch.Tensor, nsym: int):
    """Canonical decode tables from ``lens int32[B, nsym]`` (0 = unused) ->
    ``(count, first, offset int32[B, 16], sym_of_rank int32[B, nsym], valid
    bool[B])`` (``tpucomp/formats/deflate.py:90-120``): MSB-first codes per
    RFC 1951 3.2.2, ``valid`` when the Kraft sum is at most ``2^15`` (an
    incomplete code is valid).  As the reference: a length above 15 counts
    as 15 with rank 0 in its length, and where two symbols land on one rank
    the later one stays.
    """
    i32 = torch.int32
    B = lens.shape[0]
    dev = lens.device
    lens = lens.to(i32)
    lc = lens.clamp(0, MAX_BITS)
    used = lens > 0
    count = torch.zeros((B, MAX_BITS + 1), dtype=i32, device=dev)
    count.scatter_add_(1, torch.where(used, lc, 0).to(torch.int64), used.to(i32))
    first = torch.zeros_like(count)
    code = torch.zeros(B, dtype=i32, device=dev)
    kraft = torch.zeros(B, dtype=i32, device=dev)
    for l in range(1, MAX_BITS + 1):
        code = (code + count[:, l - 1]) << 1
        first[:, l] = code
        kraft = kraft + (count[:, l] << (MAX_BITS - l))
    offset = torch.cumsum(count, dim=1, dtype=i32) - count
    rank = torch.gather(offset, 1, lc.to(torch.int64))
    for l in range(1, MAX_BITS + 1):
        is_l = lens == l
        rank = rank + torch.where(is_l, torch.cumsum(is_l.to(i32), dim=1, dtype=i32) - 1, 0)
    tgt = torch.where(used, rank.clamp(0, nsym - 1), nsym).to(torch.int64)
    sym_ids = torch.arange(nsym, dtype=i32, device=dev).expand(B, nsym)
    sor = torch.zeros((B, nsym + 1), dtype=i32, device=dev)
    sor.scatter_reduce_(1, tgt, sym_ids, reduce="amax")
    return count, first, offset, sor[:, :nsym], kraft <= (1 << MAX_BITS)


def decode_sym(rev15: torch.Tensor, count, first, offset, sym_of_rank):
    """Decode the code at the front of the bit-reversed 15-bit peek
    ``rev15 int32[B, ...]`` against ``canonical``'s tables -> ``(sym, length,
    found)`` of ``rev15``'s shape (``tpucomp/formats/deflate.py:123-142``).
    Each length 1..15 is a range compare; the shortest that matches wins.
    No match gives symbol 0, length 0 and ``found`` False.
    """
    B = rev15.shape[0]
    view = (B,) + (1,) * (rev15.dim() - 1) + (MAX_BITS,)
    ls = torch.arange(1, MAX_BITS + 1, dtype=rev15.dtype, device=rev15.device)
    code = rev15[..., None] >> (MAX_BITS - ls)
    f = first[:, 1:].reshape(view)
    in_range = (code >= f) & (code - f < count[:, 1:].reshape(view))
    found = in_range.any(dim=-1)
    k = in_range.to(torch.int8).argmax(dim=-1, keepdim=True)       # the shortest match
    idx = torch.gather(offset[:, 1:].reshape(view) + code - f, -1, k).squeeze(-1)
    idx = idx.clamp(0, sym_of_rank.shape[1] - 1).reshape(B, -1).to(torch.int64)
    sym = torch.gather(sym_of_rank, 1, idx).reshape(rev15.shape)
    length = (k.squeeze(-1) + 1).to(rev15.dtype)
    return torch.where(found, sym, 0), torch.where(found, length, 0), found


# --- dynamic-Huffman code lengths (torch ops over B chunks) --------------------------

def _first_argmin(x: torch.Tensor) -> torch.Tensor:
    """Index of the first minimum of each row (``jnp.argmin``'s tie rule)."""
    idx = torch.arange(x.shape[1], device=x.device, dtype=torch.int64)
    hit = x == x.min(dim=1, keepdim=True).values
    return torch.where(hit, idx, x.shape[1]).min(dim=1).values


def _first_argmax(x: torch.Tensor) -> torch.Tensor:
    return _first_argmin(-x)


def huff_lengths(freq: torch.Tensor, max_len: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Length-limited code lengths from ``freq int32[B, n]`` -> ``(lens
    int32[B, n], ok bool[B])`` (``tpucomp/formats/deflate.py:469-523``).

    Start from ``ceil(-log2 p)`` as the bit length of ``total // freq``,
    clamped to ``[1, max_len]``, then ``4 * max_len + 32`` greedy steps: while
    the Kraft sum is over, lengthen the rarest symbol that can grow; while it
    is under, shorten the most frequent symbol whose weight fits the deficit.
    ``ok`` is False when the sum is not exactly one (and more than one symbol
    is present); a lone symbol gets length 1.
    """
    B, n = freq.shape
    i32 = torch.int32
    freq = freq.to(i32)
    unit = 1 << max_len
    total = freq.sum(dim=1, dtype=i32).clamp(min=1)[:, None]
    present = freq > 0
    n_present = present.sum(dim=1, dtype=i32)

    ratio = total // freq.clamp(min=1)
    bl = torch.zeros_like(freq)
    for k in range(31):
        bl += ((ratio >> k) > 0).to(i32)
    lens = torch.where(present, bl.clamp(1, max_len), 0)
    rows = torch.arange(B, device=freq.device)

    def weight(lens):
        return torch.where(lens > 0, torch.full_like(lens, unit) >> lens.clamp(1, max_len), 0)

    for _ in range(4 * max_len + 32):
        w = weight(lens)
        K = w.sum(dim=1, dtype=i32)
        over = K > unit
        under = K < unit
        deficit = (unit - K)[:, None]
        cost = torch.where(present & (lens < max_len), freq, 1 << 30)
        s_inc = _first_argmin(cost)
        val = torch.where(present & (lens > 1) & (w <= deficit), freq, -1)
        s_dec = _first_argmax(val)
        can_dec = val[rows, s_dec] > 0
        step = torch.where(over, 1, torch.where(under & can_dec, -1, 0)).to(i32)
        at = torch.where(over, s_inc, s_dec)
        lens = lens.index_put((rows, at), lens[rows, at] + step)
    K = weight(lens).sum(dim=1, dtype=i32)
    ok = (K == unit) | (n_present <= 1)
    lens = torch.where((n_present == 1)[:, None] & present, 1, lens)
    return lens.to(i32), ok


def assign_codes(lens: torch.Tensor, max_len: int) -> torch.Tensor:
    """Canonical MSB-first codes from ``lens int32[B, n]`` (RFC 1951 3.2.2;
    ``tpucomp/formats/deflate.py:526-542``)."""
    i32 = torch.int32
    lc = lens.clamp(0, max_len)
    count = [torch.zeros(lens.shape[0], dtype=i32, device=lens.device)]
    count += [((lens > 0) & (lc == l)).sum(dim=1, dtype=i32) for l in range(1, max_len + 1)]
    first = [torch.zeros_like(count[0])]
    code = torch.zeros_like(count[0])
    for l in range(1, max_len + 1):
        code = (code + count[l - 1]) << 1
        first.append(code)
    first = torch.stack(first, dim=1)
    rank = torch.zeros_like(lens, dtype=i32)
    for l in range(1, max_len + 1):
        is_l = lens == l
        rank += torch.where(is_l, torch.cumsum(is_l.to(i32), dim=1, dtype=i32) - 1, 0)
    return (torch.gather(first, 1, lc.to(torch.int64)) + rank).to(i32)


def rev_bits(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Bit-reverse the low ``n`` bits of ``v`` (codes go MSB-first into the
    LSB-first stream)."""
    r = torch.zeros_like(v)
    for k in range(MAX_BITS + 1):
        r = torch.where(k < n, (r << 1) | ((v >> k) & 1), r)
    return r


def assign_codes_np(lens: np.ndarray, max_len: int) -> np.ndarray:
    """Host-side canonical code assignment for the static fixed tables."""
    count = np.zeros(max_len + 1, np.int64)
    for l in lens:
        if l > 0:
            count[l] += 1
    first = np.zeros(max_len + 1, np.int64)
    code = 0
    for l in range(1, max_len + 1):
        code = (code + count[l - 1]) << 1
        first[l] = code
    codes = np.zeros(len(lens), np.int32)
    nxt = first.copy()
    for s, l in enumerate(lens):
        if l > 0:
            codes[s] = nxt[l]
            nxt[l] += 1
    return codes
