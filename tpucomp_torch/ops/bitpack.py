"""Frame-of-reference bit packing (the Cascaded "BP" stage), batched over chunks.

Port of :mod:`tpucomp.ops.bitpack` (``tpucomp/ops/bitpack.py:19-147``).  The
layout is the reference's: LSB-first and contiguous, value ``i`` at bit
``i * bits``; the general decoder accepts every width from 0 to 64, the
encoders round into the ladder ``W64``.

Every function runs over a batch: values ``int64[B, cap]`` (64-bit
semantics; sums and differences wrap mod 2^64 as the reference's do), and
one count, minimum and width per row (``[B]``).  Packed words are ``uint32``
values held in ``int64`` tensors (``0 <= w < 2^32``): a value shifted into
place spans at most three words, built from its two 32-bit halves so that no
shift leaves 64 bits.
"""
from __future__ import annotations

import torch

# any width 0..64 is legal in the container; the GENERAL decoder accepts all
ALLOWED_BITS = tuple(range(65))

# The width ladder every encoder emits: each member has a static lcm(32, b)
# bit-group layout, which the fast path (ops/cascaded_fast.py) packs and
# unpacks with reshapes and shifts
W32 = (0, 1, 2, 3, 4, 6, 8, 12, 16, 24, 32)
W64 = W32 + (40, 48, 64)

M32 = 0xFFFFFFFF
_I64_MAX = 0x7FFF_FFFF_FFFF_FFFF


def round_width(bits: torch.Tensor, widths=W64) -> torch.Tensor:
    """Smallest member of ``widths`` >= bits (the largest above it)."""
    out = torch.full_like(bits, widths[-1])
    for w in reversed(widths[:-1]):
        out = torch.where(bits <= w, w, out)
    return out


def bit_length(x: torch.Tensor) -> torch.Tensor:
    """Exact bit length of non-negative int64 values (0 for x <= 0)."""
    k = torch.arange(63, device=x.device)
    return ((x.to(torch.int64)[..., None] >> k) > 0).sum(-1).to(torch.int32)


def round_bits_pow2(b: torch.Tensor) -> torch.Tensor:
    """Smallest of 0, 1, 2, 4, 8, 16, 32, 64 that is >= b (``use_bp=0``)."""
    out = torch.full_like(b, 64)
    for cand in (32, 16, 8, 4, 2, 1, 0):
        out = torch.where(b <= cand, cand, out)
    return out


def choose_width(v: torch.Tensor, count: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Frame-of-reference width over each row's ``v[:count]``.

    Returns ``(min_val int64[B], bits int32[B])``: the exact width such that
    every ``v[i] - min_val`` fits in ``bits`` bits; a range that overflows
    int64 falls back to 64-bit raw with minimum 0.
    """
    valid = torch.arange(v.shape[1], device=v.device)[None, :] < count[:, None]
    vmin = torch.where(valid, v, _I64_MAX).amin(dim=1)
    vmax = torch.where(valid, v, -_I64_MAX - 1).amax(dim=1)
    live = count > 0
    vmin = torch.where(live, vmin, 0)
    vmax = torch.where(live, vmax, 0)
    rng = vmax - vmin                        # wraps past 2^63
    overflow = rng < 0
    bits = torch.where(overflow, 64, bit_length(rng))
    return torch.where(overflow, 0, vmin), bits


def packed_words(count: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Number of uint32 words used by ``count`` values at width ``bits``."""
    return ((count.to(torch.int64) * bits + 31) // 32).to(torch.int32)


def _half_masks(bits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The low and high 32-bit halves of ``2^bits - 1`` (all ones at 64)."""
    b = bits.to(torch.int64)
    lo = torch.where(b >= 32, M32, (1 << b.clamp(0, 31)) - 1)
    hi = torch.where(b >= 64, M32, torch.where(b > 32, (1 << (b - 32).clamp(0, 31)) - 1, 0))
    return lo, hi


def pack(v: torch.Tensor, count: torch.Tensor, vmin: torch.Tensor, bits: torch.Tensor,
         cap_words: int) -> torch.Tensor:
    """Pack each row's ``(v[:count] - vmin)`` at width ``bits`` into
    ``uint32`` words (``int64[B, cap_words]``; words past
    :func:`packed_words` are zero).  Contributions to one word are
    bit-disjoint, so they are added (the reference's scatter-add, kept mod
    2^32 where a clamped index folds two onto the last word)."""
    B, cap = v.shape
    idx = torch.arange(cap, device=v.device, dtype=torch.int64)[None, :]
    b = bits.to(torch.int64)[:, None]
    d = v - vmin[:, None]
    mlo, mhi = _half_masks(bits)
    a_lo = d & mlo[:, None]
    b_hi = (d >> 32) & mhi[:, None]
    bitpos = idx * b
    widx = bitpos >> 5
    sh = bitpos & 31
    emit = (idx < count[:, None]) & (b > 0)
    lo_sh, hi_sh = a_lo << sh, b_hi << sh       # < 2^63: no sign bit reached
    parts = (lo_sh & M32, (lo_sh >> 32) | (hi_sh & M32), hi_sh >> 32)
    words = torch.zeros((B, cap_words), dtype=torch.int64, device=v.device)
    for off_k, part in enumerate(parts):
        words.scatter_add_(1, (widx + off_k).clamp(0, cap_words - 1), torch.where(emit, part, 0))
    return words & M32


def unpack(words: torch.Tensor, count_cap: int, bits: torch.Tensor,
           vmin: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack`: ``int64[B, count_cap]`` values (+ vmin,
    wrapping).  Entries past a row's count decode to garbage; callers mask."""
    nw = words.shape[1]
    idx = torch.arange(count_cap, device=words.device, dtype=torch.int64)[None, :]
    bitpos = idx * bits.to(torch.int64)[:, None]
    widx = (bitpos >> 5).clamp(0, nw - 1)
    sh = bitpos & 31
    f0 = words.gather(1, widx)
    f1 = words.gather(1, (widx + 1).clamp(max=nw - 1))
    f2 = words.gather(1, (widx + 2).clamp(max=nw - 1))
    mlo, mhi = _half_masks(bits)
    lo = ((f0 >> sh) | (f1 << (32 - sh))) & mlo[:, None]
    hi = ((f1 >> sh) | (f2 << (32 - sh))) & mhi[:, None]
    return (lo | (hi << 32)) + vmin[:, None]
