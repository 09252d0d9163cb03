"""Sort-based match finding for the LZ-family encoders, in torch ops.

Port of :mod:`tpucomp.ops.match` (XLA in the reference, not a Pallas kernel, so
it stays tensor code on the card too).  For every position ``p`` of a chunk:

1. form the 4-byte word starting at ``p`` (shifted byte views),
2. stable-sort ``(word, position)``: equal words become adjacent with
   positions ascending, so each element's predecessor under the same word is
   the nearest previous occurrence of these 4 bytes,
3. un-sort (scatter by position) to get a per-position candidate, and
4. a suffix min for ``next_match[p]``, the first position ``>= p`` that has a
   candidate, so the emitter jumps literal runs in O(1).

The outputs must equal the reference's element for element, because every
byte the encoder emits depends on them.  Two details carry that:

* the reference compares words as **signed int32**; the 8-byte-prefix sort
  orders ``w1`` signed inside equal ``w0``, which decides which neighbours
  are adjacent.  Here one stable sort of the int64 key
  ``w0 * 2**32 + (w1 + 2**31)`` (``w0``, ``w1`` signed) gives that order;
* padding positions (past ``size - 4``) take part in the sorts exactly as in
  the reference and are filtered afterwards.
"""
from __future__ import annotations

import torch

MIN_MATCH = 4


def _words(data: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Little-endian words at every position, bytes past the end read as 0:
    ``(w0, w1)`` as int64 holding the **signed** int32 values of bytes
    ``p..p+3`` and ``p+4..p+7``."""
    B, cap = data.shape
    x = torch.nn.functional.pad(data.to(torch.int64), (0, 7))

    def word(k):
        w = (x[:, k:k + cap] | (x[:, k + 1:k + 1 + cap] << 8)
             | (x[:, k + 2:k + 2 + cap] << 16) | (x[:, k + 3:k + 3 + cap] << 24))
        return w - ((w >> 31) << 32)        # unsigned 32-bit -> signed

    return word(0), word(4)


def _suffix_min(marked: torch.Tensor) -> torch.Tensor:
    return torch.flip(torch.cummin(torch.flip(marked, [1]), dim=1).values, [1])


def _unsort(order: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Inverse of a sort permutation: ``out[order[i]] = vals[i]``."""
    return torch.empty_like(vals).scatter_(1, order, vals)


def _chain(w0: torch.Tensor, pos: torch.Tensor, sizes: torch.Tensor,
           window: int) -> torch.Tensor:
    """4-byte nearest-previous chain -> ``cand int64[B, cap]``."""
    sw, sp = torch.sort(w0, dim=1, stable=True)
    first = pos == 0
    same = (sw == torch.roll(sw, 1, 1)) & ~first
    prev = torch.roll(sp, 1, 1)
    lim = sizes[:, None] - MIN_MATCH
    sv = sp <= lim
    good = same & sv & torch.roll(sv, 1, 1)
    cand = _unsort(sp, torch.where(good, prev, -1))
    cand = torch.where(pos - cand <= window, cand, -1)
    return torch.where(pos <= lim, cand, -1)


def candidates(data: torch.Tensor, sizes: torch.Tensor, window: int = 65535):
    """Per-position match candidates for a batch of chunks.

    Args:
      data:  ``uint8[B, cap]`` chunk payloads (padded).
      sizes: ``int32[B]`` valid byte counts.
      window: maximum backward offset (65535 for LZ4's 16-bit offsets).

    Returns:
      ``(cand, nxt)``, both ``int32[B, cap]``: ``cand[p]`` is the nearest
      previous position whose 4 starting bytes equal position ``p``'s (-1 if
      none within ``window`` / validity limits); ``nxt[p]`` is the smallest
      ``q >= p`` with ``cand[q] >= 0`` (``cap`` if none).
    """
    B, cap = data.shape
    sizes = sizes.to(torch.int64)
    pos = torch.arange(cap, device=data.device)[None, :]
    w0, _ = _words(data)
    cand = _chain(w0, pos, sizes, window)
    nxt = _suffix_min(torch.where(cand >= 0, pos, cap))
    return cand.to(torch.int32), nxt.to(torch.int32)


def candidates2(data: torch.Tensor, sizes: torch.Tensor, window: int = 65535):
    """Two-candidate variant of :func:`candidates` -> ``(cand, cand8, nxt)``.

    ``cand8`` is the nearest 8-byte-prefix sort neighbour with a smaller
    position (-1 where absent or equal to ``cand``); emitters extend both and
    keep the longer match.  ``nxt`` marks positions where either exists.
    """
    B, cap = data.shape
    sizes = sizes.to(torch.int64)
    pos = torch.arange(cap, device=data.device)[None, :]
    lim = sizes[:, None] - MIN_MATCH
    w0, w1 = _words(data)
    cand = _chain(w0, pos, sizes, window)

    # ---- 8-byte-prefix sort neighbours: stable sort by (w0, w1), pos ----
    key = w0 * (1 << 32) + (w1 + (1 << 31))
    del w1
    _, sp8 = torch.sort(key, dim=1, stable=True)
    del key
    s0 = torch.gather(w0, 1, sp8)
    sv8 = sp8 <= lim

    def neigh(offs):
        ow = torch.roll(s0, offs, 1)
        op = torch.roll(sp8, offs, 1)
        ov = torch.roll(sv8, offs, 1)
        edge = (pos < offs) if offs > 0 else (pos >= cap + offs)
        ok = (ow == s0) & (op < sp8) & sv8 & ov & ~edge
        return torch.where(ok, op, -1)

    c8s = torch.maximum(torch.maximum(neigh(1), neigh(2)),
                        torch.maximum(neigh(-1), neigh(-2)))
    cand8 = _unsort(sp8, c8s)
    cand8 = torch.where(pos - cand8 <= window, cand8, -1)
    cand8 = torch.where(pos <= lim, cand8, -1)
    cand8 = torch.where(cand8 == cand, -1, cand8)   # only keep a SECOND option

    nxt = _suffix_min(torch.where((cand >= 0) | (cand8 >= 0), pos, cap))
    return cand.to(torch.int32), cand8.to(torch.int32), nxt.to(torch.int32)
