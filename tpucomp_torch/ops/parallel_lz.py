"""Primitives of the parallel LZ programs, in torch ops over a leading batch
dimension.

Port of :mod:`tpucomp.ops.parallel_lz` (``tpucomp/ops/parallel_lz.py:33-128``):
the dump slots of masked scatters, run lengths, and the pointer-doubling
walk that recovers the token chain of a speculative parse.  The reference
runs them per chunk under ``vmap``; here every function takes ``[B, n]``
and works on all rows at once, on whatever device they are on.
"""
from __future__ import annotations

import torch

# A scatter that sends its masked-off lanes to one slot serializes on the
# colliding writes; every masked scatter instead spreads them over DUMP_SLOTS
# slots past the live region, keyed by lane, and cuts those off afterwards.
DUMP_SLOTS = 512


def dump_spread(pos: torch.Tensor, base) -> torch.Tensor:
    """Overflow target for masked scatters: ``base + (pos & (DUMP_SLOTS - 1))``.
    The destination needs ``DUMP_SLOTS`` extra slots past ``base``."""
    return base + (pos & (DUMP_SLOTS - 1))


def prefix_run_length(pred: torch.Tensor) -> torch.Tensor:
    """For each i, the number of consecutive True values of ``pred[..., :i+1]``
    that end at i (``parallel_lz.py:53-63``)."""
    idx = torch.arange(pred.shape[-1], device=pred.device).expand(pred.shape)
    last_false = torch.cummax(torch.where(pred, -1, idx), dim=-1).values
    return idx - last_false


def suffix_run_length(pred: torch.Tensor) -> torch.Tensor:
    """For each i, the number of consecutive True values of ``pred[..., i:]``
    that start at i (``parallel_lz.py:44-50``)."""
    return prefix_run_length(pred.flip(-1)).flip(-1)


def wyllie_path(nxt: torch.Tensor, num_rounds: int, start: int = 0) -> torch.Tensor:
    """Pointer-jumping walk over a functional graph, gather only
    (``parallel_lz.py:72-128``, without its weight sums, which no caller here
    reads).

    ``nxt int[B, n]``: each position's successor, ``> i``; values ``>= n``
    are terminal.  Returns ``reach bool[B, n]``: the positions on the chain
    from ``start``.  ``2**num_rounds`` must cover the longest chain.

    Builds the jump tables ``F_k`` (the position ``2^k`` steps on) by
    doubling, int32 each, then every position walks a binary descent from
    ``start`` that never overshoots it: it lies on the chain exactly when the
    walk lands on it.
    """
    B, n = nxt.shape
    F = nxt.clamp(0, n).to(torch.int32)
    Fs = []
    for _ in range(num_rounds):
        Fs.append(F)
        F = torch.where(F < n, torch.gather(F, 1, F.clamp(max=n - 1).long()), F)

    p = torch.arange(n, device=nxt.device, dtype=torch.int32)[None]
    q = torch.full((B, n), start, dtype=torch.int32, device=nxt.device)
    for Fk in reversed(Fs):
        live = q < n
        cand = torch.where(live, torch.gather(Fk, 1, q.clamp(max=n - 1).long()), n)
        q = torch.where((cand <= p) & live, cand, q)
    return (q == p) & (p >= start)
