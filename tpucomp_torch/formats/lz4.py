"""LZ4 block format: options, size bound, constants and the match finder
of the parallel LZ programs.

Port of the parts of :mod:`tpucomp.formats.lz4` that the port's paths need
(``tpucomp/formats/lz4.py:49-70,186-297``).  The codec itself runs in the
Hopper kernels of :mod:`tpucomp_torch.ops.cuda` (and their plain versions);
:func:`_find_matches` serves the Zstandard multi-block encoder of
:mod:`tpucomp_torch.formats.zstd`.  The reference's log-depth LZ4 program
(``decode_chunk``, ``encode_chunk``, ``get_decompress_size``) is not ported
yet.
"""
from __future__ import annotations

import dataclasses

import torch

from tpucomp_torch.constants import ElementType
from tpucomp_torch.ops import parallel_lz as plz

MIN_MATCH = 4
MAX_OFFSET = 65535
# End-of-block rules from the LZ4 block spec.
LAST_LITERALS = 5
MF_LIMIT = 12
HASH_MULT = 2654435761


@dataclasses.dataclass(frozen=True)
class LZ4Opts:
    """Analog of ``nvcompBatchedLZ4Opts_t{ nvcompType_t data_type }``."""

    data_type: ElementType = ElementType.CHAR


DEFAULT_OPTS = LZ4Opts()


def max_compressed_chunk_size(max_chunk_bytes: int, opts: LZ4Opts = DEFAULT_OPTS) -> int:
    """Standard LZ4 worst-case bound, rounded up to a multiple of 1024 (the
    reference's value, kept so both packages size outputs alike)."""
    n = max_chunk_bytes + max_chunk_bytes // 255 + 16
    return (n + 1023) & ~1023


def _find_matches(data: torch.Tensor, size: torch.Tensor, run_dists: tuple[int, ...],
                  ext_words: int = 32, n_cands: int = 4,
                  probe_words: int = 2) -> tuple[torch.Tensor, torch.Tensor]:
    """Each position's best match ``(length, offset)``, length 0 where there
    is no legal match (``tpucomp/formats/lz4.py:186-297``), for ``data
    uint8[B, cap]`` and ``size int[B]`` -> ``int64[B, cap]`` each.

    The ``n_cands`` nearest earlier positions of the same 15-bit hash of the
    4-byte word are scored by a ``4 * probe_words``-byte prefix probe (longer
    wins, then nearer); the winner is extended word by word up to
    ``ext_words`` words, then byte by byte up to 3 more.  Exact runs at the
    periodic distances ``run_dists`` replace a shorter match; a position
    whose successor starts a longer match gives way to it (one-step lazy
    matching); the end-of-block rules cut the rest.

    As the reference, a word read past the row repeats its last byte
    (indices clamp to ``cap - 1``); the hash sort key ``h * cap + p`` is
    unique, so the order needs no tie rule.
    """
    B, cap = data.shape
    dev = data.device
    size = size.to(torch.int64)[:, None]
    p = torch.arange(cap, device=dev)[None]
    d = data.to(torch.int64)
    reach = 4 * max(probe_words, ext_words + 1) + 4
    dx = torch.cat([d, d[:, -1:].expand(B, reach + 3)], dim=1)
    words = dx[:, :-3] | (dx[:, 1:-2] << 8) | (dx[:, 2:-1] << 16) | (dx[:, 3:] << 24)

    def word_at(i):
        """The word at ``i``; reads at and past the row's end repeat its last
        byte; negative ``i`` (no candidate) is masked by every caller."""
        return torch.gather(words, 1, i.clamp(0, cap - 1))

    def word_from(c):                           # word_at(p + c): a view
        return words[:, c:c + cap]

    w4 = word_from(0)
    lo = (w4 & 0xFFFF) * HASH_MULT                # uint32 product in two halves:
    hi = ((w4 >> 16) * HASH_MULT) & 0xFFFF         # no int64 overflow
    h = ((lo + (hi << 16)) & 0xFFFFFFFF) >> 17     # 15-bit hash
    order = torch.argsort(h * cap + p, dim=1)
    h_o = torch.gather(h, 1, order)

    best_cand = torch.full((B, cap), -1, dtype=torch.int64, device=dev)
    best_score = torch.full((B, cap), -1, dtype=torch.int64, device=dev)
    for j in range(1, min(n_cands, cap) + 1):
        prev = torch.nn.functional.pad(order[:, :-j], (j, 0), value=-1)
        same = torch.nn.functional.pad(h_o[:, j:] == h_o[:, :-j], (j, 0))
        cj = torch.empty_like(order).scatter_(1, order, torch.where(same, prev, -1))
        okj = (cj >= 0) & (p - cj <= MAX_OFFSET) & (w4 == word_at(cj))
        score = torch.ones((B, cap), dtype=torch.int64, device=dev)
        run = torch.ones((B, cap), dtype=torch.bool, device=dev)
        for w in range(1, probe_words):
            run &= word_from(4 * w) == word_at(cj + 4 * w)
            score += run
        score = torch.where(okj, score, -1)
        better = score > best_score
        best_cand = torch.where(better, cj, best_cand)
        best_score = torch.where(better, score, best_score)
    cand = best_cand
    cand_ok = (cand >= 0) & (p + MIN_MATCH <= size)

    hlen = torch.full((B, cap), MIN_MATCH, dtype=torch.int64, device=dev)
    still = cand_ok
    for k in range(1, ext_words + 1):
        still = still & (word_from(4 * k) == word_at(cand + 4 * k))
        hlen += torch.where(still, 4, 0)
    beq = cand_ok & ~still
    for _ in range(3):
        i1 = (p + hlen).clamp(0, cap - 1)
        i2 = (cand + hlen).clamp(0, cap - 1)
        beq = beq & (torch.gather(d, 1, i1) == torch.gather(d, 1, i2))
        hlen += beq
    best_len = torch.where(cand_ok, hlen, 0)
    best_off = torch.where(cand_ok, p - cand, 1)

    for dist in sorted(set(run_dists)):
        if dist <= 0 or dist > MAX_OFFSET or dist >= cap:
            continue
        shifted = torch.nn.functional.pad(d[:, :-dist], (dist, 0))
        eq = (d == shifted) & (p >= dist) & (p < size)
        rlen = plz.suffix_run_length(eq)
        better = (rlen >= MIN_MATCH) & (rlen > best_len)
        best_len = torch.where(better, rlen, best_len)
        best_off = torch.where(better, dist, best_off)

    next_len = torch.nn.functional.pad(best_len[:, 1:], (0, 1))
    best_len = torch.where(next_len > best_len, 0, best_len)

    best_len = torch.minimum(best_len, (size - LAST_LITERALS - p).clamp(min=0))
    legal = (best_len >= MIN_MATCH) & (p + MF_LIMIT <= size)
    return torch.where(legal, best_len, 0), best_off
