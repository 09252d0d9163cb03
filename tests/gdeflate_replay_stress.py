"""Token rows that stress the GDeflate replay (kernel row 14).

Each row is a tile's tokens in the parse's packing (a literal is its byte, a
match ``1 << 25 | (mlen - 3) << 17 | dist``), for an ``out_cap`` whose token
capacity is the parse's, ``(out_cap // 32 + 1) * 32``.  They cover every
literal, no token and a full capacity of tokens; periodic runs at distances
1 to 8 of 258-byte matches (one run each in the window kernel); a distance
past op early (token 3) and late (after the first token not written); a
match that passes ``out_cap`` mid-tile and a literal at ``out_cap``; copies
whose source chains take 14 or more rounds of pointer jumping; matches at
one distance across the window kernel's slabs of 8192 tokens; a distance
of 0 and one equal to op; and random mixes.  ``tests/test_torch_gdeflate_replay.py``
holds the window kernel's plain pieces against ``exec_plain`` on them, and
``chip_smoke.py`` and ``tests/test_torch_cuda.py`` both kernels.
"""
from __future__ import annotations

import numpy as np

MATCH_FLAG = 1 << 25
OUT_CAPS = (65536, 1000, 66560)


def ntok_cap(out_cap: int) -> int:
    """The parse's token capacity at ``out_cap``."""
    return (out_cap // 32 + 1) * 32


def match(length: int, dist: int) -> int:
    return MATCH_FLAG | (length - 3) << 17 | dist


def _random(rng, n_tok: int, p_match: float, max_len: int) -> list[int]:
    """Random literals and matches with distances in 1..op (some repeated)."""
    out, op, last = [], 0, 1
    for _ in range(n_tok):
        if op > 0 and rng.random() < p_match:
            dist = last if rng.random() < 0.3 else int(rng.integers(1, op + 1))
            length = int(rng.integers(3, max_len + 1))
            out.append(match(length, min(dist, op)))
            op, last = op + length, min(dist, op)
        else:
            out.append(int(rng.integers(0, 256)))
            op += 1
    return out


def rows(out_cap: int) -> list[tuple[str, np.ndarray]]:
    """The stress rows at ``out_cap``: (name, int32 tokens) each, at most
    :func:`ntok_cap` tokens."""
    rng = np.random.default_rng(17)
    cap = ntok_cap(out_cap)
    lits = rng.integers(0, 256, 65536).tolist()
    periodic = []
    for d in range(1, 9):
        periodic += lits[:d] + [match(258, d)] * 30
    chain = [7, 9]            # 1 and 2 in turn: the runs never merge
    while len(chain) < 21000:
        chain.append(match(3, 1 + len(chain) % 2))
    fill = lits[:out_cap]     # exactly out_cap bytes of literals
    out = {
        "all literals": lits,
        "no token": [],
        "full capacity": (lits[:40] + [match(100, 17)] * cap)[:cap],
        "periodic runs, distances 1 to 8": periodic,
        "distance past op early": [1, 2, match(5, 3)] + lits[:200],
        "distance past op late": lits[:out_cap - 10] + [match(50, 4)] + lits[:30]
                                 + [match(4, 0x1FFFF)] + lits[:5],
        "match past out_cap mid-tile": lits[:out_cap - 100] + [match(258, 40)] + lits[:50]
                                       + [match(4, 3)],
        "literal at out_cap": fill + [5] + [match(10, 2)],
        "chains of 14 or more jumps": chain,
        "one distance across slabs": [1, 2, 3, 4, 5] + [match(3, 5)] * 20000,
        "distance 0": lits[:20] + [match(6, 0)] + lits[:20],
        "distance equal to op": lits[:300] + [match(258, 300)] + [match(7, 558)] + lits[:9],
        "random, short matches": _random(rng, 30000, 0.3, 12),
        "random, long matches": _random(rng, 4000, 0.6, 258),
    }
    return [(name, np.asarray(t[:cap], np.int32)) for name, t in out.items()]


def batch(out_cap: int):
    """The rows as the replay takes them: ``(tokens int32[B, ntok_cap],
    n_tok int32[B], names)``, tokens past each count 0."""
    named = rows(out_cap)
    cap = ntok_cap(out_cap)
    toks = np.zeros((len(named), cap), np.int32)
    n = np.zeros(len(named), np.int32)
    for i, (_, t) in enumerate(named):
        toks[i, :len(t)] = t
        n[i] = len(t)
    return toks, n, [name for name, _ in named]
