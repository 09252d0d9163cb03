"""Chunks that stress the Zstandard encoder's gated parse.

Shared by ``tests/test_torch_encode_parse.py`` (the full kernel's plain
pieces against the serial walk ``zstd_encode._walk``),
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` (the full kernel against
``full_plain``).  The walk keeps a candidate when its offset is on the
repeat stack or ``ml * 5 >= floor(log2 offset) + 18``; these rows make each
of its rules decide some sequence.  Every chunk is made from a fixed seed:

- ``rep_start``: 4-byte matches at offsets 8, 4 and 1 at the start: the
  initial repeat offsets (8 fails the gate: 20 < 21, and is kept as a
  repeat);
- ``rep_far``: 12-byte matches at offsets around 1000 (the gate keeps them),
  each followed by a 5-byte match at the same offset (25 < 27: kept only
  because the offset is a repeat);
- ``rep_ll0``: two blocks copied back to back, the second's candidate a few
  bytes into the copy, so its back extension reaches the anchor (no
  literals: the shifted repeat codes); the second block's offset is the one
  before the last;
- ``back_only``: 6-byte copies at offsets past 256 whose candidate is their
  second byte (5 * 5 < 26), kept only through the back extension;
- ``thin_text_z``: text with one candidate kept in four;
- ``run_64k`` (one match of 65,532 bytes), ``repeat_cap`` (matches far past
  258), ``end_at_mflimit_k``, ``size_n`` for n in 0..8, ``mixed_65535``,
  ``mixed_65536`` and ``random_64k`` (literals only) from
  ``tests/gdeflate_walk_stress.py``.

:func:`candidates` gives candidates2's arrays over the 64 KiB window,
thinned where the name says so (``nxt`` recomputed).
"""
from __future__ import annotations

import numpy as np
import torch

import gdeflate_walk_stress as gws
from deflate_stress import _text
from tpucomp_torch.chunk import ChunkBatch
from tpucomp_torch.ops import match

CAP = 65536
WINDOW = 65536          # the zstd encoder's candidates2 window
_FROM_GWS = ("repeat_cap", "end_at_mflimit_2", "end_at_mflimit_3", "end_at_mflimit_4",
             *(f"size_{n}" for n in range(9)), "mixed_65535", "mixed_65536", "run_64k",
             "random_64k")


def rows(seed: int = 17) -> list[tuple[str, bytes]]:
    """``(name, chunk)`` for every stress chunk, in a fixed order."""
    rng = np.random.default_rng(seed)
    rnd = lambda n: bytes(rng.integers(0, 256, n, dtype=np.uint8))  # noqa: E731
    head = rnd(8)
    rep_start = bytearray(head + head[:4] + rnd(1))     # offset 8 at position 8
    x = rnd(1)
    rep_start += rnd(3) + x * 6 + rnd(20)               # offset 1 (a run)
    y = rnd(4)
    rep_start += y + y + rnd(40)                        # offset 4
    rep_far = bytearray(rnd(1200))
    for _ in range(12):
        at = len(rep_far) - 1000
        rep_far += rep_far[at:at + 12] + rnd(30)
        at = len(rep_far) - 1000
        rep_far += rep_far[at:at + 5] + rnd(30)
    a_blk, b_blk = rnd(300), rnd(300)
    rep_ll0 = bytearray(a_blk + rnd(200) + b_blk + rnd(500))
    for _ in range(6):
        rep_ll0 += a_blk + b_blk + rnd(100)
    back_only = bytearray(rnd(2000))
    for _ in range(40):
        at = len(back_only) - int(rng.integers(300, 1500))
        back_only += back_only[at:at + 6] + rnd(25)
    named = [("rep_start", bytes(rep_start)), ("rep_far", bytes(rep_far)),
             ("rep_ll0", bytes(rep_ll0)), ("back_only", bytes(back_only)),
             ("thin_text_z", _text(rng, 16000))]
    g = dict(gws.rows())
    return named + [(n, g[n]) for n in _FROM_GWS]


def batch(seed: int = 17) -> tuple[ChunkBatch, list[str]]:
    """The stress chunks as one CPU batch of 64 KiB rows, and their names."""
    named = rows(seed)
    return (ChunkBatch.from_chunks([c for _, c in named], CAP, device="cpu"),
            [n for n, _ in named])


def candidates(cb: ChunkBatch, names: list[str], seed: int = 17):
    """candidates2's ``(cand, cand8, nxt)`` over the 64 KiB window, thinned
    for ``rep_ll0`` (the second block's candidates only from its 9th byte
    on), ``back_only`` (each copy's candidate at its second byte only) and
    ``thin_text_z`` (one kept in four, at random)."""
    cand, cand8, nxt = (c.clone() for c in match.candidates2(cb.data, cb.sizes, window=WINDOW))
    gen = torch.Generator().manual_seed(seed)
    for i, name in enumerate(names):
        cap = cb.data.shape[1]
        pos = torch.arange(cap)
        if name == "thin_text_z":
            keep = torch.rand(cap, generator=gen) < 0.25
        elif name == "rep_ll0":
            # in each copy of a_blk + b_blk, no candidate at b_blk's first 8 bytes
            keep = torch.ones(cap, dtype=torch.bool)
            for k in range(6):
                start = 1300 + k * 700 + 300
                keep[start:start + 8] = False
        elif name == "back_only":
            # candidates only where a position and the one before both match
            # 4 bytes back at the same distance: each copy's second byte
            c4 = cand[i]
            prev = torch.cat([torch.tensor([-1]), c4[:-1]])
            keep = (c4 >= 0) & (prev >= 0) & (c4 - prev == 1) & \
                   ~torch.cat([torch.tensor([False, False]), (c4[:-2] >= 0)])
        else:
            continue
        cand[i], cand8[i], nxt[i] = gws._thin(cand[i], cand8[i], keep & (pos < cap))
    return cand, cand8, nxt
