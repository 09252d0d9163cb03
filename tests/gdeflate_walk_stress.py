"""Chunks that stress the GDeflate encoder's token walk and its emission.

Shared by ``tests/test_torch_gdeflate_walk.py`` (the plain parse pieces
against the serial walk ``deflate_encode._walk``), ``tests/test_torch_cuda.py``
and ``chip_smoke.py`` (the fixed and emit kernels against their plain
versions).  Every chunk is made from a fixed seed:

- ``back_to_0``: a random 1000-byte block written twice, with one candidate
  kept (position 1005 -> 5): the match back-extends until its source reaches
  position 0, and the 258 cap cuts it;
- ``thin_text``, ``thin_repeat``: text (``deflate_stress._text``) and a
  700-byte block repeated 40 times, with candidates2's candidates thinned
  at random (one kept in four): matches back-extend through the positions
  whose candidate was dropped, up to the previous candidate or the anchor,
  with and without the 258 cap;
- ``cand8_wins``: a prefix that cand (the nearest 4-byte match) extends
  short and cand8 (the 8-byte-prefix neighbour) extends long;
- ``repeat_cap``: a random block repeated, matches cut at 258 with no back
  extension;
- ``end_at_mflimit_k``: a match whose last byte is ``k`` (2, 3, 4) bytes
  before the end, so it ends one before, at and one after mflimit
  (size - 3); ``end_at_size``: a match that runs to the last byte;
- ``size_n`` for n in 0..8 (two letters in turn: from 6 bytes on, a match),
  ``mixed_65535`` and ``mixed_65536``;
- ``run_64k``: 64 KiB of one byte; ``random_64k``: 64 KiB of random bytes,
  which :func:`long_code_table` pushes past a lane's 832 words (``emit``).

:func:`candidates` gives each chunk candidates2's arrays, thinned where the
name says so (``nxt`` recomputed as the next position with a candidate).
"""
from __future__ import annotations

import numpy as np
import torch

from deflate_stress import _text
from tpucomp_torch.chunk import ChunkBatch
from tpucomp_torch.ops import match
from tpucomp_torch.utils import synth

CAP = 65536


def rows(seed: int = 13) -> list[tuple[str, bytes]]:
    """``(name, chunk)`` for every stress chunk, in a fixed order."""
    rng = np.random.default_rng(seed)
    block = bytes(rng.integers(0, 256, 1000, dtype=np.uint8))
    rep = bytes(rng.integers(0, 256, 700, dtype=np.uint8))
    long_tail = bytes(rng.integers(0, 256, 300, dtype=np.uint8))
    short_tail = bytes(rng.integers(0, 256, 9, dtype=np.uint8))
    head = bytes(rng.integers(0, 256, 100, dtype=np.uint8))
    out = [("back_to_0", block + block),
           ("thin_text", _text(rng, 20000)),
           ("thin_repeat", rep * 40),
           # "PQRS" + long_tail at 0, "PQRS" + short_tail at 1000, then
           # "PQRS" + long_tail again: cand is 1000 (4 + 0 bytes), cand8 is 0
           ("cand8_wins", b"PQRS" + long_tail + bytes(696) + b"PQRS" + short_tail
            + bytes(200) + b"PQRS" + long_tail),
           ("repeat_cap", block * 8)]
    for k in (2, 3, 4):  # the copy of head[:50] ends k bytes before the end
        out.append((f"end_at_mflimit_{k}", head + head[:50] + bytes([255 - i for i in range(k)])))
    out.append(("end_at_size", head + head[:60]))
    out += [(f"size_{n}", bytes([65 + (i % 2) for i in range(n)])) for n in range(9)]
    mixed = synth.mixed_corpus(CAP + 64, seed=seed)[:CAP].tobytes()
    out += [("mixed_65535", mixed[:65535]), ("mixed_65536", mixed)]
    out += [("run_64k", b"\x07" * CAP),
            ("random_64k", bytes(rng.integers(0, 256, CAP, dtype=np.uint8)))]
    return out


def batch(seed: int = 13) -> tuple[ChunkBatch, list[str]]:
    """The stress chunks as one CPU batch of 64 KiB rows, and their names."""
    named = rows(seed)
    return (ChunkBatch.from_chunks([c for _, c in named], CAP, device="cpu"),
            [n for n, _ in named])


def _thin(cand: torch.Tensor, cand8: torch.Tensor, keep: torch.Tensor):
    """Drop the candidates of one row where ``keep`` is False; nxt again."""
    cap = cand.shape[0]
    cand = torch.where(keep, cand, -1)
    cand8 = torch.where(keep, cand8, -1)
    pos = torch.arange(cap, dtype=torch.int32)
    marked = torch.where((cand >= 0) | (cand8 >= 0), pos, cap)
    nxt = torch.flip(torch.cummin(torch.flip(marked, [0]), 0).values, [0])
    return cand, cand8, nxt.to(torch.int32)


def candidates(cb: ChunkBatch, names: list[str], seed: int = 13, window: int = 65535):
    """candidates2's ``(cand, cand8, nxt)`` for the batch (over ``window``:
    candidates2's default, as GDeflate's encoder calls it, or Deflate's 32
    KiB), thinned for the rows named
    ``back_to_0`` (one candidate kept) and ``thin_*`` (one kept in four, at
    random)."""
    cand, cand8, nxt = (c.clone() for c in match.candidates2(cb.data, cb.sizes, window=window))
    gen = torch.Generator().manual_seed(seed)
    for i, name in enumerate(names):
        if name == "back_to_0":
            keep = torch.zeros(cb.data.shape[1], dtype=torch.bool)
            keep[1005] = True
        elif name.startswith("thin_"):
            keep = torch.rand(cb.data.shape[1], generator=gen) < 0.25
        else:
            continue
        cand[i], cand8[i], nxt[i] = _thin(cand[i], cand8[i], keep)
    return cand, cand8, nxt


def long_code_table(B: int) -> torch.Tensor:
    """An ``emit`` table ``int32[B, 320]`` of 15-bit codes for every symbol
    (bit-reversed code | 15 << 16): 64 KiB of literals then need 960 words a
    lane, past the 832 a lane may hold."""
    codes = torch.arange(320, dtype=torch.int32) * 97 % (1 << 15)
    rev = torch.zeros_like(codes)
    for b in range(15):
        rev |= ((codes >> b) & 1) << (14 - b)
    return (rev | (15 << 16)).expand(B, 320).contiguous()
