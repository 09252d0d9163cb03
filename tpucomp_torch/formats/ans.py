"""rANS: the batched, 128-lane interleaved entropy codec (container constants,
options, bound, the encoder's tables and serialization, size query).

Port of the part of :mod:`tpucomp.formats.ans` that the kernel path needs
(``tpucomp/formats/ans.py:41-109,179-237,320-325``).  The state walks run in
the Hopper kernels of :mod:`tpucomp_torch.ops.cuda`
(:mod:`~tpucomp_torch.ops.cuda.ans_decode`,
:mod:`~tpucomp_torch.ops.cuda.ans_encode`) and their plain versions; the
reference's XLA program (``encode_chunk``, ``decode_chunk``) is ROADMAP A.6.

128 independent rANS states per chunk, lane ``j`` owning positions ``j, j +
128, ...``; 32-bit states, 16-bit renormalization, 12-bit frequencies.  All
lanes share one word stream in the order the decoder consumes it
(step-major, lane-minor).

Chunk format v2 (little-endian): u8 magic 0xA5, u8 version 2, u16 reserved,
u32 size, u32 total_words, u16 freq[256] (sum 4096), u32 state[128], u16
wcount[128] (per-lane word counts, validation only), then the shared u16
stream.

Everything here runs over the batch in torch ops (``[B, 256]`` and ``[B, T *
128]`` tensors), with no loop over chunks.
"""
from __future__ import annotations

import dataclasses

import torch

from tpucomp_torch.chunk import wrap_i32
from tpucomp_torch.constants import Status

MAGIC = 0xA5
VERSION = 2
N_LANES = 128
PROB_BITS = 12
PROB_SCALE = 1 << PROB_BITS
RANS_L = 1 << 16
HEADER_BYTES = 12 + 512 + 512 + 256  # fixed fields + freq + states + wcounts


@dataclasses.dataclass(frozen=True)
class ANSOpts:
    """Analog of ``nvcompBatchedANSOpts_t`` (single-value enum in 3.0.3)."""


DEFAULT_OPTS = ANSOpts()


def max_compressed_chunk_size(max_chunk_bytes: int, opts: ANSOpts = DEFAULT_OPTS) -> int:
    """Worst case: one u16 emitted per symbol plus the fixed header."""
    n = HEADER_BYTES + 2 * max_chunk_bytes + 64
    return (n + 1023) & ~1023


def quantize_freqs(counts: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    """Quantize ``[B, 256]`` byte counts to 12-bit frequencies summing to
    PROB_SCALE (``ans.py:74-104``): floor scaling, present symbols at least
    1, the remaining budget to the largest remainders (a stable sort, ties to
    the lower symbol), then exactly four correction rounds on the first
    largest frequency.  Returns int32 ``[B, 256]``."""
    counts = counts.to(torch.int64)
    size = torch.clamp(size.to(torch.int64), min=1)[:, None]
    scaled = counts * PROB_SCALE
    base = scaled // size
    rem = scaled - base * size
    base = torch.where((counts > 0) & (base == 0), 1, base)
    budget = PROB_SCALE - base.sum(dim=1, keepdim=True)
    order = torch.argsort(-rem, dim=1, stable=True)
    ranks = torch.arange(256, device=counts.device)[None, :]
    bonus = torch.zeros_like(base).scatter_(1, order, (ranks < budget).to(torch.int64))
    freq = base + torch.where(counts > 0, bonus, 0)
    for _ in range(4):
        resid = PROB_SCALE - freq.sum(dim=1, keepdim=True)
        top = torch.argmax(freq, dim=1, keepdim=True)
        at_top = freq.gather(1, top)
        freq = freq.scatter(1, top, at_top + torch.clamp(resid, min=1 - at_top))
    return freq.to(torch.int32)


def tables_for(data: torch.Tensor, size: torch.Tensor):
    """Quantized ``(freq, cum)`` int32 ``[B, 256]`` tables of each row of
    ``data uint8[B, cap]`` over its first ``size`` bytes (``ans.py:109-117``)."""
    B, cap = data.shape
    live = torch.arange(cap, device=data.device)[None, :] < size.to(torch.int64)[:, None]
    counts = torch.zeros((B, 256), dtype=torch.int64, device=data.device)
    counts.scatter_add_(1, data.to(torch.int64), live.to(torch.int64))
    freq = quantize_freqs(counts, size)
    cum = torch.cumsum(freq, dim=1, dtype=torch.int32) - freq
    return freq, cum


def _le_bytes(v: torch.Tensor, nbytes: int) -> torch.Tensor:
    """``[B, k]`` integers (int32 bit patterns) -> ``uint8[B, k * nbytes]``,
    little-endian."""
    v = v.to(torch.int32)
    parts = [((v >> (8 * i)) & 0xFF).to(torch.uint8) for i in range(nbytes)]
    return torch.stack(parts, dim=2).reshape(v.shape[0], -1)


def serialize_scan(size, freq, x_fin, wcount, words_dec, emits_dec, out_cap: int):
    """Compact and serialize a state walk's outputs into v2 frames
    (``ans.py:179-237``): ``words_dec``/``emits_dec`` are ``[B, T, 128]`` in
    decode order, words as int16 (u16 bit patterns).  The shared stream is
    the row-major compaction of the emitted words: a cumsum, then one
    scatter straight into the frame rows (the same bytes as the reference's
    sort of packed keys).  Bytes past a frame are zero.

    A frame longer than ``out_cap`` gives ``ERROR_OUTPUT_BUFFER_TOO_SMALL``
    and size 0, and its row keeps the frame's first ``out_cap`` bytes, as
    the reference's does."""
    B, T, N = words_dec.shape
    dev = words_dec.device
    emits = (emits_dec != 0).reshape(B, T * N)
    total_words = emits.sum(dim=1)
    pos = torch.cumsum(emits, dim=1, dtype=torch.int32) - 1
    idx = torch.where(emits, pos, T * N).to(torch.int64)   # non-emits: a dropped slot
    # the rows as built: at least the header, the stream and the dropped slot,
    # an even width so the stream is an int16 view
    width = max(out_cap, HEADER_BYTES + 2 * (T * N + 1))
    width += width & 1
    rows = torch.zeros((B, width), dtype=torch.uint8, device=dev)
    rows[:, :HEADER_BYTES] = torch.cat([
        torch.tensor([MAGIC, VERSION, 0, 0], dtype=torch.uint8, device=dev).expand(B, 4),
        _le_bytes(size[:, None], 4), _le_bytes(total_words[:, None], 4),
        _le_bytes(freq, 2), _le_bytes(x_fin, 4), _le_bytes(wcount, 2)], dim=1)
    stream = rows[:, HEADER_BYTES:HEADER_BYTES + 2 * (T * N + 1)].view(torch.int16)
    stream.scatter_(1, idx, words_dec.reshape(B, T * N).to(torch.int16))
    stream[:, T * N] = 0
    out = rows if width == out_cap else rows[:, :out_cap].contiguous()
    out_size = HEADER_BYTES + 2 * total_words
    too_big = out_size > out_cap
    status = torch.where(too_big, int(Status.ERROR_OUTPUT_BUFFER_TOO_SMALL),
                         int(Status.SUCCESS)).to(torch.int32)
    return out, torch.where(too_big, 0, out_size).to(torch.int32), status


def get_decompress_size(comp: torch.Tensor, comp_sizes: torch.Tensor) -> torch.Tensor:
    """The header's ``size`` of each frame (``ans.py:320-325``), read as int32
    (a value of 2^31 or more is negative, as the reference's); 0 where the
    frame is shorter than 12 bytes or its magic is wrong.  A row narrower
    than 8 bytes repeats its last byte, as the reference's clipped reads."""
    B, n = comp.shape
    if n == 0:
        return torch.zeros(B, dtype=torch.int32, device=comp.device)
    at = torch.clamp(torch.arange(8, device=comp.device), max=n - 1)
    b = comp[:, at].to(torch.int64)
    size = wrap_i32(b[:, 4] | (b[:, 5] << 8) | (b[:, 6] << 16) | (b[:, 7] << 24))
    ok = (comp_sizes.to(device=comp.device) >= 12) & (b[:, 0] == MAGIC)
    return torch.where(ok, size, 0).to(torch.int32)
