"""Batched rANS encode: the 128-lane state walk as a Hopper kernel, with its
plain version, between the tables and the serialization in torch ops.

Port of :mod:`tpucomp.ops.pallas.ans_encode` (``compress_batch`` /
``_kernel`` and ``compress_batch_wide`` / ``_kernel_wide``).  One kernel in
``csrc/ans_encode.cu`` (one warp per chunk over ``csrc/ans.cuh``'s
``encode_block``; its header says what it replaces, what bounds it and how
it is built): :func:`walk_kernel` (row 24) launches one chunk per block,
:func:`walk_kernel_wide` (row 25) eight.  Around it, as in the reference
(``ans_encode.py:33-34``), :func:`tpucomp_torch.formats.ans.tables_for`
quantizes the frequencies and :func:`~tpucomp_torch.formats.ans
.serialize_scan` compacts the shared stream and writes the frames.
:func:`compress_batch` and :func:`compress_batch_wide` (the one ``batched``
dispatches) give byte-identical frames; :func:`compress_batch_plain` runs
:func:`walk_plain`, a Python loop over the rows of ``[B, 128]`` states.

Contract: ``data uint8[B, cap]`` plus ``sizes int32[B]`` (each in ``[0,
cap]``; values outside are clamped, ROADMAP §C) -> ``(out uint8[B, out_cap],
out_sizes int32[B], statuses int32[B])``.  A frame longer than ``out_cap``
gives ``ERROR_OUTPUT_BUFFER_TOO_SMALL`` and size 0, and its row keeps the
frame's first ``out_cap`` bytes, as the reference's does.
"""
from __future__ import annotations

import ctypes

import torch

from tpucomp_torch.chunk import wrap_i32
from tpucomp_torch.formats.ans import N_LANES, PROB_BITS, RANS_L, serialize_scan, tables_for
from tpucomp_torch.ops.cuda import _build


def _clamped_sizes(data: torch.Tensor, sizes: torch.Tensor) -> torch.Tensor:
    return sizes.to(device=data.device, dtype=torch.int32).clamp(0, data.shape[1])


def walk_plain(data: torch.Tensor, sizes: torch.Tensor, freq: torch.Tensor,
               cum: torch.Tensor):
    """Plain version of :func:`walk_kernel`: ``(words int16[B, T, 128] (u16 bit
    patterns), emits uint8[B, T, 128], x_fin int32[B, 128] (u32 bit
    patterns), wcount int32[B, 128])`` on ``data``'s device, ``T =
    ceil(cap / 128)``, rows in decode order."""
    i64 = torch.int64
    dev = data.device
    B, cap = data.shape
    T = -(-cap // N_LANES)
    sizes = _clamped_sizes(data, sizes).to(i64)
    sym = torch.nn.functional.pad(data, (0, T * N_LANES - cap)).to(i64)
    f_all = freq.to(i64).gather(1, sym).reshape(B, T, N_LANES)
    c_all = cum.to(i64).gather(1, sym).reshape(B, T, N_LANES)
    lane = torch.arange(N_LANES, device=dev)[None, :]
    words = torch.zeros((B, T, N_LANES), dtype=torch.int16, device=dev)
    emits = torch.zeros((B, T, N_LANES), dtype=torch.uint8, device=dev)
    x = torch.full((B, N_LANES), RANS_L, dtype=i64, device=dev)
    wcount = torch.zeros((B, N_LANES), dtype=i64, device=dev)
    rows = int(-(-sizes.max() // N_LANES)) if B else 0
    for r in reversed(range(rows)):
        f, c = f_all[:, r], c_all[:, r]
        act = (r * N_LANES + lane) < sizes[:, None]
        x_max = (f << 20) & 0xFFFFFFFF
        emit = act & (x_max != 0) & (x >= x_max)
        word = x & 0xFFFF
        x = torch.where(emit, x >> 16, x)
        fs = torch.clamp(f, min=1)
        x_new = (((x // fs) << PROB_BITS) + x % fs + c) & 0xFFFFFFFF
        x = torch.where(act, x_new, x)
        words[:, r] = torch.where(emit, word - ((word >> 15) << 16), 0).to(torch.int16)
        emits[:, r] = emit.to(torch.uint8)
        wcount = wcount + emit
    return words, emits, wrap_i32(x).to(torch.int32), wcount.to(torch.int32)


def _walk(data, sizes, freq, cum, warps: int):
    if data.device.type != "cuda":
        raise ValueError(f"the ANS encode kernel needs CUDA tensors, got {data.device}")
    if data.dtype != torch.uint8 or data.dim() != 2:
        raise ValueError(f"data must be uint8[B, cap], got {data.dtype}{list(data.shape)}")
    B, cap = data.shape
    dev = data.device
    for name, t in (("freq", freq), ("cum", cum)):
        if t.shape != (B, 256) or t.dtype != torch.int32 or t.device != dev:
            raise ValueError(f"{name} must be int32[{B}, 256] on {dev}")
    T = -(-cap // N_LANES)
    data, freq, cum = data.contiguous(), freq.contiguous(), cum.contiguous()
    sizes = _clamped_sizes(data, sizes).contiguous()
    words = torch.empty((B, T, N_LANES), dtype=torch.int16, device=dev)
    emits = torch.empty((B, T, N_LANES), dtype=torch.uint8, device=dev)
    x_fin = torch.empty((B, N_LANES), dtype=torch.int32, device=dev)
    wcount = torch.empty((B, N_LANES), dtype=torch.int32, device=dev)
    fn = _build.load("ans_encode").tpucomp_ans_encode
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, i, i, p, p, p, p, i, p]
    fn.restype = i
    with torch.cuda.device(dev):
        rc = fn(data.data_ptr(), sizes.data_ptr(), freq.data_ptr(), cum.data_ptr(), B, cap,
                words.data_ptr(), emits.data_ptr(), x_fin.data_ptr(), wcount.data_ptr(),
                warps, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ans_encode kernel launch failed: cudaError {rc}")
    return words, emits, x_fin, wcount


def walk_kernel(data: torch.Tensor, sizes: torch.Tensor, freq: torch.Tensor,
                cum: torch.Tensor):
    """Row 24: ``csrc/ans_encode.cu`` with one chunk per block, on ``data``'s
    card and current stream (same outputs as :func:`walk_plain`)."""
    res = _walk(data, sizes, freq, cum, 1)
    walk_kernel.launches += 1
    return res


def walk_kernel_wide(data: torch.Tensor, sizes: torch.Tensor, freq: torch.Tensor,
                     cum: torch.Tensor):
    """Row 25: the same kernel with eight chunks per block (the reference's
    G; the ragged last block is masked, no padding of the batch)."""
    res = _walk(data, sizes, freq, cum, 8)
    walk_kernel_wide.launches += 1
    return res


walk_kernel.launches = 0
walk_kernel_wide.launches = 0


def _compress(walk, data: torch.Tensor, sizes: torch.Tensor, out_cap: int):
    sizes = _clamped_sizes(data, sizes)
    freq, cum = tables_for(data, sizes)
    words, emits, x_fin, wcount = walk(data, sizes, freq, cum)
    return serialize_scan(sizes, freq, x_fin, wcount, words, emits, out_cap)


def compress_batch(data: torch.Tensor, sizes: torch.Tensor, out_cap: int):
    """``tables_for``, row 24, ``serialize_scan``, all on the card.  Raises for
    tensors that are not on a CUDA device (:func:`walk_kernel`'s check)."""
    return _compress(walk_kernel, data, sizes, out_cap)


def compress_batch_wide(data: torch.Tensor, sizes: torch.Tensor, out_cap: int):
    """As :func:`compress_batch` through row 25; byte-identical frames."""
    return _compress(walk_kernel_wide, data, sizes, out_cap)


def compress_batch_plain(data: torch.Tensor, sizes: torch.Tensor, out_cap: int):
    """Plain version of :func:`compress_batch`; tensors on ``data``'s device."""
    return _compress(walk_plain, data, sizes, out_cap)
