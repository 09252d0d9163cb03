"""Batched rANS decode: the 128-lane walk as a Hopper kernel, with its plain
version.

Port of :mod:`tpucomp.ops.pallas.ans_decode` (``decompress_batch`` /
``_kernel`` and ``decompress_batch_wide`` / ``_kernel_wide``).  One kernel in
``csrc/ans_decode.cu`` (one warp per chunk over ``csrc/ans.cuh``'s
``decode_block``; its header says what it replaces, what bounds it and how it
is built) behind the reference's two wrappers: :func:`decompress_batch` (row
22) launches one chunk per block, :func:`decompress_batch_wide` (row 23, the
one ``batched`` dispatches) eight.  :func:`decompress_batch_plain` computes
the same in torch ops: the header parse over the batch, then a Python loop
over the steps of ``[B, 128]`` lane states.

Contract (the TPU wrappers'; ``tpucomp/formats/ans.py``'s XLA ``decode_chunk``
has its own header statuses, ROADMAP A.6): ``comp uint8[B, comp_cap]`` plus
``comp_sizes int32[B]`` -> ``(out uint8[B, out_cap], out_sizes int32[B],
statuses int32[B])``.  A frame that fails a header or lane check gives
``ERROR_CANNOT_DECOMPRESS``, size 0 and a zero row; bytes past each size are
zero.
"""
from __future__ import annotations

import ctypes

import torch

from tpucomp_torch.chunk import wrap_i32
from tpucomp_torch.constants import Status
from tpucomp_torch.formats.ans import (HEADER_BYTES, MAGIC, N_LANES, PROB_BITS,
                                       PROB_SCALE, RANS_L, VERSION)
from tpucomp_torch.ops.cuda import _build


def stream_shape(comp_cap: int) -> tuple[int, int]:
    """``(n_words, max_word_pos)`` of a ``comp_cap``-byte row's shared stream
    as the TPU wrappers pad it (``ans_decode.py:174-190``): ``n_words`` words
    from the row (zero past it), and the clamp of the cursor a step's words
    are read from."""
    pad_to = max(comp_cap, HEADER_BYTES + 2)
    n_words = max((pad_to - HEADER_BYTES) // 2, 1)
    return n_words, -(-n_words // N_LANES) * N_LANES


def decompress_batch_plain(comp: torch.Tensor, comp_sizes: torch.Tensor, out_cap: int):
    """Plain version of :func:`decompress_batch` / :func:`decompress_batch_wide`;
    tensors on ``comp``'s device."""
    i64 = torch.int64
    dev = comp.device
    B, comp_cap = comp.shape
    n_words, max_word_pos = stream_shape(comp_cap)
    pad_to = max(comp_cap, HEADER_BYTES + 2, HEADER_BYTES + 2 * (max_word_pos + N_LANES))
    ci = torch.nn.functional.pad(comp, (0, pad_to - comp_cap)).to(i64)

    def u16s(lo, hi):
        return ci[:, lo:hi:2] | (ci[:, lo + 1:hi:2] << 8)

    def u32s(lo, hi):
        return u16s(lo, hi)[:, ::2] | (u16s(lo + 2, hi)[:, ::2] << 16)

    size = wrap_i32(u32s(4, 8)[:, 0])
    total_words = wrap_i32(u32s(8, 12)[:, 0])
    freq = u16s(12, 12 + 512)
    x = u32s(12 + 512, 12 + 1024)
    wcounts = u16s(12 + 1024, HEADER_BYTES)
    words = u16s(HEADER_BYTES, HEADER_BYTES + 2 * (max_word_pos + N_LANES))
    words[:, n_words:] = 0
    comp_sizes = comp_sizes.to(device=dev, dtype=i64)
    ok_hdr = ((ci[:, 0] == MAGIC) & (ci[:, 1] == VERSION) & (freq.sum(dim=1) == PROB_SCALE)
              & (size >= 0) & (size <= out_cap) & (comp_sizes >= HEADER_BYTES + 2 * total_words))
    size_c = torch.where(ok_hdr, size, 0)
    cumn = torch.cumsum(freq, dim=1)
    cum = cumn - freq
    slots = torch.arange(PROB_SCALE, device=dev).expand(B, PROB_SCALE).contiguous()
    sym_of_slot = torch.searchsorted(cumn, slots, right=True).clamp(max=255)

    T = -(-out_cap // N_LANES)
    lane = torch.arange(N_LANES, device=dev)[None, :]
    out = torch.zeros((B, T * N_LANES), dtype=torch.uint8, device=dev)
    ptr = torch.zeros(B, dtype=i64, device=dev)
    consumed = torch.zeros((B, N_LANES), dtype=i64, device=dev)
    steps = int(-(-size_c.max() // N_LANES)) if B else 0
    for t in range(steps):
        act = (t * N_LANES + lane) < size_c[:, None]
        slot = x & (PROB_SCALE - 1)
        s = sym_of_slot.gather(1, slot)
        xn = (freq.gather(1, s) * (x >> PROB_BITS) + slot - cum.gather(1, s)) & 0xFFFFFFFF
        need = act & (xn < RANS_L)
        rank = torch.cumsum(need, dim=1) - need.to(i64)
        w = words.gather(1, torch.clamp(ptr, max=max_word_pos)[:, None] + rank)
        x = torch.where(act, torch.where(need, (xn << 16) | w, xn), x)
        ptr = ptr + need.sum(dim=1)
        consumed = consumed + need
        out[:, t * N_LANES:(t + 1) * N_LANES] = torch.where(act, s, 0).to(torch.uint8)
    lanes_ok = ((x == RANS_L) & (consumed == wcounts)).all(dim=1) & (ptr == total_words)
    ok = ok_hdr & (lanes_ok | (size_c <= 0))
    osz = torch.where(ok, size_c, 0).to(torch.int32)
    out = torch.where(torch.arange(out_cap, device=dev)[None, :] < osz[:, None],
                      out[:, :out_cap], 0)
    stat = torch.where(ok, int(Status.SUCCESS), int(Status.ERROR_CANNOT_DECOMPRESS))
    return out, osz, stat.to(torch.int32)


def _launch(comp: torch.Tensor, comp_sizes: torch.Tensor, out_cap: int, warps: int):
    if comp.device.type != "cuda":
        raise ValueError(f"the ANS decode kernel needs CUDA tensors, got {comp.device}")
    if comp.dtype != torch.uint8 or comp.dim() != 2:
        raise ValueError(f"comp must be uint8[B, cap], got {comp.dtype}{list(comp.shape)}")
    B, comp_cap = comp.shape
    dev = comp.device
    comp = comp.contiguous()
    comp_sizes = comp_sizes.to(device=dev, dtype=torch.int32).contiguous()
    if comp_sizes.shape != (B,):
        raise ValueError(f"comp_sizes must be int32[{B}]")
    out = torch.empty((B, out_cap), dtype=torch.uint8, device=dev)
    osz = torch.empty((B,), dtype=torch.int32, device=dev)
    stat = torch.empty((B,), dtype=torch.int32, device=dev)
    n_words, max_word_pos = stream_shape(comp_cap)
    fn = _build.load("ans_decode").tpucomp_ans_decode
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, i, i, i, p, i, p, p, i, p]
    fn.restype = i
    with torch.cuda.device(dev):
        rc = fn(comp.data_ptr(), comp_sizes.data_ptr(), B, comp_cap, n_words,
                max_word_pos, out.data_ptr(), out_cap, osz.data_ptr(), stat.data_ptr(),
                warps, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ans_decode kernel launch failed: cudaError {rc}")
    return out, osz, stat


def decompress_batch(comp: torch.Tensor, comp_sizes: torch.Tensor, out_cap: int):
    """Row 22: ``csrc/ans_decode.cu`` with one chunk per block, on ``comp``'s
    card and current stream.  Raises for tensors that are not on a CUDA
    device."""
    res = _launch(comp, comp_sizes, out_cap, 1)
    decompress_batch.launches += 1
    return res


def decompress_batch_wide(comp: torch.Tensor, comp_sizes: torch.Tensor, out_cap: int):
    """Row 23: the same kernel with eight chunks per block (the reference's
    G; the ragged last block is masked, no padding of the batch)."""
    res = _launch(comp, comp_sizes, out_cap, 8)
    decompress_batch_wide.launches += 1
    return res


decompress_batch.launches = 0
decompress_batch_wide.launches = 0
