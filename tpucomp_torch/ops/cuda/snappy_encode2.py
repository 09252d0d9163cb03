"""Batched Snappy block encode: sort-matched candidates, then the Hopper emitter.

Port of :mod:`tpucomp.ops.pallas.snappy_encode2` (``compress_batch`` /
``_kernel``), the Snappy twin of :mod:`.lz4_encode2`.
:func:`tpucomp_torch.ops.match.candidates2` finds, for every position, the
nearest previous 4-byte match, an 8-byte-prefix neighbour and the next
position with either; the emitter (``csrc/snappy_encode.cu``, one warp per
chunk, whose header says what it replaces, what bounds it and how it is
built) walks each chunk at token rate and writes the raw Snappy block format,
byte-identical to the reference's frames: a varint preamble, literal tags of
1-4 bytes, copy-1 / copy-2 elements with the 64/60-byte long-match split.
The plain version runs the same walk in Python; the CPU tests hold it against
the reference and ``chip_smoke.py`` holds the kernel against it.

Contract: ``data uint8[B, cap]`` plus ``sizes int32[B]`` (each in
``[0, cap]``; values outside are clamped) -> ``(out uint8[B, out_cap],
out_sizes int32[B], statuses int32[B])``.  A frame longer than ``out_cap``
gives ``ERROR_OUTPUT_BUFFER_TOO_SMALL``, size 0 and a zero row.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpucomp_torch.constants import Status
from tpucomp_torch.ops import match
from tpucomp_torch.ops.cuda import _build
from tpucomp_torch.ops.cuda.lz4_encode2 import _clamped_sizes, _match_len

MIN_MATCH = 4


def _varint(n: int) -> bytes:
    out = bytearray()
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _emit_literals(out: bytearray, row: bytes, anchor: int, ll: int) -> None:
    n = ll - 1
    if ll <= 60:
        out.append(n << 2)
    elif ll <= 256:
        out += bytes((60 << 2, n))
    elif ll <= 65536:
        out += bytes((61 << 2, n & 0xFF, n >> 8))
    else:
        out += bytes((62 << 2, n & 0xFF, (n >> 8) & 0xFF, (n >> 16) & 0xFF))
    out += row[anchor:anchor + ll]


def _emit_copy2(out: bytearray, off: int, ml: int) -> None:
    if off < 2048 and 4 <= ml <= 11:       # copy-1
        out += bytes((1 | ((ml - 4) << 2) | ((off >> 8) << 5), off & 0xFF))
    else:                                  # copy-2
        out += bytes((2 | ((ml - 1) << 2), off & 0xFF, off >> 8))


def _emit_copy(out: bytearray, off: int, ml: int) -> None:
    while ml >= 68:
        _emit_copy2(out, off, 64)
        ml -= 64
    if ml > 64:
        _emit_copy2(out, off, 60)
        ml -= 60
    _emit_copy2(out, off, ml)


def _encode_chunk(row: bytes, size: int, cand: list[int], cand8: list[int],
                  nxt: list[int]) -> bytearray:
    """The token-rate walk over one chunk -> its whole Snappy frame."""
    out = bytearray(_varint(size))
    mflimit = size - MIN_MATCH + 1
    anchor = scan = 0
    while scan < mflimit:
        nm = nxt[scan]
        if nm >= mflimit:
            break
        p4 = cand[nm] if cand[nm] >= 0 else cand8[nm]
        p8 = cand8[nm] if cand8[nm] >= 0 else p4
        fcap = size - (nm + MIN_MATCH)
        l4 = _match_len(row, nm + MIN_MATCH, p4 + MIN_MATCH, fcap)
        l8 = _match_len(row, nm + MIN_MATCH, p8 + MIN_MATCH, fcap) \
            if p8 != p4 else l4
        src = p8 if l8 > l4 else p4
        nm2, src2 = nm, src
        while nm2 > anchor and src2 > 0 and row[nm2 - 1] == row[src2 - 1]:
            nm2 -= 1
            src2 -= 1
        ml = (nm - nm2) + MIN_MATCH + max(l4, l8)
        if nm2 > anchor:
            _emit_literals(out, row, anchor, nm2 - anchor)
        _emit_copy(out, nm - src, ml)
        anchor = scan = nm2 + ml
    if size > anchor:
        _emit_literals(out, row, anchor, size - anchor)
    return out


def compress_batch_plain(data: torch.Tensor, sizes: torch.Tensor, out_cap: int):
    """Plain version: :func:`match.candidates2` on ``data``'s device, then the
    walk in Python on the host.  Returns tensors on ``data``'s device."""
    sizes = _clamped_sizes(data, sizes)
    cand, cand8, nxt = match.candidates2(data, sizes)
    rows = data.cpu().numpy()
    szs = sizes.cpu().tolist()
    cand, cand8, nxt = cand.cpu(), cand8.cpu(), nxt.cpu()
    B = rows.shape[0]
    out = np.zeros((B, out_cap), np.uint8)
    osz = np.zeros(B, np.int32)
    stat = np.zeros(B, np.int32)
    for i in range(B):
        frame = _encode_chunk(rows[i].tobytes(), szs[i], cand[i].tolist(),
                              cand8[i].tolist(), nxt[i].tolist())
        if len(frame) > out_cap:
            stat[i] = Status.ERROR_OUTPUT_BUFFER_TOO_SMALL
        else:
            out[i, :len(frame)] = np.frombuffer(frame, np.uint8)
            osz[i] = len(frame)
    dev = data.device
    return (torch.from_numpy(out).to(dev), torch.from_numpy(osz).to(dev),
            torch.from_numpy(stat).to(dev))


def emit_kernel(data: torch.Tensor, sizes: torch.Tensor, cand: torch.Tensor,
                cand8: torch.Tensor, nxt: torch.Tensor, out_cap: int):
    """Launch ``csrc/snappy_encode.cu`` over the candidates of
    :func:`match.candidates2` on ``data``'s card, on the current stream."""
    if data.device.type != "cuda":
        raise ValueError(f"the Snappy encode kernel needs CUDA tensors, got {data.device}")
    if data.dtype != torch.uint8 or data.dim() != 2:
        raise ValueError(f"data must be uint8[B, cap], got {data.dtype}{list(data.shape)}")
    B, cap = data.shape
    for name, t in (("cand", cand), ("cand8", cand8), ("nxt", nxt)):
        if t.shape != (B, cap) or t.dtype != torch.int32 or t.device != data.device:
            raise ValueError(f"{name} must be int32[{B}, {cap}] on {data.device}")
    data = data.contiguous()
    sizes = _clamped_sizes(data, sizes).contiguous()
    cand, cand8, nxt = cand.contiguous(), cand8.contiguous(), nxt.contiguous()
    out = torch.empty((B, out_cap), dtype=torch.uint8, device=data.device)
    osz = torch.empty((B,), dtype=torch.int32, device=data.device)
    stat = torch.empty((B,), dtype=torch.int32, device=data.device)
    fn = _build.load("snappy_encode").tpucomp_snappy_encode
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, i, i, p, i, p, p, p]
    fn.restype = i
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(data.data_ptr(), sizes.data_ptr(), cand.data_ptr(),
                cand8.data_ptr(), nxt.data_ptr(), B, cap, out.data_ptr(),
                out_cap, osz.data_ptr(), stat.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"snappy_encode kernel launch failed: cudaError {rc}")
    emit_kernel.launches += 1
    return out, osz, stat


emit_kernel.launches = 0


def compress_batch(data: torch.Tensor, sizes: torch.Tensor, out_cap: int):
    """:func:`match.candidates2` then the emitter kernel, all on the card.
    Raises for tensors that are not on a CUDA device."""
    if data.device.type != "cuda":
        raise ValueError(f"the Snappy encode kernel needs CUDA tensors, got {data.device}")
    sizes = _clamped_sizes(data, sizes)
    cand, cand8, nxt = match.candidates2(data, sizes)
    return emit_kernel(data, sizes, cand, cand8, nxt, out_cap)
