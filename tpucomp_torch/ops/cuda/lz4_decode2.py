"""Batched LZ4 block decode: the Hopper kernel and its plain version.

Port of :mod:`tpucomp.ops.pallas.lz4_decode2` (``decompress_batch`` /
``_kernel``).  The kernel is ``csrc/lz4_decode.cu`` (one warp per chunk; its
header says what it replaces, what bounds it and how it is built).  The plain
version walks each chunk's tokens in Python over the row's bytes, with the
same semantics, statuses included; the CPU tests hold it against the
reference and ``chip_smoke.py`` holds the kernel against it.

Contract (same as the reference): ``comp uint8[B, comp_cap]`` plus
``comp_sizes int32[B]`` -> ``(out uint8[B, out_cap], out_sizes int32[B],
statuses int32[B])``; bytes past each chunk's output size are zero, a corrupt
chunk gives ``ERROR_CANNOT_DECOMPRESS`` and size 0, a chunk that does not fit
``out_cap`` gives ``ERROR_OUTPUT_BUFFER_TOO_SMALL`` and size 0.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpucomp_torch.constants import Status
from tpucomp_torch.ops.cuda import _build

MIN_MATCH = 4


def _read_ext(src: bytes, csize: int, ip: int, ln: int) -> tuple[int, int]:
    """LZ4 length extension; stops at csize without error."""
    while ip < csize:
        b = src[ip]
        ip += 1
        ln += b
        if b != 255:
            break
    return ip, ln


def _decode_chunk(src: bytes, csize: int, out_cap: int) -> tuple[bytearray, int, int]:
    """One chunk -> (output row of out_cap bytes, size, status).  ``src`` is
    padded with zeros so every read below ``csize + 2`` is in range."""
    out = bytearray(out_cap)
    ip = op = 0
    err = done = csize < 0
    while not (err or done) and ip < csize:
        token = src[ip]
        ip += 1
        ll = token >> 4
        if ll == 15:
            ip, ll = _read_ext(src, csize, ip, ll)
        err = ip + ll > csize
        if not err and op + ll <= out_cap:
            out[op:op + ll] = src[ip:ip + ll]
        ip += ll
        op += ll
        done = ip == csize
        if done or err:
            break
        err = ip + 2 > csize
        off = src[ip] | (src[ip + 1] << 8)
        ip += 2
        ml = token & 15
        if ml == 15:
            ip, ml = _read_ext(src, csize, ip, ml)
        ml += MIN_MATCH
        err = err or ip > csize or off == 0 or off > op
        if not err and op + ml <= out_cap:
            pat = out[op - off:op]
            out[op:op + ml] = (pat * (ml // off + 1))[:ml] if off < ml \
                else pat[:ml]
        op += ml
    err = err or (csize > 0 and not done)
    too_big = not err and op > out_cap
    if err or too_big:
        return bytearray(out_cap), 0, int(Status.ERROR_CANNOT_DECOMPRESS
                                          if err else Status.ERROR_OUTPUT_BUFFER_TOO_SMALL)
    return out, op, int(Status.SUCCESS)


def decompress_batch_plain(comp: torch.Tensor, comp_sizes: torch.Tensor,
                           out_cap: int):
    """Plain version of the kernel: the same function, walked in Python on the
    host.  Returns tensors on ``comp``'s device."""
    data = comp.cpu().numpy()
    sizes = comp_sizes.cpu().numpy().astype(np.int64)
    B, comp_cap = data.shape
    out = np.zeros((B, out_cap), np.uint8)
    osz = np.zeros(B, np.int32)
    stat = np.zeros(B, np.int32)
    for i in range(B):
        # bytes at and past comp_cap read as 0, as in the kernel; past them a
        # walk reads at most one literal run (<= out_cap) before it fails
        pad = min(max(int(sizes[i]) - comp_cap, 0), out_cap + 16) + 8
        row, osz[i], stat[i] = _decode_chunk(data[i].tobytes() + bytes(pad),
                                             int(sizes[i]), out_cap)
        out[i] = np.frombuffer(row, np.uint8)
    dev = comp.device
    return (torch.from_numpy(out).to(dev), torch.from_numpy(osz).to(dev),
            torch.from_numpy(stat).to(dev))


def launch(entry: str, comp: torch.Tensor, comp_sizes: torch.Tensor, out_cap: int,
           *extra: int):
    """Check the inputs and launch ``entry``, one of the C entry points of
    ``csrc/lz4_decode.cu``, on ``comp``'s card, on the current stream;
    ``extra`` are its int arguments after ``statuses``.  Raises for tensors
    that are not on a CUDA device and when the launch fails."""
    if comp.device.type != "cuda":
        raise ValueError(f"the LZ4 decode kernel needs CUDA tensors, got {comp.device}")
    if comp.dtype != torch.uint8 or comp.dim() != 2:
        raise ValueError(f"comp must be uint8[B, cap], got {comp.dtype}{list(comp.shape)}")
    B, comp_cap = comp.shape
    if comp_sizes.shape != (B,):
        raise ValueError(f"comp_sizes must be int32[{B}], got {list(comp_sizes.shape)}")
    comp = comp.contiguous()
    comp_sizes = comp_sizes.to(device=comp.device, dtype=torch.int32).contiguous()
    out = torch.empty((B, out_cap), dtype=torch.uint8, device=comp.device)
    osz = torch.empty((B,), dtype=torch.int32, device=comp.device)
    stat = torch.empty((B,), dtype=torch.int32, device=comp.device)
    fn = getattr(_build.load("lz4_decode"), entry)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, i, p, i, p, p] + [i] * len(extra) + [p]
    fn.restype = i
    with torch.cuda.device(comp.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(comp.data_ptr(), comp_sizes.data_ptr(), B, comp_cap, out.data_ptr(),
                out_cap, osz.data_ptr(), stat.data_ptr(), *extra, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: cudaError {rc}")
    return out, osz, stat


def decompress_batch(comp: torch.Tensor, comp_sizes: torch.Tensor, out_cap: int):
    """Launch ``csrc/lz4_decode.cu`` (four chunks a block) on ``comp``'s card,
    on the current stream.  Raises for tensors that are not on a CUDA device."""
    result = launch("tpucomp_lz4_decode", comp, comp_sizes, out_cap)
    decompress_batch.launches += 1
    return result


decompress_batch.launches = 0
