"""Batched Snappy block decode: the Hopper kernel and its plain version.

Port of :mod:`tpucomp.ops.pallas.snappy_decode` (``decompress_batch`` /
``_kernel``).  The kernel is ``csrc/snappy_decode.cu`` (one warp per chunk;
its header says what it replaces, what bounds it and how it is built).  The
plain version walks each chunk's elements in Python with the same semantics,
statuses included; the CPU tests hold it against the reference and
``chip_smoke.py`` holds the kernel against it.

Contract (same as the reference): ``comp uint8[B, comp_cap]`` plus
``comp_sizes int32[B]`` -> ``(out uint8[B, out_cap], out_sizes int32[B],
statuses int32[B])``; bytes past each chunk's output size are zero, a corrupt
chunk gives ``ERROR_CANNOT_DECOMPRESS`` and size 0, a chunk whose preamble
exceeds ``out_cap`` gives ``ERROR_OUTPUT_BUFFER_TOO_SMALL`` and size 0.

The reference reads tag bytes through int32 words of the row padded to
``wpad = round_up(max(comp_cap, 8), 4)`` bytes, with the word index clipped
(``snappy_decode.py:34-49``); a tag in the last word of that padding reads
the bytes 4 before it.  Both versions here read through the same clipped
words, so they give the reference's status there too (``ROADMAP.md`` §C).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpucomp_torch.chunk import wrap_i32
from tpucomp_torch.constants import Status
from tpucomp_torch.ops.cuda import _build


def _decode_chunk(row: bytes, csize: int, out_cap: int) -> tuple[bytearray, int, int]:
    """One chunk -> (output row of out_cap bytes, size, status).  ``row`` is
    the chunk's whole row of ``comp_cap`` bytes."""
    comp_cap = len(row)
    wpad = (max(comp_cap, 8) + 3) // 4 * 4
    words = row + bytes(wpad - comp_cap)       # the reference's padded words
    nw = wpad // 4

    def getb(i: int) -> int:
        ic = min(max(i, 0), wpad - 1)
        return words[(ic & ~3) | (i & 3)]

    expected, more, pre_len = words[0] & 0x7F, words[0] & 0x80, 1
    for k in range(1, 5):
        if more:
            expected |= (words[k] & 0x7F) << (7 * k)
            pre_len += 1
            more = words[k] & 0x80
    expected = wrap_i32(expected)
    err = bool(more) or csize < pre_len or expected < 0
    too_big = not err and expected > out_cap

    out = bytearray(out_cap)
    ip, op = (csize if err else pre_len), 0
    # past out_cap + 1 the end check must fail (op only grows): stop there
    while not err and ip < csize and op <= out_cap + 1:
        base = 4 * min(ip >> 2, nw - 2) + (ip & 3)
        tag, b1, b2, b3 = words[base:base + 4]
        t6 = tag >> 2
        if tag & 3 == 0:                       # literal
            extra = min(max(t6 - 59, 0), 4)
            acc = b1 | (b2 << 8 if extra > 1 else 0) | (b3 << 16 if extra > 2 else 0) \
                | (getb(ip + 4) << 24 if extra > 3 else 0)
            ll = wrap_i32(acc) + 1 if extra else t6 + 1
            src = ip + 1 + extra
            err = ll < 1 or src + ll > csize
            if not err and op + ll <= out_cap:
                lit = row[src:src + ll]        # reads past comp_cap give 0
                out[op:op + ll] = lit + bytes(ll - len(lit))
            ip, op = src + ll, op + ll
            continue
        if tag & 3 == 1:                       # copy-1
            ml, off, hdr = (t6 & 7) + 4, ((tag >> 5) << 8) | b1, 2
        elif tag & 3 == 2:                     # copy-2
            ml, off, hdr = t6 + 1, b1 | (b2 << 8), 3
        else:                                  # copy-4
            ml, hdr = t6 + 1, 5
            off = wrap_i32(b1 | (b2 << 8) | (b3 << 16) | (getb(ip + 4) << 24))
        err = ip + hdr > csize or off <= 0 or off > op
        if not err and op + ml <= out_cap:
            pat = out[op - off:op]
            out[op:op + ml] = (pat * (ml // off + 1))[:ml] if off < ml else pat[:ml]
        ip, op = ip + hdr, op + ml
    err = (err or op != min(max(expected, 0), out_cap + 1)) and not too_big
    if err or too_big:
        return bytearray(out_cap), 0, int(Status.ERROR_OUTPUT_BUFFER_TOO_SMALL
                                          if too_big else Status.ERROR_CANNOT_DECOMPRESS)
    return out, op, int(Status.SUCCESS)


def decompress_batch_plain(comp: torch.Tensor, comp_sizes: torch.Tensor,
                           out_cap: int):
    """Plain version of the kernel: the same function, walked in Python on the
    host.  Returns tensors on ``comp``'s device."""
    data = comp.cpu().numpy()
    sizes = comp_sizes.cpu().numpy().astype(np.int64)
    B = data.shape[0]
    out = np.zeros((B, out_cap), np.uint8)
    osz = np.zeros(B, np.int32)
    stat = np.zeros(B, np.int32)
    for i in range(B):
        row, osz[i], stat[i] = _decode_chunk(data[i].tobytes(), int(sizes[i]), out_cap)
        out[i] = np.frombuffer(row, np.uint8)
    dev = comp.device
    return (torch.from_numpy(out).to(dev), torch.from_numpy(osz).to(dev),
            torch.from_numpy(stat).to(dev))


def decompress_batch(comp: torch.Tensor, comp_sizes: torch.Tensor, out_cap: int):
    """Launch ``csrc/snappy_decode.cu`` on ``comp``'s card, on the current
    stream.  Raises for tensors that are not on a CUDA device."""
    if comp.device.type != "cuda":
        raise ValueError(f"the Snappy decode kernel needs CUDA tensors, got {comp.device}")
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
    fn = _build.load("snappy_decode").tpucomp_snappy_decode
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, i, p, i, p, p, p]
    fn.restype = i
    with torch.cuda.device(comp.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(comp.data_ptr(), comp_sizes.data_ptr(), B, comp_cap,
                out.data_ptr(), out_cap, osz.data_ptr(), stat.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"snappy_decode kernel launch failed: cudaError {rc}")
    decompress_batch.launches += 1
    return out, osz, stat


decompress_batch.launches = 0
