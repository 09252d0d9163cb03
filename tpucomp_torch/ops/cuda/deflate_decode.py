"""Batched raw Deflate (RFC 1951) decode: the Hopper kernel and its plain version.

Port of :mod:`tpucomp.ops.pallas.deflate_decode` (``decompress_batch`` /
``_kernel``).  The kernel is ``csrc/deflate_decode.cu`` (one CTA of two warps
per chunk: one warp decodes the symbols into a 34 KiB output window in shared
memory, the other copies the matches and flushes the window to the row; its
header says what it replaces, what bounds it and how it is built).  The
plain version walks each chunk's blocks and symbols in Python with the same
semantics, statuses included, through the table builder of :mod:`.huffman`;
the CPU tests hold it against the reference and ``chip_smoke.py`` holds the
kernel against it.

Contract (the reference's): ``comp uint8[B, comp_cap]`` plus ``comp_sizes
int32[B]`` -> ``(out uint8[B, out_cap], out_sizes int32[B], statuses
int32[B])``.  ``starts int32[B]`` (default 0) is the byte where each deflate
body begins, ``comp_sizes`` then its end: the hook the gzip path uses.  Bits
are read LSB-first at any position; bytes at and past ``comp_cap`` read as
0.  A corrupt chunk gives ``ERROR_CANNOT_DECOMPRESS``, a chunk whose output
passes ``out_cap`` ``ERROR_OUTPUT_BUFFER_TOO_SMALL`` (an error found later in
the stream wins); both with size 0 and a zero row.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpucomp_torch.constants import Status
from tpucomp_torch.formats.deflate import CL_ORDER, DIST_BASE, DIST_EXTRA, LEN_BASE, LEN_EXTRA
from tpucomp_torch.ops.cuda import _build, huffman

LIT_ROOT = 9
DIST_ROOT = 6
CL_ROOT = 7
ENOUGH_LITLEN = 852   # proven bound for 288 symbols, 9-bit root
ENOUGH_DIST = 592     # proven bound for 32 symbols, 6-bit root
TAB_DIST = ENOUGH_LITLEN

_FIXED_LENS = [8] * 144 + [9] * 112 + [7] * 24 + [8] * 8 + [5] * 32
_LEN = [(int(b), int(e)) for b, e in zip(LEN_BASE, LEN_EXTRA)]
_DIST = [(int(b), int(e)) for b, e in zip(DIST_BASE, DIST_EXTRA)]
_CL_ORDER = [int(c) for c in CL_ORDER]


def _decode_chunk(row: bytes, csize: int, start: int,
                  out_cap: int) -> tuple[bytearray, int, int]:
    """One chunk -> (output row of out_cap bytes, size, status).  ``row`` is
    the chunk's whole row of ``comp_cap`` bytes."""
    def peek(pos: int, n: int) -> int:
        p = pos >> 3
        return (int.from_bytes(row[p:p + 4], "little") >> (pos & 7)) & ((1 << n) - 1)

    tab, lens, work = [0] * (ENOUGH_LITLEN + ENOUGH_DIST), [0] * 320, [0] * 320
    cnt, ofs = [0] * 16, [0] * 16

    def build(base, nsym, root, tbase, enough):
        return huffman.build_table(tab, lens, work, cnt, ofs, base, nsym, root, tbase,
                                   enough)

    def read(pos, tbase, root):
        return huffman.read_code(tab, lambda n: peek(pos, n), tbase, root)

    def dynamic_header(bp: int) -> tuple[int, bool]:
        hlit, hdist, hclen = peek(bp, 5) + 257, peek(bp + 5, 5) + 1, peek(bp + 10, 4) + 4
        bp += 14
        if hlit > 286 or hdist > 30:
            return bp, True
        lens[:19] = [0] * 19
        for i in range(hclen):
            lens[_CL_ORDER[i]] = peek(bp, 3)
            bp += 3
        if build(0, 19, CL_ROOT, TAB_DIST, 128):
            return bp, True
        i, prev, n = 0, 0, hlit + hdist
        while i < n:
            sym, nb, inv = read(bp, TAB_DIST, CL_ROOT)
            bp += nb
            if inv or bp > nbits:
                return bp, True
            if sym < 16:
                lens[i] = prev = sym
                i += 1
                continue
            nb2, rep0 = {16: (2, 3), 17: (3, 3)}.get(sym, (7, 11))
            rep = rep0 + peek(bp, nb2)
            bp += nb2
            val = prev if sym == 16 else 0
            if (sym == 16 and i == 0) or i + rep > n:
                return bp, True
            lens[i:i + rep] = [val] * rep
            i, prev = i + rep, val
        lens[288:288 + hdist] = lens[hlit:hlit + hdist]   # dist lengths sit at 288
        lens[hlit:288] = [0] * (288 - hlit)
        lens[288 + hdist:320] = [0] * (32 - hdist)
        return bp, False

    out = bytearray(out_cap)
    nbits = csize * 8
    bp, op, err, done = start * 8, 0, csize <= start, False
    while not err and not done and bp + 3 <= nbits:
        done = peek(bp, 1) == 1
        btype = peek(bp + 1, 2)
        bp += 3
        if btype == 0:                                   # stored
            bp = (bp + 7) & ~7
            src, ln = bp >> 3, peek(bp, 16)
            err = src + 4 + ln > csize or (ln ^ peek(bp + 16, 16)) != 0xFFFF
            if not err and op + ln <= out_cap:
                lit = row[src + 4:src + 4 + ln]        # reads past comp_cap give 0
                out[op:op + ln] = lit + bytes(ln - len(lit))
            bp, op = bp + 32 + ln * 8, op + ln
        elif btype == 3:
            err = True
        else:
            if btype == 1:
                lens[:] = _FIXED_LENS
            else:
                bp, err = dynamic_header(bp)
            err = (err or build(0, 288, LIT_ROOT, 0, ENOUGH_LITLEN)
                   or build(288, 32, DIST_ROOT, TAB_DIST, ENOUGH_DIST))
            while not err:                               # symbols
                sym, nb, inv = read(bp, 0, LIT_ROOT)
                bp += nb
                err = inv or bp > nbits
                if err or sym == 256:
                    break
                if sym < 256:
                    if op < out_cap:
                        out[op] = sym
                    op += 1
                    continue
                if sym - 257 >= 29:
                    err = True
                    break
                lbase, lext = _LEN[sym - 257]
                mlen = lbase + peek(bp, lext)
                bp += lext
                dsym, dnb, dinv = read(bp, TAB_DIST, DIST_ROOT)
                bp += dnb
                if dinv or dsym >= 30:
                    err = True
                    break
                dbase, dext = _DIST[dsym]
                dist = dbase + peek(bp, dext)
                bp += dext
                err = dist > op or bp > nbits
                if not err and op + mlen <= out_cap:
                    pat = out[op - dist:op]
                    out[op:op + mlen] = ((pat * (mlen // dist + 1))[:mlen] if dist < mlen
                                         else pat[:mlen])
                op += mlen
        err = err or bp > nbits
    err = err or not done
    too_big = not err and op > out_cap
    if err or too_big:
        return bytearray(out_cap), 0, int(Status.ERROR_OUTPUT_BUFFER_TOO_SMALL
                                          if too_big else Status.ERROR_CANNOT_DECOMPRESS)
    return out, op, int(Status.SUCCESS)


def _starts(comp: torch.Tensor, starts: torch.Tensor | None) -> torch.Tensor:
    if starts is None:
        return torch.zeros(comp.shape[0], dtype=torch.int32, device=comp.device)
    return starts.to(device=comp.device, dtype=torch.int32)


def decompress_batch_plain(comp: torch.Tensor, comp_sizes: torch.Tensor, out_cap: int,
                           starts: torch.Tensor | None = None):
    """Plain version of the kernel: the same function, walked in Python on the
    host.  Returns tensors on ``comp``'s device."""
    data = comp.cpu().numpy()
    sizes = comp_sizes.cpu().numpy().astype(np.int64)
    st = _starts(comp, starts).cpu().numpy().astype(np.int64)
    B = data.shape[0]
    out = np.zeros((B, out_cap), np.uint8)
    osz = np.zeros(B, np.int32)
    stat = np.zeros(B, np.int32)
    for i in range(B):
        row, osz[i], stat[i] = _decode_chunk(data[i].tobytes(), int(sizes[i]), int(st[i]),
                                             out_cap)
        out[i] = np.frombuffer(row, np.uint8)
    dev = comp.device
    return (torch.from_numpy(out).to(dev), torch.from_numpy(osz).to(dev),
            torch.from_numpy(stat).to(dev))


def decompress_batch(comp: torch.Tensor, comp_sizes: torch.Tensor, out_cap: int,
                     starts: torch.Tensor | None = None):
    """Launch ``csrc/deflate_decode.cu`` on ``comp``'s card, on the current
    stream.  Raises for tensors that are not on a CUDA device."""
    if comp.device.type != "cuda":
        raise ValueError(f"the Deflate decode kernel needs CUDA tensors, got {comp.device}")
    if comp.dtype != torch.uint8 or comp.dim() != 2:
        raise ValueError(f"comp must be uint8[B, cap], got {comp.dtype}{list(comp.shape)}")
    B, comp_cap = comp.shape
    if comp_sizes.shape != (B,) or (starts is not None and starts.shape != (B,)):
        raise ValueError(f"comp_sizes and starts must be int32[{B}]")
    comp = comp.contiguous()
    comp_sizes = comp_sizes.to(device=comp.device, dtype=torch.int32).contiguous()
    starts = _starts(comp, starts).contiguous()
    out = torch.empty((B, out_cap), dtype=torch.uint8, device=comp.device)
    osz = torch.empty((B,), dtype=torch.int32, device=comp.device)
    stat = torch.empty((B,), dtype=torch.int32, device=comp.device)
    fn = _build.load("deflate_decode").tpucomp_deflate_decode
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, i, i, p, i, p, p, p]
    fn.restype = i
    with torch.cuda.device(comp.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(comp.data_ptr(), comp_sizes.data_ptr(), starts.data_ptr(), B, comp_cap,
                out.data_ptr(), out_cap, osz.data_ptr(), stat.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"deflate_decode kernel launch failed: cudaError {rc}")
    decompress_batch.launches += 1
    return out, osz, stat


decompress_batch.launches = 0


def kernel_info() -> dict[str, int]:
    """The kernel's resources on the current card: CTAs an SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), static shared memory
    bytes, registers and local (spill) bytes a thread."""
    fn = _build.load("deflate_decode").tpucomp_deflate_decode_info
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    info = (ctypes.c_int * 4)()
    rc = fn(info)
    if rc != 0:
        raise RuntimeError(f"deflate_decode kernel query failed: cudaError {rc}")
    return dict(zip(("ctas_per_sm", "shared_bytes", "registers", "local_bytes"), info))
