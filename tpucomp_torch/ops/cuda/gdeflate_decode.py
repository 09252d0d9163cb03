"""Batched GDeflate tile decode, one serial walk a tile: the Hopper kernel
and its plain version.

Port of :mod:`tpucomp.ops.pallas.gdeflate_decode` (``decompress_batch`` /
``_kernel``, kernel row 15), the reference's serial tile decoder, which no
dispatch table reaches (the dispatched one is :mod:`.gdeflate_vdecode`, rows
13-14).  The tile's one Deflate-style bitstream is spread over 32 lanes,
refilled a DWORD at a time in a field-major schedule; the decoder replays
it: per round of 32 tokens, four passes over the round's lanes (literal/length
symbol, length extra bits, distance symbol, distance extra bits), each lane's
pass starting with its refill (a DWORD when the lane holds fewer than 32 bits
and has DWORDs left, taken in lane order from the shared stream), then the
round's tokens are emitted in order.  Tables are the two-level inflate
tables of :mod:`.huffman` (roots 9/6/7, 852 + 640 entries, GDeflate's 32
distance codes).

On corrupt input this decoder is its own function, not rows 13-14's, and the
port keeps its statuses (``gdeflate_decode.py:105-113``, ``:402``):

* the header decides ``too_big`` from its raw size before any parse, so a
  corrupt tile whose header says more than ``out_cap`` is
  ``ERROR_OUTPUT_BUFFER_TOO_SMALL``; a Huffman tile with more tokens than
  raw bytes is ``ERROR_CANNOT_DECOMPRESS`` even then;
* reads past ``csize`` and within the row return the row's own bytes (a tile
  cut by a few bytes may still decode); past the row they return 0;
* the checks: a header shorter than 12 bytes, a block type above 2, a
  framing version above 1, a negative raw size or token count, a stored tile
  with ``HDR + raw > csize``, a Huffman tile shorter than its lane table or
  its description, a table that does not build, a code that misses, symbol
  256 or one above 285, more DWORDs taken than the tile has (``sp >
  max_sp``), a distance past the output, an output of another size than the
  header's.

The kernel is ``csrc/gdeflate_decode.cu`` (one warp a tile, lane ``j`` on
GDeflate lane ``j``; its header says what it replaces, what bounds it and how
it is built).  The plain version walks each tile in Python.

Contract (the reference's): ``comp uint8[B, comp_cap]`` plus ``comp_sizes
int32[B]`` -> ``(out uint8[B, out_cap], out_sizes int32[B], statuses
int32[B])``; bytes past each size are zero, a failed tile has size 0.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpucomp_torch.constants import Status
from tpucomp_torch.formats.deflate import CL_ORDER, LEN_BASE, LEN_EXTRA
from tpucomp_torch.formats.gdeflate import GDIST_BASE, GDIST_EXTRA, HDR, N_LANES, PAYLOAD
from tpucomp_torch.ops.cuda import _build, huffman

LIT_ROOT = 9
DIST_ROOT = 6
CL_ROOT = 7
ENOUGH_LITLEN = 852
ENOUGH_GDIST = 640    # 32 symbols at a 6-bit root
TAB_DIST = ENOUGH_LITLEN
_FIXED_LENS = [8] * 144 + [9] * 112 + [7] * 24 + [8] * 8 + [5] * 32
_LEN_BASE, _LEN_EXTRA = LEN_BASE.tolist(), LEN_EXTRA.tolist()
_GDIST_BASE, _GDIST_EXTRA = GDIST_BASE.tolist(), GDIST_EXTRA.tolist()
_CL_ORDER = CL_ORDER.tolist()


def _i32(v: int) -> int:
    return v - (1 << 32) if v >= 1 << 31 else v


class _Tables:
    """One tile's lengths and decode tables (the reference's SMEM scratch)."""

    def __init__(self):
        self.tab = [0] * (ENOUGH_LITLEN + ENOUGH_GDIST)
        self.lens = [0] * 320
        self.work = [0] * 320
        self.cnt = [0] * 16
        self.ofs = [0] * 16

    def build(self, base, nsym, root, tbase, enough) -> bool:
        return huffman.build_table(self.tab, self.lens, self.work, self.cnt, self.ofs,
                                   base, nsym, root, tbase, enough)


def _dynamic_lens(t: _Tables, load32, hdrb: int) -> bool:
    """The plain-coded description into ``t.lens`` (litlen at 0, distance at
    288); True on error (gdeflate_decode.py:156-216)."""
    def peek(pos, n):
        return (load32(pos >> 3) >> (pos & 7)) & ((1 << n) - 1)

    bp = PAYLOAD * 8
    bits_end = PAYLOAD * 8 + hdrb * 8
    hlit, hdist, hclen = peek(bp, 5) + 257, peek(bp + 5, 5) + 1, peek(bp + 10, 4) + 4
    bp += 14
    if hlit > 286:
        return True
    t.lens[:19] = [0] * 19
    for i in range(hclen):
        t.lens[_CL_ORDER[i]] = peek(bp, 3)
        bp += 3
    if t.build(0, 19, CL_ROOT, TAB_DIST, 128):
        return True
    for i in range(hlit + hdist):
        sym, nb, inv = huffman.read_code(t.tab, lambda n: peek(bp, n), TAB_DIST, CL_ROOT)
        bp += nb
        if inv or sym > 15 or bp > bits_end:
            return True
        t.lens[i] = sym
    t.lens[288:288 + hdist] = t.lens[hlit:hlit + hdist]
    t.lens[hlit:288] = [0] * (288 - hlit)
    t.lens[288 + hdist:] = [0] * (32 - hdist)
    return False


def _huffman_tile(row: bytes, comp_cap: int, csize: int, out_cap: int, btype: int,
                  n_tok: int, raw: int, hdrb: int):
    """A btype 1/2 tile's output bytes, or None on any error
    (gdeflate_decode.py:129-373)."""
    def getb(i):
        return row[i] if i < comp_cap else 0

    def load32(i):
        return int.from_bytes(row[i:i + 4], "little")   # short past the row: zeros

    if csize < PAYLOAD:
        return None
    d = [getb(HDR + 2 * j) | (getb(HDR + 2 * j + 1) << 8) for j in range(N_LANES)]
    stream_off = PAYLOAD + ((hdrb + 3) & ~3 if btype == 2 else 0)
    if stream_off > csize:
        return None
    t = _Tables()
    if btype == 1:
        t.lens[:] = _FIXED_LENS
    elif _dynamic_lens(t, load32, hdrb):
        return None
    if (t.build(0, 288, LIT_ROOT, 0, ENOUGH_LITLEN)
            or t.build(288, 32, DIST_ROOT, TAB_DIST, ENOUGH_GDIST)):
        return None
    tab = t.tab

    # 32 lane bit buffers (at most 63 bits each); a lane that reads past its
    # bits goes negative and its next DWORD is lost, as the reference's
    # out-of-range shifts give 0
    bb = [0] * N_LANES
    nb = [0] * N_LANES
    tk = [0] * N_LANES
    sw = stream_off >> 2
    max_sp = (csize - stream_off + 3) >> 2
    sp = 0

    def refill(j):
        nonlocal sp
        if nb[j] < 32 and tk[j] < d[j]:
            if nb[j] >= 0:
                bb[j] |= load32(4 * (sw + sp)) << nb[j]
            nb[j] += 32
            tk[j] += 1
            sp += 1

    def take(j, n):
        v = bb[j] & ((1 << n) - 1)
        bb[j] >>= n
        nb[j] -= n
        return v

    out = bytearray(out_cap)
    op = 0
    for r in range((n_tok + N_LANES - 1) >> 5):
        width = min(N_LANES, n_tok - r * N_LANES)
        sym, ml, dist = [0] * width, [0] * width, [0] * width
        bad = False
        for j in range(width):                     # literal/length symbol
            refill(j)
            s, n, inv = huffman.read_code(tab, lambda k: bb[j] & ((1 << k) - 1), 0, LIT_ROOT)
            take(j, n)
            sym[j] = s
            bad = bad or inv or s == 256 or s - 257 >= 29
        for j in range(width):                     # length extra bits
            refill(j)
            li = min(max(sym[j] - 257, 0), 28)
            ml[j] = _LEN_BASE[li] + take(j, _LEN_EXTRA[li] if sym[j] >= 257 else 0)
        ds = [0] * width
        for j in range(width):                     # distance symbol
            refill(j)
            s, n, inv = huffman.read_code(tab, lambda k: bb[j] & ((1 << k) - 1), TAB_DIST,
                                          DIST_ROOT)
            if sym[j] >= 257:
                take(j, n)
                bad = bad or inv or s >= 32
            ds[j] = min(s, 31)
        for j in range(width):                     # distance extra bits
            refill(j)
            dist[j] = _GDIST_BASE[ds[j]] + take(j, _GDIST_EXTRA[ds[j]] if sym[j] >= 257 else 0)
        if bad:
            return None
        for j in range(width):                     # emit, in token order
            if sym[j] < 257:
                if op < out_cap:
                    out[op] = sym[j]
                op += 1
                continue
            m, dd = ml[j], dist[j]
            if dd > op:
                return None
            if op + m <= out_cap:
                if dd >= m:
                    out[op:op + m] = out[op - dd:op - dd + m]
                else:
                    pat = out[op - dd:op]
                    out[op:op + m] = (pat * (m // dd + 1))[:m]
            op += m
    if sp > max_sp or op != raw:
        return None
    return out


def _decode_tile(row: bytes, comp_cap: int, csize: int, out_cap: int):
    """One tile -> (output row of out_cap bytes, size, status)."""
    def getb(i):
        return row[i] if i < comp_cap else 0

    def u32(at):
        return _i32(getb(at) | getb(at + 1) << 8 | getb(at + 2) << 16 | getb(at + 3) << 24)

    btype, n_tok, raw = getb(0), u32(2), u32(6)
    hdrb = getb(10) | (getb(11) << 8)
    err = csize < HDR or btype > 2 or getb(1) > 1 or raw < 0 or n_tok < 0
    too_big = not err and raw > out_cap
    err = err or (btype > 0 and n_tok > raw)
    out = None
    if not (err or too_big):
        if btype == 0:
            err = HDR + raw > csize
            out = bytearray(row[HDR:HDR + raw].ljust(raw, b"\0")) + bytearray(out_cap - raw)
        else:
            out = _huffman_tile(row, comp_cap, csize, out_cap, btype, n_tok, raw, hdrb)
            err = out is None
    if err or too_big:
        return bytearray(out_cap), 0, int(Status.ERROR_CANNOT_DECOMPRESS if err
                                          else Status.ERROR_OUTPUT_BUFFER_TOO_SMALL)
    return out, raw, int(Status.SUCCESS)


def decompress_batch_plain(comp: torch.Tensor, comp_sizes: torch.Tensor, out_cap: int):
    """Plain version of the kernel: each tile walked in Python on the host.
    Returns tensors on ``comp``'s device."""
    data = comp.cpu().numpy()
    sizes = comp_sizes.cpu().numpy().astype(np.int64)
    B, comp_cap = data.shape
    out = np.zeros((B, out_cap), np.uint8)
    osz = np.zeros(B, np.int32)
    stat = np.zeros(B, np.int32)
    for i in range(B):
        row, osz[i], stat[i] = _decode_tile(data[i].tobytes(), comp_cap, int(sizes[i]),
                                            out_cap)
        out[i] = np.frombuffer(row, np.uint8)
    dev = comp.device
    return (torch.from_numpy(out).to(dev), torch.from_numpy(osz).to(dev),
            torch.from_numpy(stat).to(dev))


def decompress_batch(comp: torch.Tensor, comp_sizes: torch.Tensor, out_cap: int):
    """Launch ``csrc/gdeflate_decode.cu`` on ``comp``'s card, on the current
    stream.  Raises for tensors that are not on a CUDA device."""
    if comp.device.type != "cuda":
        raise ValueError(f"the GDeflate tile decode kernel needs CUDA tensors, got {comp.device}")
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
    fn = _build.load("gdeflate_decode").tpucomp_gdeflate_decode
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, i, p, i, p, p, p]
    fn.restype = i
    with torch.cuda.device(comp.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(comp.data_ptr(), comp_sizes.data_ptr(), B, comp_cap, out.data_ptr(), out_cap,
                osz.data_ptr(), stat.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"gdeflate_decode kernel launch failed: cudaError {rc}")
    decompress_batch.launches += 1
    return out, osz, stat


decompress_batch.launches = 0
