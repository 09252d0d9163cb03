"""GDeflate: the 32-lane SIMD tile format (tile constants, options, bound,
tile tables, size query, registration).

Port of the part of :mod:`tpucomp.formats.gdeflate` that the kernel path
needs (``tpucomp/formats/gdeflate.py:94-131,385-469,615-644``).  The codec
itself runs in the Hopper kernels of :mod:`tpucomp_torch.ops.cuda`
(:mod:`~tpucomp_torch.ops.cuda.gdeflate_vdecode`,
:mod:`~tpucomp_torch.ops.cuda.gdeflate_encode`) and their plain versions; the
reference's XLA program (``encode_chunk``, ``decode_chunk``) is ROADMAP A.6.

One tile per chunk, little-endian (the normative layout of
``tests/gdeflate_pyref.py``): byte 0 the btype (0 stored, 1 fixed Huffman,
2 dynamic Huffman), byte 1 the framing version (at most ``TILE_VERSION``),
bytes 2-5 the token count, 6-9 the raw size, 10-11 the table description's
length; a stored tile's bytes follow at 12.  A Huffman tile has 32 u16 lane
DWORD counts at 12-75, the dynamic table description from 76 (btype 2,
padded to 4 bytes), then the 32 lane bitstreams interleaved in the
decoder's refill order.  Tokens go round-robin to the lanes; a literal is an
RFC 1951 literal code, a match a length code with its extra bits, a 5-bit
distance code and its extra bits (codes 30 and 31 reach 64 KiB).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpucomp_torch.formats.deflate import CL_ORDER, FIXED_LIT_LENS, MAX_BITS, canonical, decode_sym

N_LANES = 32
REFILL_BITS = 32
TILE_VERSION = 1            # tile framing version (header byte 1)
HDR = 12                    # fixed tile header
LANE_TAB = 2 * N_LANES      # u16 lane dword counts
PAYLOAD = HDR + LANE_TAB    # = 76: lane table end / description start
DESC_CAP = 384              # dynamic table description <= 2297 bits = 288 B

# GDeflate distance codes: RFC 1951's 30 plus two 14-extra-bit codes for the
# 64 KiB page window
GDIST_BASE = np.array([1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129,
                       193, 257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097,
                       6145, 8193, 12289, 16385, 24577, 32769, 49153], np.int32)
GDIST_EXTRA = np.array([0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7,
                        8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13, 14, 14],
                       np.int32)
FIXED_GDIST_LENS = np.full(32, 5, np.int32)
CL_STEPS = 318              # the description codes 286 + 32 lengths


@dataclasses.dataclass(frozen=True)
class GdeflateOpts:
    """Analog of ``nvcompBatchedGdeflateOpts_t{ int algo }``: 0 fixed
    Huffman tables (high throughput), 1 per-tile dynamic tables (high
    compression), 2 dynamic tables without LZ matches (entropy only)."""

    algo: int = 0


DEFAULT_OPTS = GdeflateOpts()


def max_compressed_chunk_size(max_chunk_bytes: int,
                              opts: GdeflateOpts = DEFAULT_OPTS) -> int:
    """The reference's bound (100,352 bytes for a 64 KiB chunk)."""
    n = max_chunk_bytes + max_chunk_bytes // 2 + PAYLOAD + DESC_CAP + 1024
    return (n + 1023) & ~1023


def _u32(cp: torch.Tensor, at: int) -> torch.Tensor:
    """The little-endian 32-bit field at byte ``at`` of each row, in int32
    (a value of 2^31 or more wraps, as the reference's)."""
    v = (cp[:, at] | (cp[:, at + 1] << 8) | (cp[:, at + 2] << 16)
         | (cp[:, at + 3].to(torch.int64) << 24))
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def tile_tables(comp: torch.Tensor, comp_sizes: torch.Tensor | None = None):
    """Header fields and canonical decode tables of each tile of ``comp
    uint8[B, cap]`` (``tpucomp/formats/gdeflate.py:385-469``), torch ops over
    the batch on ``comp``'s device (``comp_sizes`` is not read, as in the
    reference).

    Returns ``(btype, n_tokens, raw_size, D int32[B, 32], (lcount, lfirst,
    loffset int32[B, 16], lsor int32[B, 288]), (dcount, dfirst, doffset,
    dsor int32[B, 32]), dw_start, tbl_ok bool[B])``; scalars are ``[B]``.
    Bytes at and past ``cap`` read as 0.  The description is read as the
    reference reads it: 5+5+4-bit counts, 19 3-bit CL lengths in
    ``CL_ORDER`` (the first HCLEN of them), then always 318 CL-coded lengths
    from bit 71, where a run code (16-18) or a code that matches no length
    is an error wherever it falls; lengths at and past HLIT + HDIST are 0.
    """
    i32 = torch.int32
    B, cap = comp.shape
    dev = comp.device
    pad_to = max(cap, PAYLOAD + DESC_CAP + 4)
    cp = torch.nn.functional.pad(comp, (0, pad_to - cap)).to(i32)

    btype = cp[:, 0]
    ver_ok = cp[:, 1] <= TILE_VERSION
    n_tokens = _u32(cp, 2)
    raw_size = _u32(cp, 6)
    hdr_bytes = cp[:, 10] | (cp[:, 11] << 8)
    D = cp[:, HDR:PAYLOAD:2] | (cp[:, HDR + 1:PAYLOAD:2] << 8)

    desc = cp[:, PAYLOAD:PAYLOAD + DESC_CAP]
    nbits = DESC_CAP * 8
    desc_bits = ((desc[:, :, None] >> torch.arange(8, dtype=i32, device=dev)) & 1).reshape(B, nbits)

    def bits_at(bp: torch.Tensor, n: int, reverse: bool = False) -> torch.Tensor:
        """``n`` bits from bit ``bp`` (int32[B] or [B, k]), LSB first, or
        MSB first with ``reverse``."""
        k = torch.arange(n, dtype=i32, device=dev)
        at = (bp[..., None] + k).clamp(0, nbits - 1).reshape(B, -1).to(torch.int64)
        b = torch.gather(desc_bits, 1, at).reshape(*bp.shape, n)
        sh = (n - 1 - k) if reverse else k
        return (b << sh).sum(dim=-1, dtype=i32)

    zero = torch.zeros(B, dtype=i32, device=dev)
    hlit = bits_at(zero, 5) + 257
    hdist = bits_at(zero + 5, 5) + 1
    hclen = bits_at(zero + 10, 4) + 4
    ki = torch.arange(19, dtype=i32, device=dev)
    cl_raw = bits_at(14 + 3 * ki.expand(B, 19), 3)
    cl_lens = torch.zeros((B, 19), dtype=i32, device=dev)
    cl_lens[:, torch.from_numpy(CL_ORDER).to(device=dev, dtype=torch.int64)] = torch.where(
        ki < hclen[:, None], cl_raw, 0)
    cl_count, cl_first, cl_offset, cl_sor, cl_valid = canonical(cl_lens, 19)

    bp = zero + 14 + 3 * 19
    cl_err = torch.zeros(B, dtype=torch.bool, device=dev)
    all_lens = torch.zeros((B, CL_STEPS), dtype=i32, device=dev)
    for i in range(CL_STEPS):
        sym, ln, ok = decode_sym(bits_at(bp, MAX_BITS, reverse=True), cl_count, cl_first,
                                 cl_offset, cl_sor)
        cl_err = cl_err | ~ok | (sym > 15)
        all_lens[:, i] = sym
        bp = bp + ln
    n318 = torch.arange(CL_STEPS, dtype=i32, device=dev)
    all_lens = torch.where(n318 < (hlit + hdist)[:, None], all_lens, 0)
    dyn_lit = torch.where(torch.arange(288, device=dev) < hlit[:, None], all_lens[:, :288], 0)
    dl_idx = (hlit[:, None] + torch.arange(32, dtype=i32, device=dev)).clamp(0, CL_STEPS - 1)
    dyn_dist = torch.where(torch.arange(32, device=dev) < hdist[:, None],
                           torch.gather(all_lens, 1, dl_idx.to(torch.int64)), 0)

    is_dyn = btype == 2
    lit_lens = torch.where(is_dyn[:, None], dyn_lit, torch.from_numpy(FIXED_LIT_LENS).to(dev))
    dist_lens = torch.where(is_dyn[:, None], dyn_dist,
                            torch.from_numpy(FIXED_GDIST_LENS).to(dev))
    lcount, lfirst, loffset, lsor, lvalid = canonical(lit_lens, 288)
    dcount, dfirst, doffset, dsor, dvalid = canonical(dist_lens, 32)

    hdr_pad = torch.where(is_dyn, (hdr_bytes + 3) & ~3, 0)
    dw_start = PAYLOAD + hdr_pad
    tbl_ok = torch.where(is_dyn, cl_valid & ~cl_err, True) & lvalid & dvalid & ver_ok
    return (btype, n_tokens, raw_size, D, (lcount, lfirst, loffset, lsor),
            (dcount, dfirst, doffset, dsor), dw_start.to(i32), tbl_ok)


def get_decompress_size(comp: torch.Tensor, comp_sizes: torch.Tensor) -> torch.Tensor:
    """The raw size of each tile's header (bytes 6-9, int32 as the
    reference), or 0 when the tile is shorter than its header or its btype
    is above 2 (``tpucomp/formats/gdeflate.py:615-620``)."""
    B, cap = comp.shape
    idx = torch.arange(10, device=comp.device).clamp(max=cap - 1)
    cp = comp[:, idx].to(torch.int32) if cap > 0 else torch.zeros(
        (B, 10), dtype=torch.int32, device=comp.device)
    size = _u32(cp, 6)
    ok = (comp_sizes.to(device=comp.device, dtype=torch.int32) >= HDR) & (cp[:, 0] <= 2)
    return torch.where(ok, size, 0).to(torch.int32)
