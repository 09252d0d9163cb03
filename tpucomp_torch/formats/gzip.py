"""Gzip (RFC 1952), decompression only, as in the reference.

Port of :mod:`tpucomp.formats.gzip` (``parse_member``,
``max_compressed_chunk_size``, ``get_decompress_size``) and of the kernel
path's composition ``tpucomp/ops/pallas/__init__.py::_gzip_decompress_batch``
(``:126-151``): parse each member's header and trailer in torch ops, decode
the deflate body with the Deflate decoder at the member's offset
(``starts``), then check the CRC32 and ISIZE of the trailer with
:func:`tpucomp_torch.formats.crc32.crc32_batch`.  The kernel path runs the
Hopper decoder, the plain path its plain version.
"""
from __future__ import annotations

import torch

from tpucomp_torch.chunk import wrap_i32
from tpucomp_torch.constants import Status
from tpucomp_torch.formats import crc32 as c32
from tpucomp_torch.formats import deflate as _deflate

FTEXT, FHCRC, FEXTRA, FNAME, FCOMMENT = 1, 2, 4, 8, 16


def max_compressed_chunk_size(max_chunk_bytes: int, opts=None) -> int:
    return _deflate.max_compressed_chunk_size(max_chunk_bytes) + 1024


def _byte_at(comp: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """``comp[b, clip(o[b], 0, cap - 1)]`` as int64."""
    idx = o.to(torch.int64).clamp(0, comp.shape[1] - 1)[:, None]
    return torch.gather(comp, 1, idx)[:, 0].to(torch.int64)


def parse_member(comp: torch.Tensor, comp_size: torch.Tensor):
    """Parse each member's header and trailer -> ``(off, deflate_end,
    stored_crc, isize, header_ok)``, all ``[B]`` on ``comp``'s device
    (``tpucomp/formats/gzip.py:28-76``).

    As the reference: the FNAME/FCOMMENT terminator is the first NUL at or
    after the field's start anywhere in the row, padding past the member
    included; the trailer is the 8 bytes at ``clip(size - 8, 0, cap - 8)``;
    the header is good when ``size >= 18``, the magic and CM match, a field's
    NUL exists and ``off + 8 <= size``.
    """
    B, cap = comp.shape
    dev = comp.device
    size = comp_size.to(device=dev, dtype=torch.int64)
    pos = torch.arange(cap, device=dev)
    big = 1 << 30
    zero = torch.zeros(B, dtype=torch.int64, device=dev)

    def gb(o):
        return _byte_at(comp, o)

    ok = (size >= 18) & (gb(zero) == 0x1F) & (gb(zero + 1) == 0x8B) & (gb(zero + 2) == 8)
    flg = gb(zero + 3)
    off = zero + 10
    xlen = gb(off) | (gb(off + 1) << 8)
    off = torch.where((flg & FEXTRA) != 0, off + 2 + xlen, off)
    is_nul = comp == 0

    def skip_zstring(off, enabled):
        hit = is_nul & (pos[None, :] >= off[:, None])
        zpos = torch.where(hit, pos[None, :], big).min(dim=1).values
        return torch.where(enabled, zpos + 1, off), ~enabled | (zpos < big)

    off, ok_n = skip_zstring(off, (flg & FNAME) != 0)
    off, ok_c = skip_zstring(off, (flg & FCOMMENT) != 0)
    ok = ok & ok_n & ok_c
    off = torch.where((flg & FHCRC) != 0, off + 2, off)
    ok = ok & (off + 8 <= size)
    deflate_end = (size - 8).clamp(min=0)

    row = torch.nn.functional.pad(comp, (0, max(0, 8 - cap)))
    t0 = (size - 8).clamp(0, row.shape[1] - 8)
    tr = torch.gather(row, 1, t0[:, None] + torch.arange(8, device=dev)).to(torch.int64)
    stored_crc = tr[:, 0] | (tr[:, 1] << 8) | (tr[:, 2] << 16) | (tr[:, 3] << 24)
    isize = tr[:, 4] | (tr[:, 5] << 8) | (tr[:, 6] << 16) | (tr[:, 7] << 24)
    return (off.to(torch.int32), deflate_end.to(torch.int32), stored_crc, isize, ok)


def no_compress(data, sizes, opts, out_cap):
    raise NotImplementedError("gzip provides decompression only (README.md:16)")


def get_decompress_size(comp: torch.Tensor, comp_size: torch.Tensor) -> torch.Tensor:
    """ISIZE from each trailer, ``int32[B]`` (``tpucomp/formats/gzip.py:98-106``):
    four bytes at ``size - 4`` with each index clipped to the row, read as
    int32; 0 where the size is below 18 or the magic is wrong."""
    size = comp_size.to(device=comp.device, dtype=torch.int64)
    o = size - 4
    isize = (_byte_at(comp, o) | (_byte_at(comp, o + 1) << 8) | (_byte_at(comp, o + 2) << 16)
             | (_byte_at(comp, o + 3) << 24))
    zero = torch.zeros_like(size)
    ok = (size >= 18) & (_byte_at(comp, zero) == 0x1F) & (_byte_at(comp, zero + 1) == 0x8B)
    return torch.where(ok, wrap_i32(isize), 0).to(torch.int32)


def decompress_batch_with(decoder, comp: torch.Tensor, comp_sizes: torch.Tensor,
                          out_cap: int):
    """Decode gzip members with ``decoder`` (a Deflate ``decompress_batch``
    taking ``starts=``): header parse, the deflate body, then the CRC32 and
    ISIZE checks; a member that fails any of them gives
    ``ERROR_CANNOT_DECOMPRESS``, size 0 and a zero row."""
    off, dend, stored_crc, isize, hok = parse_member(comp, comp_sizes)
    out, osz, dstat = decoder(comp, dend, out_cap, starts=torch.where(hok, off, 0))
    crc = c32.crc32_batch(out, osz)
    ok = hok & (dstat == Status.SUCCESS) & (crc == stored_crc) & (osz.to(torch.int64) == isize)
    osz = torch.where(ok, osz, 0).to(torch.int32)
    opos = torch.arange(out_cap, device=out.device)[None, :]
    out = torch.where(opos < osz[:, None], out, 0)
    stat = torch.where(ok, int(Status.SUCCESS), int(Status.ERROR_CANNOT_DECOMPRESS))
    return out, osz, stat.to(torch.int32)


def decompress_batch_plain(comp: torch.Tensor, comp_sizes: torch.Tensor, out_cap: int):
    """The gzip path on the plain Deflate decoder (any device)."""
    from tpucomp_torch.ops.cuda import deflate_decode
    return decompress_batch_with(deflate_decode.decompress_batch_plain, comp, comp_sizes,
                                 out_cap)
