"""Batched CRC32 (standard reflected polynomial 0xEDB88320) in torch ops.

Port of :mod:`tpucomp.formats.crc32`: the checksum behind the Manager's five
checksum modes, bit-identical to ``binascii.crc32`` / zlib / boost's
``crc_32_type`` (``examples/standard_crc_checksum.cpp:1-8,94-107``).  The
reference computes it with plain XLA ops, not a Pallas kernel, so it stays
tensor code here; a CUDA CRC kernel is a later speed item (``ROADMAP.md``).

CRC is byte-serial; its GF(2)-linearity makes it parallel.  Write ``crc0`` for
the CRC with init 0 and no final xor, and ``M_k`` for advancing a CRC register
over ``k`` zero bytes (a linear map, applied as four 256-entry table lookups,
zlib's ``crc32_combine`` in table form).  Then ``crc0(L || R) =
M_len(R)(crc0(L)) ^ crc0(R)``, and the crc0 of a 4-byte word ``w`` (little
endian) is ``M_4(w)``.  Per chunk:

1. the chunk is left-aligned in its row, zero past its size, and the standard
   init ``0xFFFFFFFF`` is xored into the first word: ``crc0`` of that row
   equals ``M_(W - size)`` of the standard register, for a row of ``W`` bytes,
   whatever the size (also below 4 bytes);
2. a log-depth tree over the row's words: at level ``k`` each pair becomes
   ``M_(4 * 2^k)(left) ^ right`` (a zero word is put in front of an odd
   count: leading zeros leave ``crc0`` unchanged);
3. the trailing ``W - size`` zero bytes are divided back out with the inverse
   operators, one table lookup per base-256 digit of ``W - size``, and the
   final xor is applied.

No Python loop runs over bytes or chunks; the row is never realigned.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

POLY = 0xEDB88320


def _apply(tab: np.ndarray, c: np.ndarray) -> np.ndarray:
    """Apply the linear map of table ``tab uint32[4, 256]`` to values ``c``."""
    return (tab[0, c & 0xFF] ^ tab[1, (c >> 8) & 0xFF] ^ tab[2, (c >> 16) & 0xFF]
            ^ tab[3, c >> 24])


@functools.cache
def _byte_table() -> np.ndarray:
    """crc0 of each single byte (the standard reflected table)."""
    t = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        t = np.where(t & 1, (t >> 1) ^ np.uint32(POLY), t >> 1).astype(np.uint32)
    return t


def _basis() -> np.ndarray:
    """``uint32[4, 256]``: the value ``b << 8j`` at ``[j, b]``."""
    return (np.arange(256, dtype=np.uint32)[None, :]
            << (8 * np.arange(4, dtype=np.uint32))[:, None])


@functools.cache
def _advance_tables(levels: int) -> np.ndarray:
    """``uint32[levels, 4, 256]``: level ``k`` is ``M_(4 * 2^k)``."""
    t = _byte_table()
    m = t[_basis() & 0xFF] ^ (_basis() >> 8)        # M_1
    m = _apply(m, m)                                # M_2
    m = _apply(m, m)                                # M_4
    out = [m]
    for _ in range(1, levels):
        out.append(_apply(out[-1], out[-1]))
    return np.stack(out)


@functools.cache
def _inverse_digit_tables(digits: int) -> np.ndarray:
    """``uint32[digits, 256, 4, 256]``: ``[j, d]`` is ``M_(-(d * 256^j))``,
    advancing the register back over ``d * 256^j`` zero bytes."""
    t = _byte_table()
    top = np.zeros(256, np.int64)
    top[t >> 24] = np.arange(256)                   # the table's top byte is unique
    r = _basis()
    c0 = top[r >> 24].astype(np.uint32)             # undo M_1: r = T[c0] ^ (c >> 8)
    step = ((r ^ t[c0]) << 8) | c0                  # M_-1
    out = np.zeros((digits, 256, 4, 256), np.uint32)
    for j in range(digits):
        out[j, 0] = _basis()                        # identity
        for d in range(1, 256):
            out[j, d] = _apply(out[j, d - 1], step)
        for _ in range(8):                          # M_-(256^(j+1))
            step = _apply(step, step)
    return out


@functools.cache
def _tables_on(device: str, levels: int, digits: int):
    """The operator tables as flat int64 tensors on ``device``."""
    adv = torch.from_numpy(_advance_tables(levels).astype(np.int64))
    inv = torch.from_numpy(_inverse_digit_tables(digits).astype(np.int64))
    return (adv.reshape(levels, 1024).to(device),
            inv.reshape(digits, 256 * 1024).to(device))


def _apply_t(tab: torch.Tensor, c: torch.Tensor, base=0) -> torch.Tensor:
    """Torch form of :func:`_apply` on a flat ``[.., 1024]`` table; ``base``
    (an int or a tensor broadcast with ``c``) selects the table."""
    return (tab[base + (c & 0xFF)] ^ tab[base + 256 + ((c >> 8) & 0xFF)]
            ^ tab[base + 512 + ((c >> 16) & 0xFF)] ^ tab[base + 768 + (c >> 24)])


def crc32_batch(data: torch.Tensor, sizes: torch.Tensor) -> torch.Tensor:
    """Per-chunk CRC32 of ``data[i, :sizes[i]]`` for ``data uint8[B, cap]``.

    Returns ``int64[B]`` holding the uint32 values, on ``data``'s device.
    Sizes are clamped to ``[0, cap]``.
    """
    B, cap = data.shape
    dev = data.device
    W = max(4, -(-cap // 4) * 4)
    nw = W // 4
    sizes = sizes.to(device=dev, dtype=torch.int64).clamp(0, cap)
    col = torch.arange(cap, device=dev)
    row = torch.where(col[None, :] < sizes[:, None], data, 0)
    row = torch.nn.functional.pad(row, (0, W - cap)).contiguous()
    w = row.view(torch.int32).to(torch.int64) & 0xFFFFFFFF   # little-endian words
    w[:, 0] ^= 0xFFFFFFFF                            # the standard init
    levels = max(1, (nw - 1).bit_length())
    digits = -(-W.bit_length() // 8)
    adv, inv = _tables_on(str(dev), levels, digits)
    v = _apply_t(adv[0], w)                          # crc0 of each word
    k = 0
    while v.shape[1] > 1:                            # spans of 4 * 2^k bytes
        if v.shape[1] % 2:
            v = torch.nn.functional.pad(v, (1, 0))
        v = _apply_t(adv[k], v[:, 0::2]) ^ v[:, 1::2]
        k += 1
    c = v[:, 0]
    kpad = W - sizes                                 # trailing zeros to divide out
    for j in range(digits):
        c = _apply_t(inv[j], c, ((kpad >> (8 * j)) & 0xFF) * 1024)
    return c ^ 0xFFFFFFFF
