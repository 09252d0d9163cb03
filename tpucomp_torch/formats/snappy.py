"""Snappy raw block format: options, size bound, constants and the size read.

Port of the part of :mod:`tpucomp.formats.snappy` that the batched Snappy path
needs (``tpucomp/formats/snappy.py:33-49,167-176``).  The codec itself runs
in the Hopper kernels of :mod:`tpucomp_torch.ops.cuda` (and their plain
versions).  The reference's log-depth XLA program (``decode_chunk``,
``encode_chunk``) is not ported yet.

Format: a varint32 uncompressed-length preamble, then elements —
literal (``tag & 3 == 0``), copy-1, copy-2 and copy-4.
"""
from __future__ import annotations

import dataclasses

import torch

from tpucomp_torch.chunk import wrap_i32

MIN_MATCH = 4
MAX_OFFSET = 65535  # encoder limit (copy-2); the decoder accepts copy-4 too


@dataclasses.dataclass(frozen=True)
class SnappyOpts:
    """Analog of the empty ``nvcompBatchedSnappyOpts_t``."""


DEFAULT_OPTS = SnappyOpts()


def max_compressed_chunk_size(max_chunk_bytes: int, opts: SnappyOpts = DEFAULT_OPTS) -> int:
    """snappy_max_compressed_length (32 + n + n/6), rounded up to a multiple
    of 1024 (the reference's value, kept so both packages size outputs alike)."""
    n = 32 + max_chunk_bytes + max_chunk_bytes // 6
    return (n + 1023) & ~1023


def get_decompress_size(comp: torch.Tensor, comp_sizes: torch.Tensor) -> torch.Tensor:
    """Read each chunk's varint preamble (``GetDecompressSizeAsync`` analog).

    ``comp uint8[B, cap]`` + ``comp_sizes int32[B]`` -> ``int32[B]``, on
    ``comp``'s device.  As the reference: up to 5 bytes are read whatever the
    size (indices clipped to the row), a continuation bit left after 5 bytes
    is ignored, the value is assembled in int32 (bits above 31 drop, and it
    may read negative), and a chunk of size <= 0 reads 0.
    """
    B, cap = comp.shape
    idx = torch.arange(5, device=comp.device).clamp(max=cap - 1)
    b = comp[:, idx].to(torch.int64)
    expected = b[:, 0] & 0x7F
    more = (b[:, 0] & 0x80) != 0
    for k in range(1, 5):
        expected = torch.where(more, expected | ((b[:, k] & 0x7F) << (7 * k)), expected)
        more = more & ((b[:, k] & 0x80) != 0)
    sizes = comp_sizes.to(device=comp.device, dtype=torch.int64)
    return torch.where(sizes > 0, wrap_i32(expected), 0).to(torch.int32)
