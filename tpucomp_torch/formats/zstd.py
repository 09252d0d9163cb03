"""Zstandard (RFC 8878) frames: code tables, options, size bound and the size read.

Port of the part of :mod:`tpucomp.formats.zstd` that the batched decode path
needs (``tpucomp/formats/zstd.py:42-85,1153-1171``).  The decoder itself runs
in the Hopper kernel of :mod:`tpucomp_torch.ops.cuda.zstd_decode` (and its
plain version).  Not ported yet: the reference's XLA decoder and encoder
(``decode_chunk``, ``encode_chunk``, ``compress_batch``,
``decompress_batch``; ROADMAP A.6) and the encoder with the code that
builds its tables (ROADMAP B.7), so ``batched.compress("zstd")`` raises.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpucomp_torch.chunk import wrap_i32

MAGIC = 0xFD2FB528

# --- sequence code tables (RFC 8878 3.1.1.3.2.1) -------------------------------------

LL_BITS = np.array([0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11,
                    12, 13, 14, 15, 16], np.int32)
LL_BASE = np.array(list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64,
                    128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536],
                   np.int32)
ML_BITS = np.array([0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10,
                    11, 12, 13, 14, 15, 16], np.int32)
ML_BASE = np.array(list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67,
                    83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387,
                    32771, 65539], np.int32)

LL_DEFAULT = np.array([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                       2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1,
                       -1], np.int32)
ML_DEFAULT = np.array([1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                       1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                       1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1,
                       -1], np.int32)
OF_DEFAULT = np.array([1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                       1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1], np.int32)
LL_DEFAULT_ACC, ML_DEFAULT_ACC, OF_DEFAULT_ACC = 6, 6, 5


@dataclasses.dataclass(frozen=True)
class ZstdOpts:
    """Analog of the empty ``nvcompBatchedZstdOpts_t``."""


DEFAULT_OPTS = ZstdOpts()


def max_compressed_chunk_size(max_chunk_bytes: int, opts: ZstdOpts = DEFAULT_OPTS) -> int:
    """The reference's bound: frame header, a 3-byte header per block of at
    most 128 KiB plus one, the data and a margin, rounded up to 1024."""
    nblocks = max(1, -(-max_chunk_bytes // (1 << 17)))
    n = 8 + 3 * (nblocks + 1) + max_chunk_bytes + 32
    return (n + 1023) & ~1023


# the registry's CodecSpec.compress_todo: batched.compress and the Manager raise it
COMPRESS_TODO = ("the encoder (tpucomp/ops/pallas/zstd_encode.py and the code that builds "
                 "its tables) is not ported yet (ROADMAP B.7)")


def get_decompress_size(comp: torch.Tensor, comp_sizes: torch.Tensor) -> torch.Tensor:
    """Frame_Content_Size of each frame (``GetDecompressSizeAsync`` analog).

    ``comp uint8[B, cap]`` + ``comp_sizes int32[B]`` -> ``int32[B]``, on
    ``comp``'s device.  As the reference: byte indices clipped to the row;
    the field follows the window byte (absent for single-segment frames) and
    the dictionary ID; an 8-byte field reads its low 4 bytes, a 2-byte field
    adds 256, a missing field reads -1; the value wraps to int32; a chunk
    below 6 bytes or without the magic reads 0.
    """
    B, cap = comp.shape
    dev = comp.device

    def gb(o):
        idx = o.to(torch.int64).clamp(0, cap - 1)[:, None]
        return torch.gather(comp, 1, idx)[:, 0].to(torch.int64)

    zero = torch.zeros(B, dtype=torch.int64, device=dev)
    magic = gb(zero) | (gb(zero + 1) << 8) | (gb(zero + 2) << 16) | (gb(zero + 3) << 24)
    fhd = gb(zero + 4)
    fcs_flag = fhd >> 6
    single_seg = (fhd >> 5) & 1
    did = fhd & 3
    o = 5 + torch.where(single_seg == 1, 0, 1)
    o = o + torch.where(did == 0, 0, torch.where(did == 1, 1, torch.where(did == 2, 2, 4)))
    fcs1 = gb(o)
    fcs2 = fcs1 | (gb(o + 1) << 8)
    fcs4 = fcs2 | (gb(o + 2) << 16) | (gb(o + 3) << 24)
    fcs = torch.where(fcs_flag == 0, torch.where(single_seg == 1, fcs1, -1),
                      torch.where(fcs_flag == 1, fcs2 + 256, fcs4))
    sizes = comp_sizes.to(device=dev, dtype=torch.int64)
    ok = (sizes >= 6) & (magic == MAGIC)
    return torch.where(ok, wrap_i32(fcs), 0).to(torch.int32)
