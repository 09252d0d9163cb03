"""Batched LZ4 block decode, K chunks a block: the Hopper kernel and its
plain version.

Port of :mod:`tpucomp.ops.pallas.lz4_decodek` (``decompress_batch`` /
``_kernel``, kernel row 4), the reference's K-way interleaved variant, which
no dispatch table reaches.  The TPU kernel walks K chunks a grid step with
their token chains interleaved, so that the in-order scalar core overlaps
them; here a block of ``min(k, 32)`` warps takes ``k`` chunks and the warp
scheduler overlaps them (``tpucomp_lz4_decode_k`` in ``csrc/lz4_decode.cu``,
row 1's per-chunk walk).  As in the reference, the result does not depend on
``k``: it is row 1's (:mod:`tpucomp_torch.ops.cuda.lz4_decode2`), whose plain
version is this one's.

Contract (the reference's): ``comp uint8[B, comp_cap]`` plus ``comp_sizes
int32[B]`` and ``k >= 1`` -> ``(out uint8[B, out_cap], out_sizes int32[B],
statuses int32[B])``.
"""
from __future__ import annotations

import torch

from tpucomp_torch.ops.cuda import lz4_decode2


def _check_k(k: int) -> None:
    if k < 1:
        raise ValueError(f"k must be at least 1, got {k}")


def decompress_batch_plain(comp: torch.Tensor, comp_sizes: torch.Tensor, out_cap: int,
                           k: int = 4):
    """Plain version: row 1's walk in Python; ``k`` changes nothing."""
    _check_k(k)
    return lz4_decode2.decompress_batch_plain(comp, comp_sizes, out_cap)


def decompress_batch(comp: torch.Tensor, comp_sizes: torch.Tensor, out_cap: int,
                     k: int = 4):
    """Launch the K-chunks-a-block kernel on ``comp``'s card, on the current
    stream.  Raises for tensors that are not on a CUDA device."""
    _check_k(k)
    result = lz4_decode2.launch("tpucomp_lz4_decode_k", comp, comp_sizes, out_cap, k)
    decompress_batch.launches += 1
    return result


decompress_batch.launches = 0
