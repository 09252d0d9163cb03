"""Batched LZ4 block decode, one chunk a block: the Hopper kernel and its
plain version.

Port of :mod:`tpucomp.ops.pallas.lz4_decode` (``decompress_batch`` /
``_kernel``, kernel row 3), the reference's single-chunk variant, which no
dispatch table reaches.  Its function is row 1's
(:mod:`tpucomp_torch.ops.cuda.lz4_decode2`): the same bytes, sizes and
statuses on every input, corrupt ones included.  So the kernel is row 1's
per-chunk walk in ``csrc/lz4_decode.cu`` behind its own entry point,
``tpucomp_lz4_decode_single`` (one warp a block, one chunk a warp), and the
plain version is row 1's.

Contract (the reference's): ``comp uint8[B, comp_cap]`` plus ``comp_sizes
int32[B]`` -> ``(out uint8[B, out_cap], out_sizes int32[B], statuses
int32[B])``; see :mod:`.lz4_decode2`.
"""
from __future__ import annotations

import torch

from tpucomp_torch.ops.cuda import lz4_decode2

decompress_batch_plain = lz4_decode2.decompress_batch_plain


def decompress_batch(comp: torch.Tensor, comp_sizes: torch.Tensor, out_cap: int):
    """Launch the single-chunk kernel on ``comp``'s card, on the current
    stream.  Raises for tensors that are not on a CUDA device."""
    result = lz4_decode2.launch("tpucomp_lz4_decode_single", comp, comp_sizes, out_cap)
    decompress_batch.launches += 1
    return result


decompress_batch.launches = 0
