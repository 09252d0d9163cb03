"""Batched Snappy block encode with a hash-table match finder: the Hopper
kernel and its plain version.

Port of :mod:`tpucomp.ops.pallas.snappy_encode` (``compress_batch`` /
``_kernel``, kernel row 8), the reference's v1 Snappy encoder, which no
dispatch table reaches (the dispatched one is :mod:`.snappy_encode2`).  The
scan is :mod:`.lz4_encode`'s, with the match cap ``size - (ip + 4)``
(Snappy has no last-literals rule) and Snappy's emission: the varint size,
literal tags of 1-4 bytes (60/61/62 by run length), copy-1 for ``off <
2048`` and ``4 <= ml <= 11``, else copy-2, long matches split into 64s while
``ml >= 68``, then 60 if the rest passes 64; the final literals only when
some remain.  Frames are byte-identical to the reference's.

The kernel is ``csrc/hash_encode.cu`` (``tpucomp_snappy_encode_hash``); the
plain version is the scan in Python.  Contract, clamped sizes and the
batch limit: as :mod:`.lz4_encode`'s.
"""
from __future__ import annotations

import torch

from tpucomp_torch.ops.cuda import lz4_encode
from tpucomp_torch.ops.cuda.snappy_encode2 import _emit_copy, _emit_literals, _varint


def _encode_chunk(row: bytes, size: int) -> bytearray:
    seqs, anchor = lz4_encode.scan(row, size, 0)
    out = bytearray(_varint(size))
    for a, ll, ml, off in seqs:
        if ll > 0:
            _emit_literals(out, row, a, ll)
        _emit_copy(out, off, ml)
    if size > anchor:
        _emit_literals(out, row, anchor, size - anchor)
    return out


def compress_batch_plain(data: torch.Tensor, sizes: torch.Tensor, out_cap: int):
    """Plain version: the scan in Python on the host.  Returns tensors on
    ``data``'s device."""
    return lz4_encode.plain_batch(_encode_chunk, data, sizes, out_cap)


def compress_batch(data: torch.Tensor, sizes: torch.Tensor, out_cap: int):
    """Launch the kernel on ``data``'s card, on the current stream.  Raises
    for tensors that are not on a CUDA device."""
    result = lz4_encode.launch("tpucomp_snappy_encode_hash", data, sizes, out_cap)
    compress_batch.launches += 1
    return result


compress_batch.launches = 0
