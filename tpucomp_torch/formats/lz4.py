"""LZ4 block format: options, size bound and constants.

Port of the part of :mod:`tpucomp.formats.lz4` that the batched LZ4 path needs
(``tpucomp/formats/lz4.py:49-70``).  The codec itself runs in the Hopper
kernels of :mod:`tpucomp_torch.ops.cuda` (and their plain versions).  The
reference's log-depth XLA program (``decode_chunk``, ``encode_chunk``,
``get_decompress_size`` and ``ops/parallel_lz.py``) is not ported yet.
"""
from __future__ import annotations

import dataclasses

from tpucomp_torch.constants import ElementType

MIN_MATCH = 4
MAX_OFFSET = 65535
# End-of-block rules from the LZ4 block spec.
LAST_LITERALS = 5
MF_LIMIT = 12


@dataclasses.dataclass(frozen=True)
class LZ4Opts:
    """Analog of ``nvcompBatchedLZ4Opts_t{ nvcompType_t data_type }``."""

    data_type: ElementType = ElementType.CHAR


DEFAULT_OPTS = LZ4Opts()


def max_compressed_chunk_size(max_chunk_bytes: int, opts: LZ4Opts = DEFAULT_OPTS) -> int:
    """Standard LZ4 worst-case bound, rounded up to a multiple of 1024 (the
    reference's value, kept so both packages size outputs alike)."""
    n = max_chunk_bytes + max_chunk_bytes // 255 + 16
    return (n + 1023) & ~1023
