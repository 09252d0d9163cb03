"""Status codes, element types, and per-format constants.

The port's own copy of :mod:`tpucomp.constants` (values identical, checked by
``tests/test_torch_core.py``): the analog of nvCOMP's ``nvcompStatus_t`` /
``nvcompType_t`` cross-cutting contracts (reference:
``doc/lowlevel_c_quickstart.md:20``, ``CHANGELOG.md:15-16,57``,
``benchmarks/benchmark_template_chunked.cuh:88-123``).  Values are plain ints so
they can live inside device tensors (per-chunk status vectors) without host
round-trips.
"""
from __future__ import annotations

import enum

import numpy as np


class Status(enum.IntEnum):
    """Per-call and per-chunk status codes (analog of ``nvcompStatus_t``).

    The decode kernels write one of these per chunk into a device-resident
    ``int32`` status array; corrupt input must yield ``ERROR_CANNOT_DECOMPRESS``
    (with actual size 0), never an out-of-bounds access
    (reference behavior: ``CHANGELOG.md:160-164``).
    """

    SUCCESS = 0
    ERROR_INVALID_VALUE = 10
    ERROR_NOT_SUPPORTED = 11
    ERROR_CANNOT_DECOMPRESS = 12
    ERROR_BAD_CHECKSUM = 13
    ERROR_CANNOT_VERIFY_CHECKSUMS = 14
    ERROR_OUTPUT_BUFFER_TOO_SMALL = 15
    ERROR_COMPRESSION = 16
    ERROR_ALIGNMENT = 17
    ERROR_CHUNK_SIZE_TOO_LARGE = 18
    ERROR_INTERNAL = 10000


class ElementType(enum.IntEnum):
    """Element-type hints for typed codecs (analog of ``nvcompType_t``)."""

    CHAR = 0
    UCHAR = 1
    SHORT = 2
    USHORT = 3
    INT = 4
    UINT = 5
    LONGLONG = 6
    ULONGLONG = 7
    BITS = 0xFF

    @property
    def nbytes(self) -> int:
        return _TYPE_NBYTES[self]

    @property
    def np_dtype(self) -> np.dtype:
        return _TYPE_NP[self]

    @property
    def is_signed(self) -> bool:
        return self in (ElementType.CHAR, ElementType.SHORT, ElementType.INT,
                        ElementType.LONGLONG)


_TYPE_NBYTES = {
    ElementType.CHAR: 1,
    ElementType.UCHAR: 1,
    ElementType.SHORT: 2,
    ElementType.USHORT: 2,
    ElementType.INT: 4,
    ElementType.UINT: 4,
    ElementType.LONGLONG: 8,
    ElementType.ULONGLONG: 8,
    ElementType.BITS: 1,
}

_TYPE_NP = {
    ElementType.CHAR: np.dtype(np.int8),
    ElementType.UCHAR: np.dtype(np.uint8),
    ElementType.SHORT: np.dtype(np.int16),
    ElementType.USHORT: np.dtype(np.uint16),
    ElementType.INT: np.dtype(np.int32),
    ElementType.UINT: np.dtype(np.uint32),
    ElementType.LONGLONG: np.dtype(np.int64),
    ElementType.ULONGLONG: np.dtype(np.uint64),
    ElementType.BITS: np.dtype(np.uint8),
}


def element_type_from_name(name: str) -> ElementType:
    try:
        return ElementType[name.upper()]
    except KeyError as e:
        raise ValueError(f"unknown element type {name!r}") from e


# --- Per-format constants ------------------------------------------------------------
# Analog of nvcomp*CompressionMaxAllowedChunkSize / nvcomp*RequiredAlignment
# (reference: CHANGELOG.md:15,55,57; benchmark_gdeflate_chunked.cu:55-58;
#  benchmark_ans_chunked.cu:40-49; benchmark_cascaded_chunked.cu:36).

DEFAULT_CHUNK_SIZE = 1 << 16  # 64 KiB, the reference's default chunk size

# Required input/output alignment in bytes per format (reference pads to 8 B,
# benchmark_template_chunked.cuh:181-183).
REQUIRED_ALIGNMENT = {
    "lz4": 4,
    "snappy": 4,
    "cascaded": 8,
    "gdeflate": 8,
    "deflate": 8,
    "gzip": 8,
    "zstd": 8,
    "ans": 8,
    "bitcomp": 8,
    "crc32": 4,
}

MAX_ALLOWED_CHUNK_SIZE = {
    "lz4": 1 << 24,
    "snappy": 1 << 24,
    "cascaded": 1 << 24,
    "gdeflate": 1 << 16,   # 64 KB dictionary window formats
    "deflate": 1 << 16,
    "zstd": 1 << 24,       # reference raised 64 KB -> 16 MB in 2.5 (CHANGELOG.md:55)
    "ans": (1 << 32) - 1,  # chunk < 2^32-1 B (benchmark_ans_chunked.cu:40-49)
    "bitcomp": 1 << 24,
}

CASCADED_DEFAULT_SUBCHUNK = 4096  # reference internal sub-chunk (benchmark_cascaded_chunked.cu:36)
