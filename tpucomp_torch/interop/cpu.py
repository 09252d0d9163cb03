"""CPU LZ4 oracle via ctypes bindings to liblz4.

Port of the liblz4 part of :mod:`tpucomp.interop.cpu` (``:21-84``): the
correctness oracle of the LZ4 path.  CPU-compress -> GPU-decompress and
GPU-compress -> CPU-decompress must both round-trip bit-exactly, which proves
the kernels implement the public format rather than merely being self-inverse.
The binding is optional: it raises ``InteropUnavailable`` if the system
library is missing.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools


class InteropUnavailable(RuntimeError):
    pass


def _load(candidates: list[str]) -> ctypes.CDLL:
    last_err: Exception | None = None
    for name in candidates:
        try:
            return ctypes.CDLL(name)
        except OSError as e:  # pragma: no cover - depends on system
            last_err = e
    found = ctypes.util.find_library(candidates[0].split(".")[0].removeprefix("lib"))
    if found:
        try:
            return ctypes.CDLL(found)
        except OSError as e:  # pragma: no cover
            last_err = e
    raise InteropUnavailable(f"none of {candidates} could be loaded: {last_err}")


@functools.lru_cache(maxsize=1)
def _lz4() -> ctypes.CDLL:
    lib = _load(["liblz4.so.1", "liblz4.so"])
    lib.LZ4_compress_default.restype = ctypes.c_int
    lib.LZ4_compress_default.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                         ctypes.c_int, ctypes.c_int]
    lib.LZ4_compress_HC.restype = ctypes.c_int
    lib.LZ4_compress_HC.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                    ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.LZ4_decompress_safe.restype = ctypes.c_int
    lib.LZ4_decompress_safe.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                        ctypes.c_int, ctypes.c_int]
    lib.LZ4_compressBound.restype = ctypes.c_int
    lib.LZ4_compressBound.argtypes = [ctypes.c_int]
    return lib


def lz4_compress(data: bytes, hc_level: int | None = None) -> bytes:
    """LZ4 block-format compress via liblz4 (LZ4_compress_default / LZ4_compress_HC).

    Mirrors ``examples/lz4_cpu_compression.cu:61-66`` (which uses LZ4_compress_HC).
    """
    lib = _lz4()
    bound = lib.LZ4_compressBound(len(data))
    out = ctypes.create_string_buffer(max(bound, 1))
    if hc_level is None:
        n = lib.LZ4_compress_default(data, out, len(data), bound)
    else:
        n = lib.LZ4_compress_HC(data, out, len(data), bound, hc_level)
    if n <= 0:
        raise RuntimeError(f"LZ4 compression failed (rc={n})")
    return out.raw[:n]


def lz4_decompress(data: bytes, uncompressed_size: int) -> bytes:
    """LZ4 block-format decompress via LZ4_decompress_safe (bounds-checked)."""
    lib = _lz4()
    out = ctypes.create_string_buffer(max(uncompressed_size, 1))
    n = lib.LZ4_decompress_safe(data, out, len(data), uncompressed_size)
    if n < 0:
        raise RuntimeError(f"LZ4 decompression failed (rc={n})")
    return out.raw[:n]


def available() -> dict[str, bool]:
    """Report which interop oracles can load on this system."""
    try:
        _lz4()
        return {"lz4": True}
    except InteropUnavailable:
        return {"lz4": False}
