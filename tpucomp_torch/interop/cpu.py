"""CPU LZ4 and Snappy oracles via ctypes bindings to liblz4 and libsnappy.

Port of the liblz4 and libsnappy parts of :mod:`tpucomp.interop.cpu`
(``:21-128``): the correctness oracles of the LZ4 and Snappy paths.
CPU-compress -> GPU-decompress and GPU-compress -> CPU-decompress must both
round-trip bit-exactly, which proves the kernels implement the public format
rather than merely being self-inverse.  The bindings are optional: each raises
``InteropUnavailable`` if its system library is missing.
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


@functools.lru_cache(maxsize=1)
def _snappy() -> ctypes.CDLL:
    lib = _load(["libsnappy.so.1", "libsnappy.so"])
    lib.snappy_compress.restype = ctypes.c_int
    lib.snappy_compress.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                    ctypes.c_char_p, ctypes.POINTER(ctypes.c_size_t)]
    lib.snappy_uncompress.restype = ctypes.c_int
    lib.snappy_uncompress.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                      ctypes.c_char_p, ctypes.POINTER(ctypes.c_size_t)]
    lib.snappy_max_compressed_length.restype = ctypes.c_size_t
    lib.snappy_max_compressed_length.argtypes = [ctypes.c_size_t]
    lib.snappy_uncompressed_length.restype = ctypes.c_int
    lib.snappy_uncompressed_length.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                               ctypes.POINTER(ctypes.c_size_t)]
    return lib


def snappy_compress(data: bytes) -> bytes:
    """Raw Snappy block compress via libsnappy's C bindings."""
    lib = _snappy()
    out_len = ctypes.c_size_t(lib.snappy_max_compressed_length(len(data)))
    out = ctypes.create_string_buffer(max(out_len.value, 1))
    rc = lib.snappy_compress(data, len(data), out, ctypes.byref(out_len))
    if rc != 0:
        raise RuntimeError(f"snappy_compress failed (rc={rc})")
    return out.raw[:out_len.value]


def snappy_decompress(data: bytes) -> bytes:
    """Raw Snappy block decompress via libsnappy (reads the varint preamble)."""
    lib = _snappy()
    out_len = ctypes.c_size_t(0)
    rc = lib.snappy_uncompressed_length(data, len(data), ctypes.byref(out_len))
    if rc != 0:
        raise RuntimeError(f"snappy_uncompressed_length failed (rc={rc})")
    out = ctypes.create_string_buffer(max(out_len.value, 1))
    rc = lib.snappy_uncompress(data, len(data), out, ctypes.byref(out_len))
    if rc != 0:
        raise RuntimeError(f"snappy_uncompress failed (rc={rc})")
    return out.raw[:out_len.value]


def available() -> dict[str, bool]:
    """Report which interop oracles can load on this system."""
    out = {}
    for name, loader in (("lz4", _lz4), ("snappy", _snappy)):
        try:
            loader()
            out[name] = True
        except InteropUnavailable:
            out[name] = False
    return out
