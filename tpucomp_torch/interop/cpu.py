"""CPU oracles: liblz4, libsnappy, libdeflate and libzstd via ctypes, zlib and gzip.

Port of :mod:`tpucomp.interop.cpu` (``:21-229``): the correctness oracles of
the ported paths.  The reference's zstd oracle is python-zstandard; the port
binds libzstd itself, which the card's machine has without that module.  CPU-compress ->
GPU-decompress and GPU-compress -> CPU-decompress must both round-trip
bit-exactly, which proves the kernels implement the public format rather than
merely being self-inverse.  zlib is Python's own and always present; the
ctypes bindings are optional: each raises ``InteropUnavailable`` if its system
library is missing.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools
import zlib as _zlib


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


def deflate_compress(data: bytes, level: int = 6) -> bytes:
    """RFC 1951 raw deflate via zlib (``deflateInit2(..., -15, ...)``, as
    ``examples/deflate_cpu_compression.cu:60-101``)."""
    c = _zlib.compressobj(level, _zlib.DEFLATED, -15)
    return c.compress(data) + c.flush()


def deflate_decompress(data: bytes, uncompressed_size: int | None = None) -> bytes:
    d = _zlib.decompressobj(-15)
    return d.decompress(data) + d.flush()


def gzip_compress(data: bytes, level: int = 6) -> bytes:
    """RFC 1952 gzip via zlib windowBits 15|16
    (``examples/gzip_gpu_decompression.cu:66-80``)."""
    c = _zlib.compressobj(level, _zlib.DEFLATED, 15 | 16)
    return c.compress(data) + c.flush()


def gzip_decompress(data: bytes) -> bytes:
    d = _zlib.decompressobj(15 | 16)
    return d.decompress(data) + d.flush()


def zlib_compress(data: bytes, level: int = 6) -> bytes:
    return _zlib.compress(data, level)


@functools.lru_cache(maxsize=1)
def _libdeflate() -> ctypes.CDLL:
    lib = _load(["libdeflate.so.0", "libdeflate.so"])
    lib.libdeflate_alloc_compressor.restype = ctypes.c_void_p
    lib.libdeflate_alloc_compressor.argtypes = [ctypes.c_int]
    lib.libdeflate_deflate_compress.restype = ctypes.c_size_t
    lib.libdeflate_deflate_compress.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_size_t]
    lib.libdeflate_alloc_decompressor.restype = ctypes.c_void_p
    lib.libdeflate_alloc_decompressor.argtypes = []
    lib.libdeflate_deflate_decompress.restype = ctypes.c_int
    lib.libdeflate_deflate_decompress.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
        ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t)]
    return lib


def libdeflate_compress(data: bytes, level: int = 6) -> bytes:
    """Raw deflate via libdeflate (a second, independent oracle)."""
    lib = _libdeflate()
    comp = lib.libdeflate_alloc_compressor(level)
    bound = len(data) + len(data) // 2 + 1024
    out = ctypes.create_string_buffer(bound)
    n = lib.libdeflate_deflate_compress(comp, data, len(data), out, bound)
    if n == 0:
        raise RuntimeError("libdeflate_deflate_compress failed")
    return out.raw[:n]


def libdeflate_decompress(data: bytes, uncompressed_size: int) -> bytes:
    lib = _libdeflate()
    dec = lib.libdeflate_alloc_decompressor()
    out = ctypes.create_string_buffer(max(uncompressed_size, 1))
    actual = ctypes.c_size_t(0)
    rc = lib.libdeflate_deflate_decompress(dec, data, len(data), out,
                                           uncompressed_size, ctypes.byref(actual))
    if rc != 0:
        raise RuntimeError(f"libdeflate_deflate_decompress failed (rc={rc})")
    return out.raw[:actual.value]


@functools.lru_cache(maxsize=1)
def _zstd() -> ctypes.CDLL:
    lib = _load(["libzstd.so.1", "libzstd.so"])
    size_t = ctypes.c_size_t
    lib.ZSTD_compressBound.restype = size_t
    lib.ZSTD_compressBound.argtypes = [size_t]
    lib.ZSTD_compress.restype = size_t
    lib.ZSTD_compress.argtypes = [ctypes.c_char_p, size_t, ctypes.c_char_p, size_t, ctypes.c_int]
    lib.ZSTD_decompress.restype = size_t
    lib.ZSTD_decompress.argtypes = [ctypes.c_char_p, size_t, ctypes.c_char_p, size_t]
    lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
    lib.ZSTD_getFrameContentSize.argtypes = [ctypes.c_char_p, size_t]
    lib.ZSTD_isError.restype = ctypes.c_uint
    lib.ZSTD_isError.argtypes = [size_t]
    return lib


def zstd_compress(data: bytes, level: int = 3) -> bytes:
    """One Zstandard frame via libzstd's ``ZSTD_compress`` (content size in
    the header, no checksum)."""
    lib = _zstd()
    bound = lib.ZSTD_compressBound(len(data))
    out = ctypes.create_string_buffer(max(bound, 1))
    n = lib.ZSTD_compress(out, bound, data, len(data), level)
    if lib.ZSTD_isError(n):
        raise RuntimeError(f"ZSTD_compress failed (rc={n})")
    return out.raw[:n]


def zstd_decompress(data: bytes, uncompressed_size: int | None = None) -> bytes:
    """One frame via ``ZSTD_decompress``; without ``uncompressed_size`` the
    frame must carry its content size."""
    lib = _zstd()
    if uncompressed_size is None:
        n = lib.ZSTD_getFrameContentSize(data, len(data))
        if n >= (1 << 64) - 2:   # ZSTD_CONTENTSIZE_UNKNOWN / _ERROR
            raise RuntimeError("the zstd frame carries no content size")
        uncompressed_size = n
    out = ctypes.create_string_buffer(max(uncompressed_size, 1))
    n = lib.ZSTD_decompress(out, uncompressed_size, data, len(data))
    if lib.ZSTD_isError(n):
        raise RuntimeError(f"ZSTD_decompress failed (rc={n})")
    return out.raw[:n]


def available() -> dict[str, bool]:
    """Report which interop oracles can load on this system."""
    out = {"zlib": True, "gzip": True}
    for name, loader in (("lz4", _lz4), ("snappy", _snappy), ("libdeflate", _libdeflate),
                         ("zstd", _zstd)):
        try:
            loader()
            out[name] = True
        except InteropUnavailable:
            out[name] = False
    return out
