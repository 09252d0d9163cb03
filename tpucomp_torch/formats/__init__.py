"""Format codecs registered with :mod:`tpucomp_torch.batched`.

Port of :mod:`tpucomp.formats`.  LZ4 and Snappy are ported so far (and the
CRC32 of :mod:`.crc32`, which registers no codec); the other formats follow in
the order of ``ROADMAP.md``.
"""
from __future__ import annotations

_REGISTERED = False


def register_all() -> None:
    """Register every ported codec with :mod:`tpucomp_torch.batched` (idempotent)."""
    global _REGISTERED
    if _REGISTERED:
        return
    _REGISTERED = True

    from tpucomp_torch import batched
    from tpucomp_torch.batched import CodecSpec
    from tpucomp_torch.formats import lz4, snappy
    from tpucomp_torch.ops.cuda import (lz4_decode2, lz4_encode2, snappy_decode,
                                        snappy_encode2)

    batched.register(CodecSpec(
        name="lz4",
        # the portable entries are the kernels' plain versions until the
        # log-depth program of tpucomp/formats/lz4.py is ported; opts only
        # carries the data-type hint, which byte-granular matching ignores
        compress_batch=lambda d, s, o, c: lz4_encode2.compress_batch_plain(d, s, c),
        decompress_batch=lz4_decode2.decompress_batch_plain,
        max_compressed_chunk_size=lz4.max_compressed_chunk_size,
        default_opts=lz4.DEFAULT_OPTS,
        elem_size=lambda o: o.data_type.nbytes,
    ))
    batched.register(CodecSpec(
        name="snappy",
        # the portable entries are the kernels' plain versions until the
        # log-depth program of tpucomp/formats/snappy.py is ported
        compress_batch=lambda d, s, o, c: snappy_encode2.compress_batch_plain(d, s, c),
        decompress_batch=snappy_decode.decompress_batch_plain,
        max_compressed_chunk_size=snappy.max_compressed_chunk_size,
        default_opts=snappy.DEFAULT_OPTS,
        get_decompress_size=snappy.get_decompress_size,
    ))
