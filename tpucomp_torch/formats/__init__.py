"""Format codecs registered with :mod:`tpucomp_torch.batched`.

Port of :mod:`tpucomp.formats`.  LZ4, Snappy, Deflate, gzip (decompression
only), Zstandard, GDeflate, ANS and
Cascaded are ported so far
(and the CRC32 of :mod:`.crc32`, which registers no codec); the other
formats follow in the order of ``ROADMAP.md``.
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
    from tpucomp_torch.formats import (ans, cascaded, deflate, gdeflate, gzip, lz4, snappy,
                                       zstd)
    from tpucomp_torch.ops.cuda import (ans_decode, ans_encode, deflate_decode,
                                        deflate_encode, gdeflate_encode, gdeflate_vdecode,
                                        lz4_decode2, lz4_encode2, snappy_decode,
                                        snappy_encode2, zstd_decode, zstd_encode)

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
    batched.register(CodecSpec(
        name="deflate",
        # the portable entries are the kernels' plain versions until the
        # log-depth program of tpucomp/formats/deflate.py is ported
        compress_batch=lambda d, s, o, c: deflate_encode.compress_algo(d, s, o, c, plain=True),
        decompress_batch=deflate_decode.decompress_batch_plain,
        max_compressed_chunk_size=deflate.max_compressed_chunk_size,
        default_opts=deflate.DEFAULT_OPTS,
    ))
    batched.register(CodecSpec(
        name="gzip",
        compress_batch=gzip.no_compress,
        decompress_batch=gzip.decompress_batch_plain,
        max_compressed_chunk_size=gzip.max_compressed_chunk_size,
        default_opts=None,
        get_decompress_size=gzip.get_decompress_size,
        decompression_only=True,
    ))
    batched.register(CodecSpec(
        name="zstd",
        # the portable entry is the kernel pipeline's plain version up to
        # 64 KiB chunks; above, the reference's multi-block encoder
        # (formats/zstd.py::compress_batch), as the reference's dispatch
        compress_batch=lambda d, s, o, c: zstd_encode.dispatch(d, s, c, plain=True),
        decompress_batch=lambda c, s, oc: zstd_decode.dispatch(c, s, oc, plain=True),
        max_compressed_chunk_size=zstd.max_compressed_chunk_size,
        default_opts=zstd.DEFAULT_OPTS,
        get_decompress_size=zstd.get_decompress_size,
    ))
    batched.register(CodecSpec(
        name="gdeflate",
        # the portable entries are the kernels' plain versions until the XLA
        # program of tpucomp/formats/gdeflate.py is ported (ROADMAP A.6)
        compress_batch=lambda d, s, o, c: gdeflate_encode.compress_algo(d, s, o, c, plain=True),
        decompress_batch=gdeflate_vdecode.decompress_batch_plain,
        max_compressed_chunk_size=gdeflate.max_compressed_chunk_size,
        default_opts=gdeflate.DEFAULT_OPTS,
        get_decompress_size=gdeflate.get_decompress_size,
    ))
    batched.register(CodecSpec(
        name="ans",
        # the portable entries are the kernels' plain versions until the XLA
        # program of tpucomp/formats/ans.py is ported (ROADMAP A.6); ANSOpts
        # is empty
        compress_batch=lambda d, s, o, c: ans_encode.compress_batch_plain(d, s, c),
        decompress_batch=ans_decode.decompress_batch_plain,
        max_compressed_chunk_size=ans.max_compressed_chunk_size,
        default_opts=ans.DEFAULT_OPTS,
        get_decompress_size=ans.get_decompress_size,
    ))
    batched.register(CodecSpec(
        name="cascaded",
        # the general program (the reference's registry entry and its
        # backend "xla"); the fast path with the row-26 kernel is the
        # kernel dispatch's
        compress_batch=cascaded.compress_batch,
        decompress_batch=cascaded.decompress_batch,
        max_compressed_chunk_size=cascaded.max_compressed_chunk_size,
        default_opts=cascaded.DEFAULT_OPTS,
        get_decompress_size=cascaded.get_decompress_size,
        elem_size=lambda o: o.type.nbytes,
    ))
