"""Hand-written Hopper kernels — the kernel layer of the port.

Port of :mod:`tpucomp.ops.pallas` (``tpucomp/ops/pallas/__init__.py:44-56,
154-165,183-281``).  Each kernel is CUDA C++ for ``sm_90a`` under ``csrc/``,
built at first use by :mod:`._build` and called through ctypes; beside it, in
the same module, sits its plain version with the same signature.

- :mod:`.lz4_decode2` — LZ4 block decode (``csrc/lz4_decode.cu``).
- :mod:`.lz4_encode2` — LZ4 emitter over :func:`tpucomp_torch.ops.match
  .candidates2` (``csrc/lz4_encode.cu``).
- :mod:`.snappy_decode` — Snappy block decode (``csrc/snappy_decode.cu``).
- :mod:`.snappy_encode2` — Snappy emitter over :func:`tpucomp_torch.ops.match
  .candidates2` (``csrc/snappy_encode.cu``).
- ``csrc/bytecopy.cuh`` — the warp byte-copy helpers all four share.

``KERNEL_DECODERS`` / ``KERNEL_ENCODERS`` map a format name to the kernel
path, a drop-in for the registry's ``decompress_batch`` / ``compress_batch``
(same signature and semantics).  They take CUDA tensors and raise for others.
"""
from __future__ import annotations


def _lz4_decompress_batch(comp, comp_sizes, out_cap):
    from tpucomp_torch.ops.cuda import lz4_decode2
    return lz4_decode2.decompress_batch(comp, comp_sizes, out_cap)


def _lz4_compress_batch(data, sizes, opts, out_cap):
    # opts carries the data-type hint; matching is byte-granular, so the hint
    # is accepted and ignored (the output is valid for every type)
    from tpucomp_torch.ops.cuda import lz4_encode2
    return lz4_encode2.compress_batch(data, sizes, out_cap)


def _snappy_decompress_batch(comp, comp_sizes, out_cap):
    from tpucomp_torch.ops.cuda import snappy_decode
    return snappy_decode.decompress_batch(comp, comp_sizes, out_cap)


def _snappy_compress_batch(data, sizes, opts, out_cap):
    from tpucomp_torch.ops.cuda import snappy_encode2   # SnappyOpts is empty
    return snappy_encode2.compress_batch(data, sizes, out_cap)


KERNEL_DECODERS = {
    "lz4": _lz4_decompress_batch,
    "snappy": _snappy_decompress_batch,
}

KERNEL_ENCODERS = {
    "lz4": _lz4_compress_batch,
    "snappy": _snappy_compress_batch,
}
