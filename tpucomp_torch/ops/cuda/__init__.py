"""Hand-written Hopper kernels — the kernel layer of the port.

Port of :mod:`tpucomp.ops.pallas` (``tpucomp/ops/pallas/__init__.py:44-56,
85-97,154-165,183-281``) and of the kernel variants beside it.  Each kernel
is CUDA C++ for ``sm_90a`` under ``csrc/``, built at first use by
:mod:`._build` and called through ctypes; beside it, in the same module,
sits its plain version with the same signature.

- :mod:`.lz4_decode2` — LZ4 block decode (``csrc/lz4_decode.cu``).
- :mod:`.lz4_encode2` — LZ4 emitter over :func:`tpucomp_torch.ops.match
  .candidates2` (``csrc/lz4_encode.cu``).
- :mod:`.snappy_decode` — Snappy block decode (``csrc/snappy_decode.cu``).
- :mod:`.snappy_encode2` — Snappy emitter over :func:`tpucomp_torch.ops.match
  .candidates2` (``csrc/snappy_encode.cu``).
- :mod:`.deflate_decode` — raw Deflate decode (``csrc/deflate_decode.cu``:
  a decoding warp and a copying warp a chunk over a shared-memory window;
  its plain version walks the blocks with the table builder of
  :mod:`.huffman`); gzip runs it at each member's body.
- :mod:`.deflate_encode` — Deflate over :func:`tpucomp_torch.ops
  .match.candidates2`: the walk in modes fixed and hist, the parallel parse
  of ``csrc/lz_parse.cuh`` for emit (``csrc/deflate_encode.cu``), with the
  dynamic tables in torch ops.
- :mod:`.zstd_decode` — the RFC 8878 frame decoder behind the reference's two
  wrappers, chosen by its dispatch gate: both run :mod:`.zstd_passes`, the
  block-parallel passes (``csrc/zstd_passes.cu``), with the frame walk
  (``csrc/zstd_decode.cu``) for frames that cannot fit their ``out_cap``.
- :mod:`.zstd_encode` — Zstandard over :func:`tpucomp_torch.ops
  .match.candidates2`: the walk in modes hist and full, and a gated parse
  for full's chunks whose walk is long (``csrc/zstd_encode.cu``), with the
  FSE and Huffman tables in torch ops; chunks up to 64 KiB (wider ones take
  the multi-block encoder of :mod:`tpucomp_torch.formats.zstd`).
- :mod:`.gdeflate_vdecode` — the GDeflate 32-lane tile parse and the token
  replay (``csrc/gdeflate_vdecode.cu``).
- :mod:`.gdeflate_encode` — GDeflate over :func:`tpucomp_torch.ops
  .match.candidates2`: the walk in mode hist, the parallel parse for fixed
  and emit, emitting into 32 lane bit buffers (``csrc/gdeflate_encode.cu``),
  with the refill schedule, the tile assembly and the dynamic tables in
  torch ops.
- :mod:`.lz_parse` — the plain versions of the parallel LZ77 token parse
  that the Deflate and GDeflate kernels share (``csrc/lz_parse.cuh``, whose
  pieces the Zstandard parse also uses).
- :mod:`.ans_decode` — the rANS decode walk (``csrc/ans_decode.cu``), one
  kernel behind the reference's single-chunk and wide wrappers.
- :mod:`.ans_encode` — the rANS encode walk (``csrc/ans_encode.cu``), likewise,
  between the tables and the serialization in torch ops.
- :mod:`.cascaded_expand` — both RLE expansions of a Cascaded chunk
  (``csrc/cascaded_expand.cu``), inside :mod:`tpucomp_torch.ops
  .cascaded_fast`'s decoder; that module's encoder is torch ops.
- the reference's variants that no dispatch table reaches, each behind its
  own entry point with the reference's signature: :mod:`.lz4_decode` (one
  chunk a block) and :mod:`.lz4_decodek` (``k`` chunks a block), row 1's
  walk in ``csrc/lz4_decode.cu``; :mod:`.lz4_encode` and
  :mod:`.snappy_encode`, the hash-table encoders (``csrc/hash_encode.cu``);
  :mod:`.gdeflate_decode`, the serial tile decoder
  (``csrc/gdeflate_decode.cu``).
- ``csrc/ans.cuh`` — the rANS warp blocks both ANS kernels run (the
  device-side API analog).
- ``csrc/bytecopy.cuh`` — the warp byte-copy helpers they share;
  ``csrc/emit.cuh`` — the LZ4 and Snappy element emission the four LZ4 and
  Snappy encoders share.

``KERNEL_DECODERS`` / ``KERNEL_ENCODERS`` map a format name to the kernel
path, a drop-in for the registry's ``decompress_batch`` / ``compress_batch``
(same signature and semantics).  They take CUDA tensors and raise for others.
``PLAIN_DECODERS`` / ``PLAIN_ENCODERS`` hold a kernel path's plain version
where the registry's entry is another program.
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


def _deflate_decompress_batch(comp, comp_sizes, out_cap):
    from tpucomp_torch.ops.cuda import deflate_decode
    return deflate_decode.decompress_batch(comp, comp_sizes, out_cap)


def _gzip_decompress_batch(comp, comp_sizes, out_cap):
    """Header parse, the Deflate kernel at each member's body, CRC32/ISIZE
    checks (``tpucomp/ops/pallas/__init__.py:126-151``)."""
    from tpucomp_torch.formats import gzip
    from tpucomp_torch.ops.cuda import deflate_decode
    return gzip.decompress_batch_with(deflate_decode.decompress_batch, comp, comp_sizes,
                                      out_cap)


def _zstd_decompress_batch(comp, comp_sizes, out_cap):
    """Row 18 or row 19 by the reference's gate (``ops/pallas/__init__.py:100-123``;
    its interpret-mode XLA fallback is a CPU affair with no counterpart here)."""
    from tpucomp_torch.ops.cuda import zstd_decode
    return zstd_decode.dispatch(comp, comp_sizes, out_cap)


def _zstd_compress_batch(data, sizes, opts, out_cap):
    """The exact-entropy kernel pipeline up to 64 KiB chunks; above, the
    reference's multi-block encoder in torch ops on the card
    (``ops/pallas/__init__.py:253-267``).  ZstdOpts is empty."""
    from tpucomp_torch.ops.cuda import zstd_encode
    return zstd_encode.dispatch(data, sizes, out_cap)


def _deflate_compress_batch(data, sizes, opts, out_cap):
    from tpucomp_torch.ops.cuda import deflate_encode
    return deflate_encode.compress_algo(data, sizes, opts, out_cap)


def _gdeflate_decompress_batch(comp, comp_sizes, out_cap):
    from tpucomp_torch.ops.cuda import gdeflate_vdecode
    return gdeflate_vdecode.decompress_batch(comp, comp_sizes, out_cap)


def _gdeflate_compress_batch(data, sizes, opts, out_cap):
    """The algo ladder: 0 fixed tables, 1 dynamic tables, 2 entropy only
    (``ops/pallas/__init__.py:235-252``)."""
    from tpucomp_torch.ops.cuda import gdeflate_encode
    return gdeflate_encode.compress_algo(data, sizes, opts, out_cap)


def _ans_decompress_batch(comp, comp_sizes, out_cap):
    """The wide wrapper, as the reference dispatches (``ops/pallas/__init__.py:67-74``)."""
    from tpucomp_torch.ops.cuda import ans_decode
    return ans_decode.decompress_batch_wide(comp, comp_sizes, out_cap)


def _ans_compress_batch(data, sizes, opts, out_cap):
    """The wide wrapper, as the reference dispatches (``ops/pallas/__init__.py:204-211``).
    ANSOpts is empty."""
    from tpucomp_torch.ops.cuda import ans_encode
    return ans_encode.compress_batch_wide(data, sizes, out_cap)


def _on_card(x, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"the cascaded fast path ({what}) needs CUDA tensors, got {x.device}")


def _cascaded_decompress_batch(comp, comp_sizes, out_cap):
    """The fast path (``ops/pallas/__init__.py:168-173``) with row 26 as the
    kernel; out_caps above 1 MiB take its gate to the general program."""
    _on_card(comp, "decode")
    from tpucomp_torch.ops import cascaded_fast
    return cascaded_fast.decompress_batch(comp, comp_sizes, out_cap)


def _cascaded_compress_batch(data, sizes, opts, out_cap):
    """The fast encoder (``ops/pallas/__init__.py:176-180``), torch ops on the
    card: the reference's reaches no kernel either."""
    _on_card(data, "encode")
    from tpucomp_torch.ops import cascaded_fast
    return cascaded_fast.compress_batch(data, sizes, opts, out_cap)


def _cascaded_decompress_plain(comp, comp_sizes, out_cap):
    """The fast path with row 26's plain version, on any device."""
    from tpucomp_torch.ops import cascaded_fast
    return cascaded_fast.decompress_batch(comp, comp_sizes, out_cap, plain=True)


def _cascaded_compress_plain(data, sizes, opts, out_cap):
    from tpucomp_torch.ops import cascaded_fast
    return cascaded_fast.compress_batch(data, sizes, opts, out_cap)


KERNEL_DECODERS = {
    "lz4": _lz4_decompress_batch,
    "snappy": _snappy_decompress_batch,
    "deflate": _deflate_decompress_batch,
    "gzip": _gzip_decompress_batch,
    "zstd": _zstd_decompress_batch,
    "gdeflate": _gdeflate_decompress_batch,
    "ans": _ans_decompress_batch,
    "cascaded": _cascaded_decompress_batch,
}

KERNEL_ENCODERS = {
    "lz4": _lz4_compress_batch,
    "snappy": _snappy_compress_batch,
    "deflate": _deflate_compress_batch,
    "zstd": _zstd_compress_batch,
    "gdeflate": _gdeflate_compress_batch,
    "ans": _ans_compress_batch,
    "cascaded": _cascaded_compress_batch,
}

# The kernel paths' plain versions where they are not the registry's entry
# (Cascaded's is the general program): ``backend="pallas"`` takes these for
# CPU tensors, as the reference's interpret mode runs its Pallas path.
PLAIN_DECODERS = {"cascaded": _cascaded_decompress_plain}
PLAIN_ENCODERS = {"cascaded": _cascaded_compress_plain}
