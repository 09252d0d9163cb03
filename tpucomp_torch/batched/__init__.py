"""tpucomp_torch.batched — the low-level batched API (LLIF analog), on torch.

Port of :mod:`tpucomp.batched`: batches of independent chunks with
device-resident size vectors, padded max-size outputs, per-chunk actual sizes
and per-chunk status codes, the analog of nvCOMP's ``nvcompBatched<Fmt>*``
C function families (``doc/lowlevel_c_quickstart.md:32-137``).

* A batch is one dense ``uint8[num_chunks, max_chunk_bytes]`` tensor plus
  ``int32[num_chunks]`` sizes (:class:`tpucomp_torch.chunk.ChunkBatch`).
* Calls launch on the current CUDA stream and return without waiting; the
  analog of ``cudaStreamSynchronize`` is ``torch.cuda.synchronize``.
* The ``*_get_temp_size*`` functions exist for API parity and return 0: the
  kernels take no scratch of the caller's.

``backend`` selects the implementation of a call:

* ``"auto"`` — the Hopper kernel for CUDA tensors, the plain version for CPU
  tensors; ``TPUCOMP_ENCODE_BACKEND`` / ``TPUCOMP_DECODE_BACKEND`` override it
  (the reference's variables);
* ``"kernel"`` — the Hopper kernel; raises for CPU tensors;
* ``"pallas"`` — the reference's name for its kernel path, from the argument
  or the variables: the Hopper kernel for CUDA tensors, its plain version for
  CPU tensors (the role of the reference's interpret mode); a format with no
  kernel raises the reference's ``ValueError``;
* ``"plain"`` — the plain version, on any device (for tests and checks);
* ``"xla"`` — the reference's log-depth program: for ``cascaded`` the
  registered general program (as the reference's ``xla``), for ``zstd``
  compress the multi-block encoder at every chunk size; for the other
  formats and directions, not ported yet, ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable

import torch

from tpucomp_torch import logging as tlog
from tpucomp_torch.chunk import ChunkBatch
from tpucomp_torch.constants import MAX_ALLOWED_CHUNK_SIZE, REQUIRED_ALIGNMENT, Status
from tpucomp_torch.formats import zstd as fzstd

_LOG_DEPTH_TODO = ("the log-depth program of tpucomp/formats/{fmt}.py + "
                   "ops/parallel_lz.py is not ported yet (ROADMAP.md, queue A)")


@dataclasses.dataclass(frozen=True)
class CodecSpec:
    """One registered format (analog of a ``nvcompBatched<Fmt>`` function family)."""

    name: str
    compress_batch: Callable | None  # (data, sizes, opts, out_cap) -> (out, out_sizes, statuses)
    decompress_batch: Callable  # (comp, comp_sizes, out_cap) -> (out, out_sizes, statuses)
    max_compressed_chunk_size: Callable[[int, Any], int]
    default_opts: Any
    get_decompress_size: Callable | None = None  # (comp, comp_sizes) -> sizes
    elem_size: Callable[[Any], int] | None = None  # typed codecs: opts -> element bytes
    decompression_only: bool = False  # e.g. gzip (README.md:16)


_REGISTRY: dict[str, CodecSpec] = {}


def register(spec: CodecSpec) -> None:
    _REGISTRY[spec.name] = spec


def formats() -> list[str]:
    """All registered format names."""
    _ensure_registered()
    return sorted(_REGISTRY)


def _get(name: str) -> CodecSpec:
    _ensure_registered()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown format {name!r}; available: {formats()}") from None


def _ensure_registered() -> None:
    if _REGISTRY:
        return
    # late import to avoid cycles
    from tpucomp_torch.formats import register_all
    register_all()


# -------------------------------------------------------------------------------------
# public API
# -------------------------------------------------------------------------------------

def compress_get_max_output_chunk_size(fmt: str, max_uncompressed_chunk_bytes: int,
                                       opts: Any = None) -> int:
    """Analog of ``nvcompBatched<Fmt>CompressGetMaxOutputChunkSize``."""
    spec = _get(fmt)
    opts = opts if opts is not None else spec.default_opts
    return spec.max_compressed_chunk_size(max_uncompressed_chunk_bytes, opts)


def compress_get_temp_size(fmt: str, num_chunks: int = 0,
                           max_uncompressed_chunk_bytes: int = 0) -> int:
    """API-parity shim: the kernels need no caller scratch, so 0."""
    _get(fmt)
    return 0


def decompress_get_temp_size(fmt: str, num_chunks: int = 0,
                             max_uncompressed_chunk_bytes: int = 0) -> int:
    """API-parity shim: the kernels need no caller scratch, so 0."""
    _get(fmt)
    return 0


def compress_get_temp_size_ex(fmt: str, num_chunks: int = 0,
                              max_uncompressed_chunk_bytes: int = 0,
                              max_total_uncompressed_bytes: int = 0) -> int:
    """Analog of ``nvcompBatched<Fmt>CompressGetTempSizeEx``; 0, as above."""
    _get(fmt)
    return 0


def decompress_get_temp_size_ex(fmt: str, num_chunks: int = 0,
                                max_uncompressed_chunk_bytes: int = 0,
                                max_total_uncompressed_bytes: int = 0) -> int:
    """Analog of ``nvcompBatched<Fmt>DecompressGetTempSizeEx``; 0, as above."""
    _get(fmt)
    return 0


def _alignment_failure(n: int, out_cap: int, device: torch.device):
    """Whole-call ``nvcompErrorAlignment`` analog (``CHANGELOG.md:15-16``)."""
    return (ChunkBatch(data=torch.zeros((n, out_cap), dtype=torch.uint8, device=device),
                       sizes=torch.zeros((n,), dtype=torch.int32, device=device)),
            torch.full((n,), int(Status.ERROR_ALIGNMENT), dtype=torch.int32,
                       device=device))


def _input_violations(fmt: str, spec: CodecSpec, sizes: torch.Tensor,
                      opts: Any) -> torch.Tensor:
    """Per-chunk status overrides for invalid compression inputs (0 = valid):
    chunk size above ``MaxAllowedChunkSize`` (``CHANGELOG.md:15,57``) and, for
    typed codecs, chunk bytes not a multiple of the element size
    (``benchmark_lz4_chunked.cu:48-84``)."""
    sizes = sizes.to(torch.int64)
    v = torch.zeros(sizes.shape, dtype=torch.int32, device=sizes.device)
    max_sz = MAX_ALLOWED_CHUNK_SIZE.get(fmt)
    if max_sz is not None and max_sz < 2**31:
        v = torch.where(sizes > max_sz, int(Status.ERROR_CHUNK_SIZE_TOO_LARGE), v)
    if spec.elem_size is not None:
        es = int(spec.elem_size(opts))
        if es > 1:
            v = torch.where(sizes % es != 0, int(Status.ERROR_INVALID_VALUE), v)
    return v.to(torch.int32)


_ENV_BACKEND = {"encoder": "TPUCOMP_ENCODE_BACKEND", "decoder": "TPUCOMP_DECODE_BACKEND"}
# the reference's xla entries the port has, by (format, kind); None: the
# registered plain entry is the reference's xla program
_XLA_ENTRIES = {("cascaded", "encoder"): None, ("cascaded", "decoder"): None,
                ("zstd", "encoder"): fzstd.compress_batch}


def _impl(fmt: str, backend: str, on_cuda: bool, kernels: dict, plains: dict,
          plain: Callable, kind: str) -> Callable:
    """Resolve the implementation for ``backend`` (see the module docstring)."""
    if backend == "auto":
        backend = os.environ.get(_ENV_BACKEND[kind], "auto")
    if backend == "auto":
        backend = "kernel" if on_cuda and fmt in kernels else "plain"
    if backend == "pallas":
        if fmt not in kernels:
            raise ValueError(f"no Pallas {kind} for {fmt!r}; available: {sorted(kernels)}")
        return kernels[fmt] if on_cuda else plains.get(fmt, plain)
    if backend == "kernel":
        try:
            return kernels[fmt]
        except KeyError:
            raise ValueError(f"no Hopper {kind} for {fmt!r}; "
                             f"available: {sorted(kernels)}") from None
    if backend == "plain":
        return plain
    if backend == "xla":
        if (fmt, kind) in _XLA_ENTRIES:
            return _XLA_ENTRIES[fmt, kind] or plain
        raise NotImplementedError(f"backend 'xla': {_LOG_DEPTH_TODO.format(fmt=fmt)}")
    raise ValueError(f"unknown backend {backend!r} (auto/kernel/pallas/plain/xla)")


def _encode_fn(fmt: str, spec: CodecSpec, backend: str, device: torch.device) -> Callable:
    """The encode implementation for ``backend`` on ``device`` (the
    reference's ``_encode_fn``; the Manager calls it directly)."""
    from tpucomp_torch.ops import cuda as kc
    return _impl(fmt, backend, device.type == "cuda", kc.KERNEL_ENCODERS, kc.PLAIN_ENCODERS,
                 spec.compress_batch, "encoder")


def _decode_fn(fmt: str, spec: CodecSpec, backend: str, device: torch.device) -> Callable:
    """The decode implementation for ``backend`` on ``device``."""
    from tpucomp_torch.ops import cuda as kc
    return _impl(fmt, backend, device.type == "cuda", kc.KERNEL_DECODERS, kc.PLAIN_DECODERS,
                 spec.decompress_batch, "decoder")


def compress(fmt: str, batch: ChunkBatch, opts: Any = None,
             out_cap: int | None = None,
             backend: str = "auto") -> tuple[ChunkBatch, torch.Tensor]:
    """Analog of ``nvcompBatched<Fmt>CompressAsync``.

    Returns ``(compressed_batch, statuses)`` on the batch's device; the
    compressed batch's ``data`` is padded to ``out_cap`` (default: the format's
    max output chunk size) with per-chunk actual sizes in ``.sizes``.  Invalid
    inputs surface as per-chunk error statuses (size 0, zeroed row), misaligned
    batch/output strides as ``ERROR_ALIGNMENT`` for the whole call.
    """
    spec = _get(fmt)
    if spec.decompression_only:
        raise ValueError(f"{fmt} provides decompression only")
    opts = opts if opts is not None else spec.default_opts
    if out_cap is None:
        out_cap = spec.max_compressed_chunk_size(batch.max_chunk_bytes, opts)
    align = REQUIRED_ALIGNMENT.get(fmt, 1)
    if batch.max_chunk_bytes % align or out_cap % align:
        return _alignment_failure(batch.num_chunks, out_cap, batch.device)
    tlog.api_call(f"batched.{fmt}.compress", num_chunks=batch.num_chunks,
                  max_chunk_bytes=batch.max_chunk_bytes, out_cap=out_cap,
                  backend=backend)
    fn = _encode_fn(fmt, spec, backend, batch.device)
    out, sizes, statuses = fn(batch.data, batch.sizes, opts, out_cap)
    viol = _input_violations(fmt, spec, batch.sizes, opts)
    bad = viol != 0
    statuses = torch.where(bad, viol, statuses)
    sizes = torch.where(bad, 0, sizes)
    out = torch.where(bad[:, None], 0, out)
    return ChunkBatch(data=out, sizes=sizes), statuses


def decompress(fmt: str, comp: ChunkBatch, max_uncompressed_chunk_bytes: int,
               backend: str = "auto") -> tuple[ChunkBatch, torch.Tensor]:
    """Analog of ``nvcompBatched<Fmt>DecompressAsync``.

    Corrupt chunks yield status ``ERROR_CANNOT_DECOMPRESS`` and size 0 — never an
    out-of-bounds access (reference contract ``CHANGELOG.md:160-164``).
    """
    spec = _get(fmt)
    align = REQUIRED_ALIGNMENT.get(fmt, 1)
    if comp.max_chunk_bytes % align:
        return _alignment_failure(comp.num_chunks, max_uncompressed_chunk_bytes,
                                  comp.device)
    tlog.api_call(f"batched.{fmt}.decompress", num_chunks=comp.num_chunks,
                  out_cap=max_uncompressed_chunk_bytes, backend=backend)
    fn = _decode_fn(fmt, spec, backend, comp.device)
    out, sizes, statuses = fn(comp.data, comp.sizes, max_uncompressed_chunk_bytes)
    return ChunkBatch(data=out, sizes=sizes), statuses


def get_decompress_size(fmt: str, comp: ChunkBatch) -> torch.Tensor:
    """Analog of ``nvcompBatched<Fmt>GetDecompressSizeAsync``: per-chunk
    decompressed byte counts read from the compressed streams, on the batch's
    device (Snappy's varint preamble, gzip's ISIZE; LZ4's and Deflate's are
    not ported yet)."""
    spec = _get(fmt)
    if spec.get_decompress_size is None:
        raise NotImplementedError(
            f"get_decompress_size({fmt!r}): {_LOG_DEPTH_TODO.format(fmt=fmt)}")
    tlog.api_call(f"batched.{fmt}.get_decompress_size", num_chunks=comp.num_chunks)
    return spec.get_decompress_size(comp.data, comp.sizes)


def roundtrip_verify(fmt: str, batch: ChunkBatch, opts: Any = None) -> bool:
    """Compress then decompress and compare bit-exactly (the reference's
    standard verification pass, ``benchmark_template_chunked.cuh:553-584``)."""
    comp, cstat = compress(fmt, batch, opts)
    dec, dstat = decompress(fmt, comp, batch.max_chunk_bytes)
    if not bool(torch.all(cstat == Status.SUCCESS)) or \
       not bool(torch.all(dstat == Status.SUCCESS)):
        return False
    if not bool(torch.all(dec.sizes == batch.sizes)):
        return False
    return dec.to_bytes() == batch.to_bytes()


__all__ = [
    "CodecSpec", "register", "formats",
    "compress", "decompress", "get_decompress_size",
    "compress_get_max_output_chunk_size", "compress_get_temp_size",
    "compress_get_temp_size_ex", "decompress_get_temp_size",
    "decompress_get_temp_size_ex", "roundtrip_verify",
]
