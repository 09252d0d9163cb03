"""tpucomp_torch — batched lossless compression in PyTorch, with CUDA kernels
written by hand for NVIDIA Hopper.

The port of :mod:`tpucomp` (the JAX/Pallas package beside it, which stays the
reference).  Same module layout, so each module here has one reference file;
plain functions on tensors and dataclasses of tensors.  Where the reference
runs a Pallas TPU kernel, this package runs a CUDA C++ kernel for ``sm_90a``
(:mod:`tpucomp_torch.ops.cuda`), built at first use.  Importing the package
needs neither a GPU nor ``nvcc``; entry points place their data on the card
unless the caller names another device.

Ported so far: batched LZ4 and Snappy compress and decompress
(:mod:`tpucomp_torch.batched`, with Snappy's ``get_decompress_size``), the
batched CRC32 (:mod:`tpucomp_torch.formats.crc32`), and the Manager frame
path with its five checksum modes (:mod:`tpucomp_torch.manager`).
"""
from tpucomp_torch.constants import (
    DEFAULT_CHUNK_SIZE,
    ElementType,
    MAX_ALLOWED_CHUNK_SIZE,
    REQUIRED_ALIGNMENT,
    Status,
)
from tpucomp_torch.chunk import ChunkBatch, plan_chunks, plan_chunks_page_prefixed

__version__ = "0.5.0"

__all__ = [
    "ChunkBatch",
    "DEFAULT_CHUNK_SIZE",
    "ElementType",
    "MAX_ALLOWED_CHUNK_SIZE",
    "REQUIRED_ALIGNMENT",
    "Status",
    "plan_chunks",
    "plan_chunks_page_prefixed",
    "__version__",
]
