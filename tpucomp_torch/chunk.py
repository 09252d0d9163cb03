"""ChunkBatch: the device-resident batched-chunk container, on torch tensors.

Port of :mod:`tpucomp.chunk`.  A batch is one dense
``uint8[num_chunks, max_chunk_bytes]`` payload padded per chunk plus an
``int32[num_chunks]`` vector of actual sizes, both on one device — the same
padded-max convention nvCOMP's LLIF uses for outputs
(``examples/low_level_quickstart_example.cpp:68-98``), used on both sides of
the API.

Constructors place the batch on the card unless the caller names another
device: ``device=None`` means ``"cuda"`` and raises when no card is present.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return ceil_div(x, m) * m


def wrap_i32(x):
    """Each value's low 32 bits read as int32, in ``x``'s type (a Python int
    or an integer tensor): the wrap of the reference's int32 arithmetic,
    computed in 64 bits."""
    return ((x + 2**31) & 0xFFFFFFFF) - 2**31


def _resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` -> the card; raise if a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to run "
                           "the plain versions on the host")
    return dev


@dataclasses.dataclass
class ChunkBatch:
    """A batch of independent, variable-size byte chunks with static padded shape.

    Attributes:
      data:  ``uint8[num_chunks, max_chunk_bytes]`` — chunk *i* occupies
             ``data[i, :sizes[i]]``; bytes past the size are zero-padding.
      sizes: ``int32[num_chunks]`` — actual byte count per chunk (may be 0; the
             reference requires zero-byte chunks to work, ``CHANGELOG.md:66``).
    """

    data: torch.Tensor
    sizes: torch.Tensor

    # -- properties --------------------------------------------------------------
    @property
    def num_chunks(self) -> int:
        return self.data.shape[0]

    @property
    def max_chunk_bytes(self) -> int:
        return self.data.shape[1]

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def total_bytes(self) -> torch.Tensor:
        return torch.sum(self.sizes.to(torch.int64))

    # -- constructors ------------------------------------------------------------
    @classmethod
    def from_numpy(cls, data: np.ndarray, sizes: np.ndarray,
                   device: str | torch.device | None = None) -> "ChunkBatch":
        """Carry a batch in from numpy arrays (e.g. another package's batch)."""
        dev = _resolve_device(device)
        return cls(data=torch.from_numpy(np.ascontiguousarray(data, np.uint8)).to(dev),
                   sizes=torch.from_numpy(np.ascontiguousarray(sizes, np.int32)).to(dev))

    @classmethod
    def from_bytes(cls, buf: bytes | np.ndarray, chunk_size: int,
                   max_chunk_bytes: int | None = None,
                   device: str | torch.device | None = None) -> "ChunkBatch":
        """Split one contiguous buffer into fixed-size chunks (last may be short).

        The slot stride is padded to a multiple of 8 — the dense-array analog of
        the reference harness padding every chunk to 8-byte alignment
        (``benchmark_template_chunked.cuh:181-183``) so each chunk's slot start
        satisfies every format's ``REQUIRED_ALIGNMENT``.
        """
        arr = np.frombuffer(buf, dtype=np.uint8) if isinstance(buf, (bytes, bytearray)) \
            else np.asarray(buf, dtype=np.uint8).reshape(-1)
        n = max(1, ceil_div(arr.size, chunk_size))
        max_b = round_up(max_chunk_bytes or chunk_size, 8)
        data = np.zeros((n, max_b), dtype=np.uint8)
        sizes = np.zeros((n,), dtype=np.int32)
        for i in range(n):
            piece = arr[i * chunk_size:(i + 1) * chunk_size]
            data[i, :piece.size] = piece
            sizes[i] = piece.size
        return cls.from_numpy(data, sizes, device)

    @classmethod
    def from_chunks(cls, chunks: Sequence[bytes | np.ndarray],
                    max_chunk_bytes: int | None = None,
                    device: str | torch.device | None = None) -> "ChunkBatch":
        """Build a batch from an explicit list of variable-size chunks."""
        arrs = [np.frombuffer(c, dtype=np.uint8) if isinstance(c, (bytes, bytearray))
                else np.asarray(c, dtype=np.uint8).reshape(-1) for c in chunks]
        max_b = max_chunk_bytes or max((a.size for a in arrs), default=1)
        max_b = round_up(max(max_b, 1), 8)  # 8 B slot alignment, as from_bytes
        data = np.zeros((len(arrs), max_b), dtype=np.uint8)
        sizes = np.zeros((len(arrs),), dtype=np.int32)
        for i, a in enumerate(arrs):
            if a.size > max_b:
                raise ValueError(f"chunk {i} ({a.size} B) exceeds max_chunk_bytes={max_b}")
            data[i, :a.size] = a
            sizes[i] = a.size
        return cls.from_numpy(data, sizes, device)

    @classmethod
    def empty(cls, num_chunks: int, max_chunk_bytes: int,
              device: str | torch.device | None = None) -> "ChunkBatch":
        dev = _resolve_device(device)
        return cls(
            data=torch.zeros((num_chunks, max_chunk_bytes), dtype=torch.uint8, device=dev),
            sizes=torch.zeros((num_chunks,), dtype=torch.int32, device=dev),
        )

    # -- host-side accessors -----------------------------------------------------
    def to_numpy(self) -> tuple[np.ndarray, np.ndarray]:
        """Device→host: ``(data uint8[B, cap], sizes int32[B])`` numpy arrays."""
        return self.data.cpu().numpy(), self.sizes.cpu().numpy()

    def chunk_list(self) -> list[bytes]:
        """Device→host: return the batch as a list of exact-size byte strings."""
        data, sizes = self.to_numpy()
        return [data[i, :sizes[i]].tobytes() for i in range(self.num_chunks)]

    def to_bytes(self) -> bytes:
        """Concatenate all chunks (in order) into one contiguous byte string."""
        return b"".join(self.chunk_list())

    # -- device-side transforms ---------------------------------------------------
    def with_padding_zeroed(self) -> "ChunkBatch":
        """Zero out bytes past each chunk's size (defensive normalization)."""
        col = torch.arange(self.max_chunk_bytes, device=self.device)
        mask = col[None, :] < self.sizes[:, None]
        return ChunkBatch(data=torch.where(mask, self.data, 0).to(torch.uint8),
                          sizes=self.sizes)

    def compact(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Gather the ragged chunks into one contiguous ``uint8[total]`` stream.

        Returns ``(flat_padded, offsets)`` where ``offsets[i]`` is the start of chunk
        *i* in the compacted stream and ``flat_padded`` has static shape
        ``num_chunks * max_chunk_bytes`` with valid bytes in ``[: offsets[-1]+sizes[-1]]``.
        """
        sizes = self.sizes.to(torch.int64)
        ends = torch.cumsum(sizes, 0)
        offsets = ends - sizes
        total_cap = self.num_chunks * self.max_chunk_bytes
        # for each output position, find the owning chunk via searchsorted
        pos = torch.arange(total_cap, dtype=torch.int64, device=self.device)
        chunk_id = torch.searchsorted(ends, pos, right=True)
        chunk_id = torch.clamp(chunk_id, 0, self.num_chunks - 1)
        local = pos - offsets[chunk_id]
        valid = local < sizes[chunk_id]
        vals = self.data[chunk_id, torch.clamp(local, 0, self.max_chunk_bytes - 1)]
        flat = torch.where(valid, vals, 0).to(torch.uint8)
        return flat, offsets.to(torch.int32)


def plan_chunks(total_bytes: int, chunk_size: int) -> list[tuple[int, int]]:
    """File→manifest planner: list of (offset, size) covering ``total_bytes``."""
    if total_bytes == 0:
        return [(0, 0)]
    return [(o, min(chunk_size, total_bytes - o))
            for o in range(0, total_bytes, chunk_size)]


def plan_chunks_page_prefixed(buf: bytes) -> list[tuple[int, int]]:
    """Planner for page-size-prefixed inputs (reference ``-s`` mode,
    ``benchmark_template_chunked.cuh:294-310``): the file is a sequence of
    ``uint64 page_size`` prefixes followed by that many bytes; each page is a chunk."""
    out = []
    off = 0
    n = len(buf)
    while off + 8 <= n:
        size = int.from_bytes(buf[off:off + 8], "little")
        off += 8
        if off + size > n:
            break
        out.append((off, size))
        off += size
    return out
