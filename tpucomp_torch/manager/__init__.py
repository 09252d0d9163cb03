"""tpucomp_torch.manager — the high-level interface (HLIF analog), on torch.

Port of :mod:`tpucomp.manager`: nvCOMP's ``nvcompManagerBase`` + per-format
managers + the ``create_manager`` factory (``doc/highlevel_cpp_quickstart.md``;
``examples/high_level_quickstart_example.cpp``).  A manager chunks one
contiguous buffer, dispatches to :mod:`tpucomp_torch.batched` (the Hopper
kernels on the card) and wraps the result in a **self-describing frame**, so
a buffer can be decompressed with no out-of-band metadata.  The frames are
byte-identical to the reference manager's: each package reads the other's.

Frame layout (little-endian, 4-byte aligned sections):

    0   u8[8]   magic  b"TPUCOMP0"
    8   u16     version (=1)        u16 format_id
    12  u32     chunk_size
    16  u64     uncompressed_size
    24  u32     num_chunks          u32 checksum_mode
    32  u64     total_compressed_size (whole frame, bytes)
    40  u8[16]  format options blob (reconstructs opts in create_manager)
    56  u32[num_chunks]             compressed chunk sizes
    if checksums stored:
        u32[num_chunks] uncompressed-chunk CRC32s
        u32[num_chunks] compressed-chunk CRC32s
    then per-chunk payloads, each padded to 4-byte alignment.

Checksum policy is the reference's 5-mode enum
(``examples/high_level_quickstart_example.cpp:252-316``); failures surface as
``Status.ERROR_BAD_CHECKSUM`` through ``DecompressionConfig.get_status()``.

A manager runs on one device: ``device=None`` means the card (and raises
without one); pass ``device="cpu"`` for the plain versions on the host.
PyTorch runs eagerly, so there is no compiled-program cache.  Host syncs are
the reference's two: reading the 56-byte header, and reading the frame's
total size to trim it.  Manager("deflate") and the other formats not ported
yet raise ``ValueError`` from the format registry.
"""
from __future__ import annotations

import dataclasses
import enum
import struct
from typing import Any

import numpy as np
import torch

from tpucomp_torch import batched as _batched
from tpucomp_torch import logging as tlog
from tpucomp_torch.chunk import _resolve_device, ceil_div, round_up, wrap_i32
from tpucomp_torch.constants import DEFAULT_CHUNK_SIZE, ElementType, Status
from tpucomp_torch.formats import crc32 as c32

MAGIC = b"TPUCOMP0"
VERSION = 1
HEADER_BYTES = 56

FORMAT_IDS = {"lz4": 1, "snappy": 2, "cascaded": 3, "ans": 4, "deflate": 5,
              "gdeflate": 6, "gzip": 7, "zstd": 8, "bitcomp": 9}
FORMAT_NAMES = {v: k for k, v in FORMAT_IDS.items()}


class ChecksumPolicy(enum.IntEnum):
    """Mirror of nvCOMP's 5 checksum modes."""

    NO_COMPUTE_NO_VERIFY = 0
    COMPUTE_AND_NO_VERIFY = 1
    NO_COMPUTE_AND_VERIFY_IF_PRESENT = 2
    COMPUTE_AND_VERIFY_IF_PRESENT = 3
    COMPUTE_AND_VERIFY = 4

    @property
    def computes(self) -> bool:
        return self in (ChecksumPolicy.COMPUTE_AND_NO_VERIFY,
                        ChecksumPolicy.COMPUTE_AND_VERIFY_IF_PRESENT,
                        ChecksumPolicy.COMPUTE_AND_VERIFY)

    @property
    def verifies(self) -> bool:
        return self in (ChecksumPolicy.NO_COMPUTE_AND_VERIFY_IF_PRESENT,
                        ChecksumPolicy.COMPUTE_AND_VERIFY_IF_PRESENT,
                        ChecksumPolicy.COMPUTE_AND_VERIFY)

    @property
    def requires_checksums(self) -> bool:
        return self == ChecksumPolicy.COMPUTE_AND_VERIFY


# -- per-format opts <-> 16-byte blob (the ported formats) ------------------------------

def _opts_to_blob(fmt: str, opts: Any) -> bytes:
    blob = bytearray(16)
    if fmt == "lz4":
        blob[0] = int(opts.data_type)
    return bytes(blob)   # snappy: no options, 16 zero bytes


def _opts_from_blob(fmt: str, blob: bytes) -> Any:
    if fmt == "lz4":
        from tpucomp_torch.formats.lz4 import LZ4Opts
        return LZ4Opts(data_type=ElementType(blob[0]))
    return _batched._get(fmt).default_opts


# -- configs --------------------------------------------------------------------------

@dataclasses.dataclass
class CompressionConfig:
    """Host-resident (so decompression can be configured without a sync,
    ``doc/highlevel_cpp_quickstart.md:123-133``)."""

    uncompressed_size: int
    num_chunks: int
    chunk_size: int
    max_compressed_buffer_size: int


@dataclasses.dataclass
class DecompressionConfig:
    decomp_data_size: int
    num_chunks: int
    chunk_size: int
    checksum_mode: int
    _status: Any = Status.SUCCESS

    def get_status(self) -> Status:
        """Valid after the decompress completes; reading a device status waits
        for it (the reference reads a pinned word after a stream sync,
        ``examples/high_level_quickstart_example.cpp:313-316``)."""
        return Status(int(self._status))


class Manager:
    """Per-format manager (``LZ4Manager`` etc. analog).

    ``Manager("lz4", chunk_size, opts, checksum_policy)`` ~
    ``LZ4Manager{chunk_size, opts, stream, checksum_policy}``
    (``benchmarks/benchmark_hlif.cpp:188-212``).
    """

    def __init__(self, fmt: str, chunk_size: int = DEFAULT_CHUNK_SIZE,
                 opts: Any = None,
                 checksum_policy: ChecksumPolicy = ChecksumPolicy.NO_COMPUTE_NO_VERIFY,
                 device: str | torch.device | None = None):
        self.format = fmt
        if fmt not in FORMAT_IDS:
            raise ValueError(f"unknown format {fmt!r}")
        self.spec = _batched._get(fmt)
        self.chunk_size = int(chunk_size)
        self.opts = opts if opts is not None else self.spec.default_opts
        self.checksum_policy = ChecksumPolicy(checksum_policy)
        self.device = _resolve_device(device)
        self._chunk_cap = self.spec.max_compressed_chunk_size(self.chunk_size,
                                                              self.opts)

    # -- compression ------------------------------------------------------------------

    def configure_compression(self, uncompressed_size: int) -> CompressionConfig:
        n = max(1, ceil_div(uncompressed_size, self.chunk_size))
        tables = 4 * n + (8 * n if self.checksum_policy.computes else 0)
        max_size = (HEADER_BYTES + round_up(tables, 4)
                    + n * round_up(self._chunk_cap, 4))
        return CompressionConfig(uncompressed_size=uncompressed_size,
                                 num_chunks=n, chunk_size=self.chunk_size,
                                 max_compressed_buffer_size=max_size)

    def compress(self, data, config: CompressionConfig | None = None) -> torch.Tensor:
        """Compress one contiguous buffer -> ``uint8`` frame on the manager's
        device, trimmed to its exact size (which waits for the device, as the
        reference's ``get_compressed_output_size`` does).

        Accepts bytes, a numpy array or a ``uint8`` tensor.
        """
        buf = self._as_u8(data)
        cfg = config or self.configure_compression(buf.numel())
        tlog.api_call(f"manager.{self.format}.compress", size=buf.numel(),
                      num_chunks=cfg.num_chunks)
        hdr = bytearray(HEADER_BYTES)
        hdr[0:8] = MAGIC
        struct.pack_into("<HH", hdr, 8, VERSION, FORMAT_IDS[self.format])
        struct.pack_into("<I", hdr, 12, self.chunk_size)
        struct.pack_into("<Q", hdr, 16, buf.numel())
        struct.pack_into("<II", hdr, 24, cfg.num_chunks,
                         1 if self.checksum_policy.computes else 0)
        hdr[40:56] = _opts_to_blob(self.format, self.opts)
        hdr_u8 = torch.frombuffer(hdr, dtype=torch.uint8).to(self.device)
        data, sizes = _chunk(buf, cfg.num_chunks, self.chunk_size)
        frame, total = _compress_to_frame(
            self.spec, self.format, self.opts, data, sizes, hdr_u8,
            n=cfg.num_chunks, chunk_cap=self._chunk_cap,
            policy=self.checksum_policy, out_cap=cfg.max_compressed_buffer_size)
        return frame[:int(total)]

    # -- decompression ----------------------------------------------------------------

    def configure_decompression(self, comp) -> DecompressionConfig:
        hdr = _parse_header(comp)
        return DecompressionConfig(decomp_data_size=hdr["uncompressed_size"],
                                   num_chunks=hdr["num_chunks"],
                                   chunk_size=hdr["chunk_size"],
                                   checksum_mode=hdr["checksum_mode"])

    def decompress(self, comp, config: DecompressionConfig | None = None) -> torch.Tensor:
        """Decompress a frame -> the ``uint8`` buffer on the manager's device.
        The status lands in ``config`` (read it with ``get_status()``)."""
        cfg = config or self.configure_decompression(comp)
        comp = self._as_u8(comp)
        tlog.api_call(f"manager.{self.format}.decompress",
                      size=cfg.decomp_data_size, num_chunks=cfg.num_chunks)
        out, status = _decompress_frame(
            self.format, self.spec, comp, n=cfg.num_chunks,
            chunk_size=cfg.chunk_size, has_crc=bool(cfg.checksum_mode),
            policy=self.checksum_policy, uncomp_size=cfg.decomp_data_size,
            chunk_cap=self._chunk_cap)
        cfg._status = status
        return out

    def get_compressed_output_size(self, comp) -> int:
        return _parse_header(comp)["total_compressed_size"]

    def _as_u8(self, buf) -> torch.Tensor:
        """bytes / numpy / tensor -> a flat ``uint8`` tensor on the device."""
        if isinstance(buf, torch.Tensor):
            return buf.reshape(-1).to(device=self.device, dtype=torch.uint8)
        arr = np.frombuffer(buf, np.uint8) if isinstance(buf, (bytes, bytearray)) \
            else np.asarray(buf, np.uint8).reshape(-1)
        return torch.from_numpy(arr.copy()).to(self.device)


def create_manager(comp, checksum_policy: ChecksumPolicy | None = None,
                   device: str | torch.device | None = None) -> Manager:
    """Rebuild the right manager by inspecting a compressed frame
    (``create_manager``, ``doc/highlevel_cpp_quickstart.md:33-47``; reads the
    frame's header, ``:113-115``).  ``device`` as for :class:`Manager`."""
    hdr = _parse_header(comp)
    fmt = FORMAT_NAMES.get(hdr["format_id"])
    if fmt is None:
        raise ValueError(f"unknown format id {hdr['format_id']}")
    opts = _opts_from_blob(fmt, hdr["opts_blob"])
    policy = checksum_policy
    if policy is None:
        policy = (ChecksumPolicy.NO_COMPUTE_AND_VERIFY_IF_PRESENT
                  if hdr["checksum_mode"] else ChecksumPolicy.NO_COMPUTE_NO_VERIFY)
    return Manager(fmt, chunk_size=hdr["chunk_size"], opts=opts,
                   checksum_policy=policy, device=device)


# =====================================================================================
# internals
# =====================================================================================

def _parse_header(comp) -> dict:
    if isinstance(comp, torch.Tensor):
        head = comp.reshape(-1)[:HEADER_BYTES].cpu().numpy().astype(np.uint8).tobytes()
    elif isinstance(comp, (bytes, bytearray)):
        head = bytes(comp[:HEADER_BYTES])
    else:
        head = np.asarray(comp).reshape(-1)[:HEADER_BYTES].astype(np.uint8).tobytes()
    if len(head) < HEADER_BYTES or head[:8] != MAGIC:
        raise ValueError("not a tpucomp frame (bad magic)")
    version, format_id = struct.unpack_from("<HH", head, 8)
    if version != VERSION:
        raise ValueError(f"unsupported frame version {version}")
    chunk_size, = struct.unpack_from("<I", head, 12)
    uncomp_size, = struct.unpack_from("<Q", head, 16)
    num_chunks, checksum_mode = struct.unpack_from("<II", head, 24)
    total, = struct.unpack_from("<Q", head, 32)
    return {"version": version, "format_id": format_id, "chunk_size": chunk_size,
            "uncompressed_size": uncomp_size, "num_chunks": num_chunks,
            "checksum_mode": checksum_mode, "total_compressed_size": total,
            "opts_blob": head[40:56]}


def _chunk(buf: torch.Tensor, n: int, chunk_size: int):
    """Split a flat buffer into ``n`` chunks, on its device: the batch that
    ``ChunkBatch.from_bytes`` builds (slots padded to 8 bytes, zeros past each
    size), without a host loop."""
    flat = torch.zeros(n * chunk_size, dtype=torch.uint8, device=buf.device)
    flat[:buf.numel()] = buf
    data = torch.nn.functional.pad(flat.view(n, chunk_size),
                                   (0, round_up(chunk_size, 8) - chunk_size))
    starts = torch.arange(n, device=buf.device, dtype=torch.int64) * chunk_size
    sizes = (buf.numel() - starts).clamp(0, chunk_size).to(torch.int32)
    return data, sizes


def _u32_bytes(v: torch.Tensor) -> torch.Tensor:
    """Little-endian bytes of uint32 values held in an integer tensor."""
    v = v.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([(v >> s) & 0xFF for s in (0, 8, 16, 24)], 1).reshape(-1).to(torch.uint8)


def _compress_to_frame(spec, fmt: str, opts, data: torch.Tensor,
                       sizes: torch.Tensor, hdr_u8: torch.Tensor, n: int,
                       chunk_cap: int, policy: ChecksumPolicy, out_cap: int):
    """Device side of Manager.compress: encode + frame assembly.  Returns the
    untrimmed ``uint8[out_cap]`` frame and its total size (a device scalar).
    The header arrives host-composed except the u64 total at offset 32."""
    dev = data.device
    encode = _batched._encode_fn(fmt, spec, "auto", dev)   # the kernels on the card
    comp, csz, _ = encode(data, sizes, opts, chunk_cap)

    store_crc = policy.computes
    table_bytes = 4 * n + (8 * n if store_crc else 0)
    payload_off0 = HEADER_BYTES + round_up(table_bytes, 4)
    asz = (csz.to(torch.int64) + 3) // 4 * 4
    offs = payload_off0 + torch.cumsum(asz, 0) - asz
    total = payload_off0 + asz.sum()

    out = torch.zeros(out_cap + 4, dtype=torch.uint8, device=dev)  # + a spill word
    out[:HEADER_BYTES] = hdr_u8
    out[32:40] = ((total >> (8 * torch.arange(8, device=dev))) & 0xFF).to(torch.uint8)
    out[HEADER_BYTES:HEADER_BYTES + 4 * n] = _u32_bytes(csz)
    if store_crc:
        out[HEADER_BYTES + 4 * n:HEADER_BYTES + 8 * n] = _u32_bytes(
            c32.crc32_batch(data, sizes))
        out[HEADER_BYTES + 8 * n:HEADER_BYTES + 12 * n] = _u32_bytes(
            c32.crc32_batch(comp, csz))

    # payload compaction: one scatter of 4-byte words.  Every offset and padded
    # size is a multiple of 4, and the encoders zero each row past its size,
    # so word j < asz[i] / 4 of row i lands at word offs[i] / 4 + j; the other
    # words go to the spill word past out_cap.  Same bytes as the reference's
    # one dynamic_update_slice per chunk (manager/__init__.py:349-367).
    comp_w = comp.contiguous().view(torch.int32)
    col = torch.arange(comp_w.shape[1], device=dev)
    dst = torch.where(col[None, :] < (asz // 4)[:, None],
                      (offs // 4)[:, None] + col[None, :], out_cap // 4)
    out.view(torch.int32).scatter_(0, dst.reshape(-1), comp_w.reshape(-1))
    return out[:out_cap], total


def _bucket_chunk_cap(raw: int) -> int:
    """Round a data-dependent max-compressed-chunk size up to a power of two
    (min 1 KiB), for callers that stage their own data-dependent buffers; the
    frame path slices at the format's static max chunk cap."""
    cap = 1024
    while cap < raw:
        cap <<= 1
    return cap


def _decompress_frame(fmt: str, spec, comp: torch.Tensor, n: int, chunk_size: int,
                      has_crc: bool, policy: ChecksumPolicy, uncomp_size: int,
                      chunk_cap: int):
    """Device side of Manager.decompress -> ``(buffer, status)``, the status a
    device scalar.  Reads a corrupt or truncated frame as the reference does:
    table words through clipped indices, sizes as int32, and each chunk's
    slice start clamped into the frame (XLA's ``dynamic_slice`` rule)."""
    dev = comp.device
    decode = _batched._decode_fn(fmt, spec, "auto", dev)   # the kernels on the card
    cap = comp.shape[0]
    ks = torch.arange(n, device=dev, dtype=torch.int64)

    def u32_arr(base: int) -> torch.Tensor:
        o = (base + 4 * ks)[:, None] + torch.arange(4, device=dev)
        b = comp[o.clamp(0, cap - 1)].to(torch.int64)
        return b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)

    csz = wrap_i32(u32_arr(HEADER_BYTES))
    table_bytes = 4 * n + (8 * n if has_crc else 0)
    payload_off0 = HEADER_BYTES + round_up(table_bytes, 4)
    asz = wrap_i32(csz + 3) // 4 * 4
    offs = wrap_i32(payload_off0 + torch.cumsum(asz, 0) - asz)

    # each chunk is the frame's window at offs[i], of the static max chunk cap
    # (rounded to 4), its start clamped to [0, cap]; rows of one strided view
    chunk_cap = round_up(max(chunk_cap, 4), 4)
    comp_pad = torch.cat([comp, torch.zeros(chunk_cap, dtype=torch.uint8, device=dev)])
    comp_chunks = comp_pad.unfold(0, chunk_cap, 1)[offs.clamp(0, cap)]
    col = torch.arange(chunk_cap, device=dev)
    comp_chunks = torch.where(col[None, :] < csz[:, None], comp_chunks, 0)
    csz = csz.to(torch.int32)

    dec, dsz, dst = decode(comp_chunks, csz, chunk_size)
    status = dst.max()
    if policy.requires_checksums and not has_crc:
        status = torch.clamp(status, min=int(Status.ERROR_CANNOT_VERIFY_CHECKSUMS))
    if policy.verifies and has_crc:
        crc_u_stored = u32_arr(HEADER_BYTES + 4 * n)
        crc_c_stored = u32_arr(HEADER_BYTES + 8 * n)
        bad = ((c32.crc32_batch(comp_chunks, csz) != crc_c_stored).any()
               | (c32.crc32_batch(dec, dsz) != crc_u_stored).any())
        status = torch.where(
            bad, torch.clamp(status, min=int(Status.ERROR_BAD_CHECKSUM)), status)
    return dec.reshape(-1)[:uncomp_size], status
