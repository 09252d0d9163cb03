"""Batched LZ4 block encode with a hash-table match finder: the Hopper
kernel and its plain version.

Port of :mod:`tpucomp.ops.pallas.lz4_encode` (``compress_batch`` /
``_kernel``, kernel row 5), the reference's v1 LZ4 encoder, which no dispatch
table reaches (the dispatched one is :mod:`.lz4_encode2`).  The scan is
LZ4-fast's: hash the 4 bytes at ``ip`` into a 4096-entry table of ``ip + 1``,
take the candidate when it is set, at most 65535 back and equal in its first
4 bytes, extend it, jump past it and seed the table at ``ip2 - 2``; on a miss
step ``1 + (misses >> 6)``.  No match starts in the last 12 bytes
(``MF_LIMIT``) and matches end 5 bytes before the end (``LAST_LITERALS``);
the frame ends with a literal-only sequence, even when empty.  Frames are
byte-identical to the reference's.

The kernel is ``csrc/hash_encode.cu`` (``tpucomp_lz4_encode_hash``, one warp
a chunk, its table in shared memory; its header says what it replaces, what
bounds it and how it is built).  The plain version is the same scan in
Python; the CPU tests hold it against the reference and ``chip_smoke.py``
holds the kernel against it.  :mod:`.snappy_encode` runs the same scan with
Snappy's emission.

Contract: ``data uint8[B, cap]`` plus ``sizes int32[B]`` (each in ``[0,
cap]``; values outside are clamped) -> ``(out uint8[B, out_cap], out_sizes
int32[B], statuses int32[B])``.  A frame longer than ``out_cap`` gives
``ERROR_OUTPUT_BUFFER_TOO_SMALL``, size 0 and a zero row.  As in the
reference, ``B * epoch_stride`` must stay below 2**31 (``epoch_stride = 1 <<
max(18, (cap + 2).bit_length())``), else ``ValueError``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpucomp_torch.constants import Status
from tpucomp_torch.ops.cuda import _build
from tpucomp_torch.ops.cuda.lz4_encode2 import _clamped_sizes, _emit_seq, _match_len

HASH_LOG = 12
HASH_SIZE = 1 << HASH_LOG
MIN_MATCH = 4
MF_LIMIT = 12       # no match starts within the last 12 bytes
LAST_LITERALS = 5   # matches end at least 5 bytes before the block end
SKIP_TRIGGER = 6    # a miss steps 1 + (misses >> SKIP_TRIGGER)
_GOLDEN = 2654435761  # the reference's int32 -1640531535, as uint32


def check_batch(B: int, cap: int) -> None:
    """The reference's limit: its epoch-tagged table needs ``B *
    epoch_stride < 2**31`` (``lz4_encode.py:251-256``)."""
    epoch_stride = 1 << max(18, (cap + 2).bit_length())
    if B * epoch_stride >= 2**31:
        raise ValueError(f"batch of {B} chunks of {cap} bytes is too large for the "
                         f"reference's epoch stride ({epoch_stride}): B * stride must "
                         f"stay below 2**31")


def scan(row: bytes, size: int, last_literals: int) -> tuple[list, int]:
    """The hash-table scan over ``row[:size]`` -> ``([(anchor, ll, ml, off),
    ...], final anchor)``; matches end ``last_literals`` bytes before
    ``size``."""
    mflimit = size - MF_LIMIT
    seqs = []
    if mflimit <= 0:
        return seqs, 0
    a = np.frombuffer(row, np.uint8, size).astype(np.uint32)
    words = a[:-3] | (a[1:-2] << 8) | (a[2:-1] << 16) | (a[3:] << 24)
    hashes = (((words.astype(np.uint64) * _GOLDEN) & 0xFFFFFFFF) >> (32 - HASH_LOG)).tolist()
    words = words.tolist()
    match_end = size - last_literals
    table = [0] * HASH_SIZE
    ip = anchor = misses = 0
    while ip < mflimit:
        h = hashes[ip]
        cand = table[h] - 1
        table[h] = ip + 1
        if cand >= 0 and ip - cand <= 65535 and words[cand] == words[ip]:
            ml = MIN_MATCH + _match_len(row, ip + MIN_MATCH, cand + MIN_MATCH,
                                        match_end - (ip + MIN_MATCH))
            seqs.append((anchor, ip - anchor, ml, ip - cand))
            ip += ml
            anchor = ip
            if ip < mflimit:   # the seed; past mflimit the scan is over
                table[hashes[ip - 2]] = ip - 1
            misses = 0
        else:
            ip += 1 + (misses >> SKIP_TRIGGER)
            misses += 1
    return seqs, anchor


def _encode_chunk(row: bytes, size: int) -> bytearray:
    seqs, anchor = scan(row, size, LAST_LITERALS)
    out = bytearray()
    for a, ll, ml, off in seqs:
        _emit_seq(out, row, a, ll, ml, off)
    _emit_seq(out, row, anchor, size - anchor, 0, 0)   # mandatory, even when empty
    return out


def plain_batch(encode_chunk, data: torch.Tensor, sizes: torch.Tensor, out_cap: int):
    """Each row through ``encode_chunk(row, size) -> frame`` on the host, into
    the contract's outputs on ``data``'s device."""
    B, cap = data.shape
    check_batch(B, cap)
    szs = _clamped_sizes(data, sizes).cpu().tolist()
    rows = data.cpu().numpy()
    out = np.zeros((B, out_cap), np.uint8)
    osz = np.zeros(B, np.int32)
    stat = np.zeros(B, np.int32)
    for i in range(B):
        frame = encode_chunk(rows[i].tobytes(), szs[i])
        if len(frame) > out_cap:
            stat[i] = Status.ERROR_OUTPUT_BUFFER_TOO_SMALL
        else:
            out[i, :len(frame)] = np.frombuffer(frame, np.uint8)
            osz[i] = len(frame)
    dev = data.device
    return (torch.from_numpy(out).to(dev), torch.from_numpy(osz).to(dev),
            torch.from_numpy(stat).to(dev))


def launch(entry: str, data: torch.Tensor, sizes: torch.Tensor, out_cap: int):
    """Check the inputs and launch ``entry`` of ``csrc/hash_encode.cu`` on
    ``data``'s card, on the current stream.  Raises for tensors that are not
    on a CUDA device and when the launch fails."""
    if data.device.type != "cuda":
        raise ValueError(f"the hash-table encode kernel needs CUDA tensors, got {data.device}")
    if data.dtype != torch.uint8 or data.dim() != 2:
        raise ValueError(f"data must be uint8[B, cap], got {data.dtype}{list(data.shape)}")
    B, cap = data.shape
    check_batch(B, cap)
    data = data.contiguous()
    sizes = _clamped_sizes(data, sizes).contiguous()
    out = torch.empty((B, out_cap), dtype=torch.uint8, device=data.device)
    osz = torch.empty((B,), dtype=torch.int32, device=data.device)
    stat = torch.empty((B,), dtype=torch.int32, device=data.device)
    fn = getattr(_build.load("hash_encode"), entry)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, i, p, i, p, p, p]
    fn.restype = i
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(data.data_ptr(), sizes.data_ptr(), B, cap, out.data_ptr(), out_cap,
                osz.data_ptr(), stat.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: cudaError {rc}")
    return out, osz, stat


def compress_batch_plain(data: torch.Tensor, sizes: torch.Tensor, out_cap: int):
    """Plain version: the scan in Python on the host.  Returns tensors on
    ``data``'s device."""
    return plain_batch(_encode_chunk, data, sizes, out_cap)


def compress_batch(data: torch.Tensor, sizes: torch.Tensor, out_cap: int):
    """Launch the kernel on ``data``'s card, on the current stream.  Raises
    for tensors that are not on a CUDA device."""
    result = launch("tpucomp_lz4_encode_hash", data, sizes, out_cap)
    compress_batch.launches += 1
    return result


compress_batch.launches = 0
