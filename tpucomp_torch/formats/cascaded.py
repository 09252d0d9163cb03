"""Cascaded: N x RLE + N x Delta + bitpack, for numeric columns (the general
program: container constants, options, bound, encoder, decoder, size query).

Port of :mod:`tpucomp.formats.cascaded` (``tpucomp/formats/cascaded.py``), the
reference's registry entry and its ``backend="xla"``.  It keeps the
reference's 64-bit semantics in ``int64`` tensors (sums and differences wrap
mod 2^64 where the reference's do) and is fully dynamic on decode: type,
``num_rles`` and ``num_deltas`` come from each chunk's header.  The device
fast path, with the RLE expansion as a Hopper kernel, is
:mod:`tpucomp_torch.ops.cascaded_fast`.

Per-chunk container (little-endian; the reference's own format):

    header (24 B):  u8 magic=0xCA, u8 version=1, u8 num_rles, u8 num_deltas,
                    u8 type_id, u8 use_bp, u8[2] reserved,
                    u32 n_elements, u32 n1 (after RLE1), u32 n2 (after RLE2)
    streams (4-B aligned, in order): runs1 (n1) if num_rles>=1,
                    runs2 (n2) if num_rles>=2, values (n2)
    each stream:    i64 min, u8 bits (<= 64), u8[7] pad,
                    i64 first0, i64 first1 (delta seeds; zero for run streams),
                    u32 words[]

Everything runs over the batch in torch ops, in slices of rows that keep each
``[rows, width]`` temporary near 128 MiB.  A corrupt chunk gives
``ERROR_CANNOT_DECOMPRESS`` with size 0 and a zero row.
"""
from __future__ import annotations

import dataclasses

import torch

from tpucomp_torch.chunk import wrap_i32
from tpucomp_torch.constants import ElementType, Status
from tpucomp_torch.ops import bitpack

MAGIC = 0xCA
VERSION = 1
HEADER_BYTES = 24
STREAM_HEADER_BYTES = 32

_BIG = 0x7FFF_FFFF_FFFF_FFFF
_SLICE_ELEMS = 1 << 24      # elements of the widest temporary in one row slice


@dataclasses.dataclass(frozen=True)
class CascadedOpts:
    """Analog of ``nvcompBatchedCascadedOpts_t`` (defaults per reference)."""

    type: ElementType = ElementType.UINT
    num_rles: int = 2
    num_deltas: int = 1
    use_bp: bool = True

    def __post_init__(self):
        if not (0 <= self.num_rles <= 2 and 0 <= self.num_deltas <= 2):
            raise ValueError("num_rles and num_deltas must be in [0, 2]")


DEFAULT_OPTS = CascadedOpts()


def type_size(t: ElementType) -> int:
    """Element bytes of a type (``BITS`` counts as one byte)."""
    return 1 if t == ElementType.BITS else t.nbytes


def by_rows(fn, width: int, *tensors):
    """``fn(*tensors)`` over slices of the batch rows (each row's widest
    temporary has ``width`` elements), the outputs concatenated in order."""
    B = tensors[0].shape[0]
    step = max(1, _SLICE_ELEMS // max(width, 1))
    if B <= step:
        return fn(*tensors)
    outs = [fn(*(t[i:i + step] for t in tensors)) for i in range(0, B, step)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def _gather_clipped(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, clip(idx[b, j], 0, width - 1)]`` as int64."""
    return x.gather(1, idx.clamp(0, x.shape[1] - 1)).to(torch.int64)


# =====================================================================================
# element <-> byte conversion (dynamic element width)
# =====================================================================================

def bytes_to_elements(data: torch.Tensor, ts: torch.Tensor, signed: torch.Tensor,
                      cap_el: int) -> torch.Tensor:
    """Little-endian ``ts``-byte elements (``ts``, ``signed`` per row) from
    ``uint8[B, cap_bytes]`` -> ``int64[B, cap_el]``, sign- or zero-extended."""
    ts = ts.to(torch.int64)[:, None]
    i = torch.arange(cap_el, device=data.device, dtype=torch.int64)[None, :]
    acc = torch.zeros((data.shape[0], cap_el), dtype=torch.int64, device=data.device)
    for k in range(8):
        byte = _gather_clipped(data, i * ts + k)
        acc = torch.where(k < ts, acc | (byte << (8 * k)), acc)
    top = torch.ones_like(ts) << (8 * ts - 1)
    ext = acc - (top << 1)
    neg = (acc & top) != 0
    return torch.where(signed[:, None] & neg & (ts < 8), ext, acc)


def elements_to_bytes(v: torch.Tensor, ts: torch.Tensor, cap_bytes: int) -> torch.Tensor:
    """Inverse of :func:`bytes_to_elements` (truncating to ``ts`` bytes, LE)."""
    ts = ts.to(torch.int64)[:, None]
    j = torch.arange(cap_bytes, device=v.device, dtype=torch.int64)[None, :]
    el = (j // ts).clamp(0, v.shape[1] - 1)
    return ((v.gather(1, el) >> (8 * (j % ts))) & 0xFF).to(torch.uint8)


# =====================================================================================
# RLE / delta passes (per row, traced counts)
# =====================================================================================

def run_starts(boundary: torch.Tensor) -> torch.Tensor:
    """The positions of each row's True entries, ascending, then 2^30: the
    reference's ``sort(where(boundary, idx, 2^30))`` as one compaction."""
    B, cap = boundary.shape
    idx = torch.arange(cap, device=boundary.device).expand(B, cap)
    pos = torch.cumsum(boundary, dim=1) - 1
    starts = torch.full((B, cap + 1), 1 << 30, dtype=torch.int64, device=boundary.device)
    starts.scatter_(1, torch.where(boundary, pos, cap), idx)
    return starts[:, :cap]


def run_lengths(starts: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """Run lengths from the run starts: the next start (the count at the
    last run) minus this one, clipped to ``[0, cap]``."""
    cap = starts.shape[1]
    nxt = torch.cat([starts[:, 1:], torch.full_like(starts[:, :1], 1 << 30)], dim=1)
    return (torch.minimum(nxt, count.to(torch.int64)[:, None]) - starts).clamp(0, cap)


def rle_encode(v: torch.Tensor, count: torch.Tensor):
    """Run-length encode each row's ``v[:count]`` -> ``(vals, runs, n_runs)``
    padded to cap (entries past ``n_runs``: ``v[cap - 1]`` and 0)."""
    cap = v.shape[1]
    valid = torch.arange(cap, device=v.device)[None, :] < count[:, None]
    prev = torch.cat([v[:, :1] ^ -1, v[:, :-1]], dim=1)     # a boundary at 0
    boundary = valid & (v != prev)
    starts = run_starts(boundary)
    vals = v.gather(1, starts.clamp(0, cap - 1))
    return vals, run_lengths(starts, count), boundary.sum(dim=1)


def rle_expand(vals: torch.Tensor, runs: torch.Tensor, n_runs: torch.Tensor,
               out_cap: int) -> torch.Tensor:
    """Expand runs back out: ``out[i] = vals[j]`` where i falls in run j."""
    cap = vals.shape[1]
    m = torch.arange(cap, device=vals.device)[None, :] < n_runs[:, None]
    ends = torch.where(m, torch.cumsum(torch.where(m, runs, 0), dim=1), _BIG)
    i = torch.arange(out_cap, device=vals.device, dtype=torch.int64).expand(vals.shape[0],
                                                                            out_cap)
    j = torch.searchsorted(ends.contiguous(), i.contiguous(), right=True)
    return vals.gather(1, j.clamp(0, cap - 1))


def delta_encode(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(deltas with d[0] = 0, first value)``; the seed goes to the stream
    header, out of the bitpack range."""
    return v - torch.cat([v[:, :1], v[:, :-1]], dim=1), v[:, 0]


def delta_decode(v: torch.Tensor, count: torch.Tensor, first: torch.Tensor) -> torch.Tensor:
    masked = torch.where(torch.arange(v.shape[1], device=v.device)[None, :] < count[:, None],
                         v, 0)
    return torch.cumsum(masked, dim=1) + first[:, None]


# =====================================================================================
# stream serialization
# =====================================================================================

def le_bytes(x: torch.Tensor, n: int) -> torch.Tensor:
    """The low ``n`` little-endian bytes of each int64 ``x[B]`` -> ``uint8[B, n]``."""
    return ((x.to(torch.int64)[:, None] >> (8 * torch.arange(n, device=x.device))) & 0xFF
            ).to(torch.uint8)


def word_bytes(words: torch.Tensor) -> torch.Tensor:
    """``uint32`` words held in an integer tensor ``[B, W]`` -> ``uint8[B, 4W]``."""
    sh = 8 * torch.arange(4, device=words.device)
    return ((words.to(torch.int64)[:, :, None] >> sh) & 0xFF).to(torch.uint8).reshape(
        words.shape[0], -1)


def stream_bytes(vmin, bits, words, n_words, firsts):
    """Serialize one packed stream a row -> ``(uint8[B, 32 + 4 W], byte_len[B])``."""
    B = vmin.shape[0]
    hdr = torch.cat([le_bytes(vmin, 8), le_bytes(bits, 1),
                     torch.zeros((B, 7), dtype=torch.uint8, device=vmin.device),
                     le_bytes(firsts[0], 8), le_bytes(firsts[1], 8)], dim=1)
    return (torch.cat([hdr, word_bytes(words)], dim=1),
            STREAM_HEADER_BYTES + 4 * n_words.to(torch.int64))


def _parse_stream(comp: torch.Tensor, off: torch.Tensor, count: torch.Tensor, cap_el: int):
    """Parse a stream at each row's offset -> ``(values int64[B, cap_el],
    byte_len, bits_ok, (first0, first1))``."""
    def at(o):
        return _gather_clipped(comp, o)

    def i64_at(o):
        b = at(o[:, None] + torch.arange(8, device=comp.device))
        return (b << (8 * torch.arange(8, device=comp.device))).sum(dim=1)

    vmin = i64_at(off)
    bits = at(off[:, None] + 8)[:, 0]
    firsts = (i64_at(off + 16), i64_at(off + 24))
    bits_ok = bits <= max(bitpack.ALLOWED_BITS)
    n_words = bitpack.packed_words(count, bits)
    wi = torch.arange(2 * cap_el, device=comp.device, dtype=torch.int64)[None, :]
    base = off[:, None] + STREAM_HEADER_BYTES + 4 * wi
    words = at(base) | (at(base + 1) << 8) | (at(base + 2) << 16) | (at(base + 3) << 24)
    words = torch.where(wi < n_words[:, None], words, 0)
    vals = bitpack.unpack(words, cap_el, bits, vmin)
    return vals, STREAM_HEADER_BYTES + 4 * n_words.to(torch.int64), bits_ok, firsts


def assemble(hdr: torch.Tensor, segments, out_cap: int):
    """Header then each ``(bytes, byte_len)`` segment at its running offset
    -> ``(uint8[B, out_cap], end offset[B])``; bytes past ``out_cap`` drop."""
    B = hdr.shape[0]
    pos = torch.arange(out_cap, device=hdr.device, dtype=torch.int64)[None, :]
    out = torch.where(pos < HEADER_BYTES,
                      hdr.gather(1, pos.clamp(0, HEADER_BYTES - 1).expand(B, out_cap)), 0)
    off = torch.full((B, 1), HEADER_BYTES, dtype=torch.int64, device=hdr.device)
    for arr, blen in segments:
        rel = pos - off
        sel = (rel >= 0) & (rel < blen[:, None])
        out = torch.where(sel, arr.gather(1, rel.clamp(0, arr.shape[1] - 1)), out)
        off = off + blen[:, None]
    return out.to(torch.uint8), off[:, 0]


def chunk_header(opts: CascadedOpts, n, n1, n2) -> torch.Tensor:
    """The 24-byte chunk header a row -> ``uint8[B, 24]``."""
    B = n.shape[0]
    fixed = torch.tensor([MAGIC, VERSION, opts.num_rles, opts.num_deltas, int(opts.type),
                          int(opts.use_bp), 0, 0], dtype=torch.uint8, device=n.device)
    return torch.cat([fixed.expand(B, 8), le_bytes(n, 4), le_bytes(n1, 4), le_bytes(n2, 4),
                      torch.zeros((B, HEADER_BYTES - 20), dtype=torch.uint8,
                                  device=n.device)], dim=1)


# =====================================================================================
# encode / decode
# =====================================================================================

def type_info(tid: torch.Tensor):
    """``(type_size, is_signed, is_valid)`` from ElementType ids a row."""
    ts = torch.ones_like(tid, dtype=torch.int64)
    signed = torch.zeros_like(tid, dtype=torch.bool)
    valid = torch.zeros_like(tid, dtype=torch.bool)
    for t in ElementType:
        m = tid == int(t)
        ts = torch.where(m, type_size(t), ts)
        if t != ElementType.BITS:
            signed = torch.where(m, t.is_signed, signed)
        valid = valid | m
    return ts, signed, valid


def max_compressed_chunk_size(max_chunk_bytes: int, opts: CascadedOpts = DEFAULT_OPTS) -> int:
    """Analog of ``nvcompBatchedCascadedCompressGetMaxOutputChunkSize``."""
    ts = type_size(opts.type)
    cap_el = -(-max_chunk_bytes // ts)
    val_bits = 8 * ts
    if opts.num_deltas > 0 or opts.type.is_signed:
        val_bits = min(64, 1 << (8 * ts).bit_length())  # pow2ceil(8*ts + 1)
    size = HEADER_BYTES
    size += opts.num_rles * (STREAM_HEADER_BYTES + 4 * cap_el)  # run widths <= 32
    size += STREAM_HEADER_BYTES + (val_bits // 8) * cap_el
    return (size + 1023) & ~1023


def _encode(data: torch.Tensor, size: torch.Tensor, opts: CascadedOpts, out_cap: int):
    B, cap_bytes = data.shape
    dev = data.device
    ts_py = type_size(opts.type)
    cap_el = -(-cap_bytes // ts_py)
    signed = opts.type.is_signed and opts.type != ElementType.BITS
    size = size.to(torch.int64)
    bad_size = (size % ts_py) != 0
    n = size // ts_py
    el = torch.arange(cap_el, device=dev)[None, :]

    v = bytes_to_elements(data, torch.full((B,), ts_py, device=dev),
                          torch.full((B,), signed, device=dev), cap_el)
    v = torch.where(el < n[:, None], v, 0)

    n1, runs1 = n, None
    if opts.num_rles >= 1:
        v, runs1, n1 = rle_encode(v, n)
    n2, runs2 = n1, None
    if opts.num_rles >= 2:
        v, runs2, n2 = rle_encode(v, n1)

    zero = torch.zeros((B,), dtype=torch.int64, device=dev)
    firsts = [zero, zero]
    for j in range(opts.num_deltas):
        v, firsts[j] = delta_encode(v)
        v = torch.where(el < n2[:, None], v, 0)

    def packed(stream_v, count, fs=(zero, zero)):
        vmin, bits = bitpack.choose_width(stream_v, count)
        bits = bitpack.round_width(bits)
        if not opts.use_bp:
            bits = bitpack.round_bits_pow2(torch.clamp(bits, min=8 * ts_py))
        words = bitpack.pack(stream_v, count, vmin, bits, 2 * cap_el)
        return stream_bytes(vmin, bits, words, bitpack.packed_words(count, bits), fs)

    segments = [packed(r, c) for r, c in ((runs1, n1), (runs2, n2)) if r is not None]
    segments.append(packed(v, n2, tuple(firsts)))
    out, off = assemble(chunk_header(opts, n, n1, n2), segments, out_cap)

    status = torch.where(bad_size, int(Status.ERROR_INVALID_VALUE), int(Status.SUCCESS))
    status = torch.where(off > out_cap, int(Status.ERROR_OUTPUT_BUFFER_TOO_SMALL), status)
    out_size = torch.where(status == Status.SUCCESS, off, 0)
    return out, out_size.to(torch.int32), status.to(torch.int32)


def _u32_at(comp: torch.Tensor, o: int) -> torch.Tensor:
    """The LE u32 at byte ``o`` of each row (clipped reads), as int64."""
    idx = torch.arange(o, o + 4, device=comp.device).expand(comp.shape[0], 4)
    b = _gather_clipped(comp, idx)
    return b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)


def _decode(comp: torch.Tensor, comp_size: torch.Tensor, out_cap: int):
    B = comp.shape[0]
    dev = comp.device
    cap_el = out_cap
    el = torch.arange(cap_el, device=dev)[None, :]
    hdr = _gather_clipped(comp, torch.arange(5, device=dev).expand(B, 5))
    magic, ver, nr, nd, tid = hdr.unbind(1)
    n, n1, n2 = _u32_at(comp, 8), _u32_at(comp, 12), _u32_at(comp, 16)
    ts, signed, type_ok = type_info(tid)
    comp_size = comp_size.to(torch.int64)

    ok = (magic == MAGIC) & (ver == VERSION) & (comp_size >= HEADER_BYTES)
    ok = ok & (nr <= 2) & (nd <= 2) & type_ok & (n * ts <= out_cap)
    ok = ok & (n1 <= n) & (n2 <= n1) & (n <= cap_el)
    # clamp counts so indexing stays in range on corrupt input
    n = n.clamp(0, cap_el)
    n1 = torch.minimum(n1.clamp(min=0), n)
    n2 = torch.minimum(n2.clamp(min=0), n1)

    off = torch.full((B,), HEADER_BYTES, dtype=torch.int64, device=dev)
    runs1, len1, ok1, _ = _parse_stream(comp, off, n1, cap_el)
    off1 = off + torch.where(nr >= 1, len1, 0)
    runs2, len2, ok2, _ = _parse_stream(comp, off1, n2, cap_el)
    off2 = off1 + torch.where(nr >= 2, len2, 0)
    vals, len3, ok3, dfirsts = _parse_stream(comp, off2, n2, cap_el)
    ok = ok & (off2 + len3 <= comp_size)
    ok = ok & ((nr < 1) | ok1) & ((nr < 2) | ok2) & ok3

    # un-delta in reverse pass order (at most two passes)
    for k in range(2):
        j = nd - 1 - k
        seed = torch.where(j == 0, dfirsts[0], dfirsts[1])
        vals = torch.where((j >= 0)[:, None], delta_decode(vals, n2, seed), vals)

    # validate run sums so corrupt runs cannot fake success
    m2, m1 = el < n2[:, None], el < n1[:, None]
    good2 = (torch.where(m2, runs2, 0).sum(dim=1) == n1) & torch.where(m2, runs2 > 0, True).all(1)
    good1 = (torch.where(m1, runs1, 0).sum(dim=1) == n) & torch.where(m1, runs1 > 0, True).all(1)
    ok = ok & ((nr < 2) | good2) & ((nr < 1) | good1)

    vals = torch.where((nr >= 2)[:, None], rle_expand(vals, runs2, n2, cap_el), vals)
    vals = torch.where((nr >= 1)[:, None], rle_expand(vals, runs1, n1, cap_el), vals)

    out = elements_to_bytes(vals, ts, out_cap)
    out_size = torch.where(ok, n * ts, 0)
    out = torch.where(torch.arange(out_cap, device=dev)[None, :] < out_size[:, None], out, 0)
    status = torch.where(ok, int(Status.SUCCESS), int(Status.ERROR_CANNOT_DECOMPRESS))
    return out, out_size.to(torch.int32), status.to(torch.int32)


def get_decompress_size(comp: torch.Tensor, comp_sizes: torch.Tensor) -> torch.Tensor:
    """The decompressed byte count from each chunk header (analog of
    ``nvcompBatchedCascadedGetDecompressSizeAsync``; int32, wrapping)."""
    B = comp.shape[0]
    h = _gather_clipped(comp, torch.tensor([0, 4], device=comp.device).expand(B, 2))
    ts, _, type_ok = type_info(h[:, 1])
    ok = (comp_sizes.to(torch.int64) >= HEADER_BYTES) & (h[:, 0] == MAGIC) & type_ok
    return wrap_i32(torch.where(ok, _u32_at(comp, 8) * ts, 0)).to(torch.int32)


# -- batched entry points -------------------------------------------------------------

def compress_batch(data: torch.Tensor, sizes: torch.Tensor, opts: CascadedOpts, out_cap: int):
    """``uint8[B, cap]`` + sizes -> ``(out uint8[B, out_cap], out_sizes,
    statuses)``; a row whose frame passes ``out_cap`` keeps its first
    ``out_cap`` bytes (``ERROR_OUTPUT_BUFFER_TOO_SMALL``, size 0)."""
    opts = opts if opts is not None else DEFAULT_OPTS
    return by_rows(lambda d, s: _encode(d, s, opts, out_cap),
                   max(out_cap, 8 * data.shape[1]), data, sizes)


def decompress_batch(comp: torch.Tensor, comp_sizes: torch.Tensor, out_cap: int):
    return by_rows(lambda c, s: _decode(c, s, out_cap), 2 * out_cap, comp, comp_sizes)
