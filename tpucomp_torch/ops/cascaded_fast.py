"""The device fast path of Cascaded (same container as
:mod:`tpucomp_torch.formats.cascaded`), with the RLE expansion as a Hopper
kernel.

Port of :mod:`tpucomp.ops.cascaded_fast` (``tpucomp/ops/cascaded_fast.py``),
which the reference dispatches like a kernel.  Element math is exact mod 2^64
on ``(lo, hi)`` pairs of 32-bit halves, held in ``int64`` tensors
(``0 <= x < 2^32``); decoded output truncates to the element width.  Packing
uses the static-width group layouts of the ``bitpack.W64`` ladder: a width's
pack and unpack are reshapes and shifts over ``lcm(32, b)``-bit groups, run
once for the rows that chose that width (the reference runs one chunk at a
time under ``lax.map``; the frames are the same).

Decode is :func:`_stage1` (header, streams, unpack, un-delta, run checks),
the two RLE expansions (:func:`tpucomp_torch.ops.cuda.cascaded_expand
.expand_batch`, row 26 of ``PERF.md``'s table, or its plain version), and
:func:`_stage2` (element bytes, sizes, statuses).  Statuses are the
reference fast path's, which differ from the general program's on two
inputs (``ROADMAP.md`` §C): stream widths off the ``W64`` ladder fail here,
and the header counts are read as int32.

The reference's shape gates stay: rows above 4 MiB encode, and ``out_cap``
above 1 MiB decodes, through the general program.
"""
from __future__ import annotations

import math

import torch

from tpucomp_torch import logging as tlog
from tpucomp_torch.chunk import wrap_i32
from tpucomp_torch.constants import ElementType, Status
from tpucomp_torch.formats import cascaded as fc
from tpucomp_torch.ops.bitpack import M32, W32, W64, bit_length, round_width

ENCODE_GATE = 4 << 20      # larger rows: the general encoder (limb budget)
DECODE_GATE = 1 << 20      # larger out_cap: the general decoder


# =====================================================================================
# static-width pack / unpack (rows of one width)
# =====================================================================================

def _pack_static(lo: torch.Tensor, hi: torch.Tensor, b: int, cap_words: int) -> torch.Tensor:
    """Pack ``(hi << 32 | lo)`` values (each within ``b`` bits) at static
    width ``b`` into ``uint32`` words, LSB-first contiguous: the layout of
    :func:`tpucomp_torch.ops.bitpack.pack`.  Groups of ``lcm(32, b)`` bits
    hold ``ge`` values in ``gw`` words; contributions within a word are
    bit-disjoint and summed."""
    R, cap = lo.shape
    if b == 0:
        return torch.zeros((R, cap_words), dtype=torch.int64, device=lo.device)
    lcm = (32 * b) // math.gcd(32, b)
    ge, gw = lcm // b, lcm // 32
    ng = -(-cap // ge)
    lov = torch.nn.functional.pad(lo, (0, ng * ge - cap)).reshape(R, ng, ge)
    hiv = torch.nn.functional.pad(hi, (0, ng * ge - cap)).reshape(R, ng, ge)
    cols = []
    for w in range(gw):
        acc = torch.zeros((R, ng), dtype=torch.int64, device=lo.device)
        for e in range(ge):
            sv = e * b - 32 * w               # value e's bit offset within word w
            if sv <= -b or sv >= 32:
                continue                      # no overlap with word w
            if sv >= 0:
                acc = acc + ((lov[..., e] << sv) & M32)
            elif sv > -32:
                t = lov[..., e] >> -sv
                if b > 32:
                    t = t | ((hiv[..., e] << (sv + 32)) & M32)
                acc = acc + t
            else:
                acc = acc + (hiv[..., e] >> (-sv - 32))
        cols.append(acc)
    flat = torch.stack(cols, dim=2).reshape(R, ng * gw)
    return torch.nn.functional.pad(flat, (0, max(0, cap_words - flat.shape[1])))[:, :cap_words]


def _unpack_static(words: torch.Tensor, b: int, cap_el: int):
    """Inverse of :func:`_pack_static` -> ``(lo, hi)``, each masked to its
    part of ``b`` bits."""
    R, nw = words.shape
    z = torch.zeros((R, cap_el), dtype=torch.int64, device=words.device)
    if b == 0:
        return z, z
    lcm = (32 * b) // math.gcd(32, b)
    ge, gw = lcm // b, lcm // 32
    ng = -(-cap_el // ge)
    wds = torch.nn.functional.pad(words, (0, max(0, ng * gw - nw)))[:, :ng * gw]
    wds = wds.reshape(R, ng, gw)
    los, his = [], []
    blo = min(b, 32)
    for e in range(ge):
        sv = e * b                            # bit offset of value e in the group
        w0, sh = sv >> 5, sv & 31
        lo = wds[..., w0] >> sh
        if sh + blo > 32:                     # straddles into the next word
            lo = lo | (wds[..., w0 + 1] << (32 - sh))
        los.append(lo & ((1 << blo) - 1))
        if b > 32:
            w1, sh1 = (sv + 32) >> 5, (sv + 32) & 31
            hi = wds[..., w1] >> sh1
            if sh1 + (b - 32) > 32:
                hi = hi | (wds[..., w1 + 1] << (32 - sh1))
            his.append(hi & ((1 << (b - 32)) - 1))
    lo = torch.stack(los, dim=2).reshape(R, -1)[:, :cap_el]
    hi = torch.stack(his, dim=2).reshape(R, -1)[:, :cap_el] if his else z
    return lo, hi


def _width_index(bits: torch.Tensor, widths) -> torch.Tensor:
    """Index of each ``bits`` in the ascending ``widths`` ladder (a width
    off the ladder takes the next member below it, as ``lax.switch`` does)."""
    idx = torch.zeros_like(bits)
    for w in widths[1:]:
        idx = idx + (bits >= w).to(bits.dtype)
    return idx


def _by_width(bits: torch.Tensor, widths, fn):
    """``fn(rows, b)`` for each ladder width ``b`` some row takes (``rows``
    the indices of those rows)."""
    k = _width_index(bits, widths)
    for ki in torch.unique(k).tolist():
        fn(torch.nonzero(k == ki).flatten(), widths[ki])


def pack_any(lo: torch.Tensor, hi: torch.Tensor, bits: torch.Tensor, cap_words: int,
             widths=W64) -> torch.Tensor:
    """Pack each row at its own width ``bits`` (a member of ``widths``)."""
    words = torch.zeros((lo.shape[0], cap_words), dtype=torch.int64, device=lo.device)

    def one(rows, b):
        words[rows] = _pack_static(lo[rows], hi[rows], b, cap_words)

    _by_width(bits, widths, one)
    return words


def unpack_any(words: torch.Tensor, bits: torch.Tensor, cap_el: int, widths=W64):
    lo = torch.zeros((words.shape[0], cap_el), dtype=torch.int64, device=words.device)
    hi = torch.zeros_like(lo)

    def one(rows, b):
        lo[rows], hi[rows] = _unpack_static(words[rows], b, cap_el)

    _by_width(bits, widths, one)
    return lo, hi


# =====================================================================================
# exact mod-2^64 arithmetic on (lo, hi) pairs of 32-bit halves
# =====================================================================================

def _add64(alo, ahi, blo, bhi):
    lo = alo + blo
    return lo & M32, (ahi + bhi + (lo >> 32)) & M32


def _sub64(alo, ahi, blo, bhi):
    lo = alo - blo
    return lo & M32, (ahi - bhi - (lo < 0).to(lo.dtype)) & M32


def _cumsum64(lo: torch.Tensor, hi: torch.Tensor, count: torch.Tensor):
    """Inclusive prefix sum mod 2^64 of each row's ``(lo, hi)[:count]``,
    exactly: each half's running sum stays below 2^52 in int64 (rows of at
    most 2^20 values), and the low half's carries move up."""
    valid = torch.arange(lo.shape[1], device=lo.device)[None, :] < count[:, None]
    s = torch.cumsum(torch.where(valid, lo, 0), dim=1)
    h = torch.cumsum(torch.where(valid, hi, 0), dim=1)
    return s & M32, (h + (s >> 32)) & M32


def _bitlen64(rlo: torch.Tensor, rhi: torch.Tensor) -> torch.Tensor:
    return torch.where(rhi > 0, 32 + bit_length(rhi), bit_length(rlo))


def _minmax_width(lo, hi, count):
    """Frame-of-reference ``(vmin_lo, vmin_hi, bits)`` over each row's
    ``(lo, hi)[:count]``: the unsigned and the signed 64-bit orderings are
    both tried and the narrower range wins (either reconstructs exactly mod
    2^64)."""
    valid = torch.arange(lo.shape[1], device=lo.device)[None, :] < count[:, None]

    def rng_for(offset_hi):
        oh = hi ^ offset_hi
        kh_min = torch.where(valid, oh, M32).amin(dim=1)
        kl_min = torch.where(valid & (oh == kh_min[:, None]), lo, M32).amin(dim=1)
        kh_max = torch.where(valid, oh, 0).amax(dim=1)
        kl_max = torch.where(valid & (oh == kh_max[:, None]), lo, 0).amax(dim=1)
        return (kl_min, kh_min ^ offset_hi), _sub64(kl_max, kh_max, kl_min, kh_min)

    umin, urng = rng_for(0)
    smin, srng = rng_for(0x80000000)
    ubits, sbits = _bitlen64(*urng), _bitlen64(*srng)
    use_s = sbits < ubits
    live = count > 0
    bits = torch.where(live, torch.where(use_s, sbits, ubits), 0)
    vlo = torch.where(live, torch.where(use_s, smin[0], umin[0]), 0)
    vhi = torch.where(live, torch.where(use_s, smin[1], umin[1]), 0)
    return vlo, vhi, bits


# =====================================================================================
# encode (element size static from opts)
# =====================================================================================

def _rle64(lo: torch.Tensor, hi: torch.Tensor, count: torch.Tensor):
    """64-bit RLE on ``(lo, hi)`` pairs -> ``(vals_lo, vals_hi, runs, n_runs)``."""
    cap = lo.shape[1]
    valid = torch.arange(cap, device=lo.device)[None, :] < count[:, None]
    plo = torch.cat([lo[:, :1] ^ M32, lo[:, :-1]], dim=1)
    phi = torch.cat([hi[:, :1], hi[:, :-1]], dim=1)
    boundary = valid & ((lo != plo) | (hi != phi))
    starts = fc.run_starts(boundary)
    sc = starts.clamp(0, cap - 1)
    return (lo.gather(1, sc), hi.gather(1, sc), fc.run_lengths(starts, count),
            boundary.sum(dim=1))


def _encode(data: torch.Tensor, size: torch.Tensor, opts: fc.CascadedOpts, out_cap: int):
    """Fast-path compress of a batch (all element types)."""
    B, cap_bytes = data.shape
    dev = data.device
    ts = fc.type_size(opts.type)
    signed = opts.type.is_signed and opts.type != ElementType.BITS
    cap_el = -(-cap_bytes // ts)
    data = torch.nn.functional.pad(data, (0, cap_el * ts - cap_bytes))

    size = size.to(torch.int64)
    bad_size = (size % ts) != 0
    n = size // ts
    el = torch.arange(cap_el, device=dev)[None, :]

    b = data.reshape(B, cap_el, ts).to(torch.int64)
    lo = b[..., 0]
    for k in range(1, min(ts, 4)):
        lo = lo | (b[..., k] << (8 * k))
    if ts == 8:
        hi = b[..., 4] | (b[..., 5] << 8) | (b[..., 6] << 16) | (b[..., 7] << 24)
    elif signed:                              # sign-extend through both halves
        neg = lo >= (1 << (8 * ts - 1))
        lo = torch.where(neg, lo | (M32 ^ ((1 << (8 * ts)) - 1)), lo)
        hi = torch.where(neg, M32, 0)
    else:
        hi = torch.zeros_like(lo)
    valid0 = el < n[:, None]
    lo, hi = torch.where(valid0, lo, 0), torch.where(valid0, hi, 0)

    n1, runs1 = n, None
    if opts.num_rles >= 1:
        lo, hi, runs1, n1 = _rle64(lo, hi, n)
    n2, runs2 = n1, None
    if opts.num_rles >= 2:
        lo, hi, runs2, n2 = _rle64(lo, hi, n1)

    zero = torch.zeros((B,), dtype=torch.int64, device=dev)
    seeds = [(zero, zero), (zero, zero)]
    for j in range(opts.num_deltas):
        live = n2 > 0
        seeds[j] = (torch.where(live, lo[:, 0], 0), torch.where(live, hi[:, 0], 0))
        plo = torch.cat([lo[:, :1], lo[:, :-1]], dim=1)
        phi = torch.cat([hi[:, :1], hi[:, :-1]], dim=1)
        dlo, dhi = _sub64(lo, hi, plo, phi)
        msk = el < n2[:, None]
        lo, hi = torch.where(msk, dlo, 0), torch.where(msk, dhi, 0)

    widths = W64 if ts == 8 else W32

    def packed(slo, shi, count, f0=(zero, zero), f1=(zero, zero)):
        valid = el < count[:, None]
        slo, shi = torch.where(valid, slo, 0), torch.where(valid, shi, 0)
        vlo, vhi, bits = _minmax_width(slo, shi, count)
        bits = round_width(bits, widths)
        if not opts.use_bp:
            bits = round_width(torch.clamp(bits, min=8 * ts), widths)
        dlo, dhi = _sub64(slo, shi, vlo[:, None], vhi[:, None])
        dlo, dhi = torch.where(valid, dlo, 0), torch.where(valid, dhi, 0)
        words = pack_any(dlo, dhi, bits, 2 * cap_el if ts == 8 else cap_el, widths)
        n_words = (count * bits + 31) // 32
        return fc.stream_bytes(vlo | (vhi << 32), bits, words, n_words,
                               (f0[0] | (f0[1] << 32), f1[0] | (f1[1] << 32)))

    segments = [packed(r, torch.zeros_like(r), c) for r, c in ((runs1, n1), (runs2, n2))
                if r is not None]
    segments.append(packed(lo, hi, n2, seeds[0], seeds[1]))
    out, off = fc.assemble(fc.chunk_header(opts, n, n1, n2), segments, out_cap)

    status = torch.where(bad_size, int(Status.ERROR_INVALID_VALUE), int(Status.SUCCESS))
    status = torch.where(off > out_cap, int(Status.ERROR_OUTPUT_BUFFER_TOO_SMALL), status)
    out_size = torch.where(status == Status.SUCCESS, off, 0)
    out = torch.where(torch.arange(out_cap, device=dev)[None, :] < out_size[:, None], out, 0)
    return out, out_size.to(torch.int32), status.to(torch.int32)


# =====================================================================================
# decode (fully dynamic header; mod-2^64 exact on 32-bit halves)
# =====================================================================================

def comp_words(comp: torch.Tensor, out_cap: int) -> torch.Tensor:
    """The rows' little-endian u32 view (int64), padded so that an
    ``out_cap``-word window starting at any in-row offset stays in bounds."""
    B, cap = comp.shape
    need_words = -(-cap // 4) + out_cap + 16
    c4 = torch.nn.functional.pad(comp, (0, 4 * need_words - cap)).reshape(B, -1, 4)
    c4 = c4.to(torch.int64)
    return c4[..., 0] | (c4[..., 1] << 8) | (c4[..., 2] << 16) | (c4[..., 3] << 24)


def _stage1(comp_u8: torch.Tensor, comp_u32: torch.Tensor, comp_size: torch.Tensor,
            out_cap: int):
    """Parse, unpack and un-delta each row up to the RLE expansion ->
    ``(vlo, vhi, runs1, runs2, scalars, ts, ok)``: the values' halves
    (int64), the run streams (int32), ``int32[B, 4]`` = (n, n1, n2, nr),
    the element size and the checks so far.  The header counts are int32."""
    B, nbytes = comp_u8.shape
    dev = comp_u8.device
    cap_el = out_cap
    L = comp_u32.shape[1]
    idx = torch.arange(cap_el, device=dev)[None, :]
    # the header bytes; reads past a narrow row clip to its last byte
    h = comp_u8[:, torch.arange(20, device=dev).clamp(max=nbytes - 1)].to(torch.int64)
    magic, ver, nr, nd, tid = h[:, :5].unbind(1)

    def u32_at(o):
        return wrap_i32(h[:, o] | (h[:, o + 1] << 8) | (h[:, o + 2] << 16) | (h[:, o + 3] << 24))

    n, n1, n2 = u32_at(8), u32_at(12), u32_at(16)
    ts, _, type_ok = fc.type_info(tid)

    comp_size = comp_size.to(torch.int64)
    ok = (magic == fc.MAGIC) & (ver == fc.VERSION) & (comp_size >= fc.HEADER_BYTES)
    ok = ok & (nr <= 2) & (nd <= 2) & type_ok & (wrap_i32(n * ts) <= out_cap)
    ok = ok & (n1 <= n) & (n2 <= n1) & (n <= cap_el)
    n = n.clamp(0, cap_el)
    n1 = torch.minimum(n1.clamp(min=0), n)
    n2 = torch.minimum(n2.clamp(min=0), n1)

    windows = comp_u32.unfold(1, cap_el, 1)       # [B, L - cap_el + 1, cap_el] view
    rows = torch.arange(B, device=dev)

    def parse_stream(off, count):
        """Streams are 4-byte aligned by construction: the 8 header words
        and ``cap_el`` payload words are windows of the u32 view, their
        starts clamped into it (``dynamic_slice``)."""
        w0 = off >> 2
        shdr = comp_u32.gather(1, w0.clamp(0, L - 8)[:, None] + torch.arange(8, device=dev))
        vlo, vhi, bits = shdr[:, 0], shdr[:, 1], shdr[:, 2] & 0xFF
        bits_ok = (bits[:, None] == torch.tensor(W64, device=dev)).any(dim=1)
        n_words = (count * bits + 31) // 32
        words = windows[rows, (w0 + fc.STREAM_HEADER_BYTES // 4).clamp(0, L - cap_el)]
        words = torch.where(idx < n_words[:, None], words, 0)
        dlo, dhi = unpack_any(words, bits, cap_el, W64)
        lo, hi = _add64(dlo, dhi, vlo[:, None], vhi[:, None])
        blen = fc.STREAM_HEADER_BYTES + 4 * n_words
        return (lo, hi), blen, bits_ok, ((shdr[:, 4], shdr[:, 5]), (shdr[:, 6], shdr[:, 7]))

    off = torch.full((B,), fc.HEADER_BYTES, dtype=torch.int64, device=dev)
    (r1lo, r1hi), len1, ok1, _ = parse_stream(off, n1)
    off1 = off + torch.where(nr >= 1, len1, 0)
    (r2lo, r2hi), len2, ok2, _ = parse_stream(off1, n2)
    off2 = off1 + torch.where(nr >= 2, len2, 0)
    (vlo, vhi), len3, ok3, (df0, df1) = parse_stream(off2, n2)
    ok = ok & (off2 + len3 <= comp_size)
    ok = ok & ((nr < 1) | ok1) & ((nr < 2) | ok2) & ok3

    for k in range(2):
        j = nd - 1 - k
        slo = torch.where(j == 0, df0[0], df1[0])
        shi = torch.where(j == 0, df0[1], df1[1])
        clo, chi = _cumsum64(vlo, vhi, n2)
        clo, chi = _add64(clo, chi, slo[:, None], shi[:, None])
        do = (j >= 0)[:, None]
        vlo, vhi = torch.where(do, clo, vlo), torch.where(do, chi, vhi)

    runs1, runs2 = wrap_i32(r1lo), wrap_i32(r2lo)
    m1, m2 = idx < n1[:, None], idx < n2[:, None]
    ok = ok & ((nr < 1) | torch.where(m1, r1hi == 0, True).all(dim=1))
    ok = ok & ((nr < 2) | torch.where(m2, r2hi == 0, True).all(dim=1))

    def check(runs, msk, want_total):
        """Every run in (0, cap_el], and the runs (int32 sums) add up."""
        s_ok = torch.where(msk, (runs > 0) & (runs <= cap_el), True).all(dim=1)
        ends = wrap_i32(torch.cumsum(torch.where(msk, runs.clamp(0, cap_el), 0), dim=1))
        total = torch.where(msk, ends, 0).amax(dim=1)
        return s_ok & (total == want_total)

    ok = ok & ((nr < 2) | check(runs2, m2, n1)) & ((nr < 1) | check(runs1, m1, n))
    scalars = torch.stack([n, n1, n2, nr.clamp(0, 2)], dim=1).to(torch.int32)
    return (vlo, vhi, runs1.to(torch.int32), runs2.to(torch.int32), scalars, ts, ok)


def _stage2(vlo, vhi, ts, n, ok, out_cap: int):
    """Expanded ``(lo, hi)`` element halves -> output bytes, sizes, statuses."""
    B = vlo.shape[0]

    def to_bytes(ts_py):
        ecount = out_cap // ts_py
        parts = [fc.word_bytes(vlo[:, :ecount]).reshape(B, ecount, 4)[..., :min(ts_py, 4)]]
        if ts_py == 8:
            parts.append(fc.word_bytes(vhi[:, :ecount]).reshape(B, ecount, 4))
        by = torch.cat(parts, dim=2).reshape(B, -1)
        return torch.nn.functional.pad(by, (0, out_cap - by.shape[1]))

    out = to_bytes(1)
    for ts_py in (2, 4, 8):
        out = torch.where((ts == ts_py)[:, None], to_bytes(ts_py), out)
    out_size = torch.where(ok, n.to(torch.int64) * ts, 0)
    out = torch.where(torch.arange(out_cap, device=vlo.device)[None, :] < out_size[:, None],
                      out, 0)
    status = torch.where(ok, int(Status.SUCCESS), int(Status.ERROR_CANNOT_DECOMPRESS))
    return out, out_size.to(torch.int32), status.to(torch.int32)


# =====================================================================================
# batched entry points (the dispatch-facing API)
# =====================================================================================

def compress_batch(data: torch.Tensor, sizes: torch.Tensor, opts, out_cap: int):
    """Fast-path compress, on ``data``'s device (torch ops: the reference's
    encoder reaches no kernel)."""
    opts = opts if opts is not None else fc.DEFAULT_OPTS
    if data.shape[1] > ENCODE_GATE:
        tlog.debug("cascaded fast compress: rows of %d bytes > %d, the general encoder",
                   data.shape[1], ENCODE_GATE)
        return fc.compress_batch(data, sizes, opts, out_cap)
    return _encode(data, sizes, opts, out_cap)


def decompress_batch(comp: torch.Tensor, comp_sizes: torch.Tensor, out_cap: int,
                     plain: bool = False):
    """Fast-path decompress: :func:`_stage1`, the expansion, :func:`_stage2`.
    The expansion is the row-26 kernel (CUDA tensors only), or with
    ``plain=True`` its plain version on any device."""
    if out_cap > DECODE_GATE:
        tlog.debug("cascaded fast decompress: out_cap %d > %d, the general decoder",
                   out_cap, DECODE_GATE)
        return fc.decompress_batch(comp, comp_sizes, out_cap)
    from tpucomp_torch.ops.cuda import cascaded_expand
    vlo, vhi, runs1, runs2, scalars, ts, ok = _stage1(comp, comp_words(comp, out_cap),
                                                      comp_sizes, out_cap)
    expand = cascaded_expand.expand_batch_plain if plain else cascaded_expand.expand_batch
    elo, ehi = expand(wrap_i32(vlo).to(torch.int32), wrap_i32(vhi).to(torch.int32),
                      runs1, runs2, scalars, out_cap)
    return _stage2(elo.to(torch.int64) & M32, ehi.to(torch.int64) & M32, ts,
                   scalars[:, 0], ok, out_cap)
