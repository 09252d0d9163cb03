"""Batched Zstandard (RFC 8878) frame decode: the Hopper kernel and its plain version.

Port of :mod:`tpucomp.ops.pallas.zstd_decode` (``_kernel`` behind its two
wrappers ``decompress_batch`` and ``decompress_batch_big``).  The kernel is
``csrc/zstd_decode.cu`` (one warp per chunk; its header says what it
replaces, what bounds it and how it is built).  On the TPU the two wrappers
differ in where the bytes live (a chunk-resident VMEM block, or windows over
HBM for chunks up to 16 MiB); on the card the output row lives in device
memory either way, so they are one kernel and differ only in the literal
capacity ``lit_cap`` that bounds a block's regenerated literals:
``min(128 KiB, round_up(out_cap, 128))`` for :func:`decompress_batch` and
128 KiB for :func:`decompress_batch_big`.  A block with more literals than
``lit_cap`` is ``ERROR_CANNOT_DECOMPRESS``, so a frame can fail under the
first wrapper and be merely too big for the output under the second.
:func:`dispatch` chooses the wrapper as the reference's batched dispatch does
(``tpucomp/ops/pallas/__init__.py:100-123``).

The plain version walks each frame in Python with the reference's
semantics, statuses included: frame header (magic, reserved bit, no
dictionaries, Frame_Content_Size skipped, content checksum not verified),
the predefined FSE tables built before the first block, raw/RLE/compressed
blocks of at most 128 KiB, literals raw/RLE/Huffman/treeless in one or four
backward streams, the Huffman weights direct or FSE-coded, the sequence
tables predefined/RLE/FSE/repeat, repeat offsets with the ``ll == 0`` case.
Bytes at and past ``comp_cap`` read as 0 (a negative index reads byte
``i & 3`` of the row, as the reference's word clamp does).  Output that
would pass ``out_cap`` is not written but the walk goes on, so an error later
in the frame wins over ``ERROR_OUTPUT_BUFFER_TOO_SMALL``; an error settles
the status, so the walk stops there (the reference walks on without effect).

Contract (the reference's): ``comp uint8[B, comp_cap]`` plus ``comp_sizes
int32[B]`` -> ``(out uint8[B, out_cap], out_sizes int32[B], statuses
int32[B])``; bytes past each size are zero, a failed chunk has size 0 and a
zero row.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpucomp_torch.chunk import round_up
from tpucomp_torch.constants import Status
from tpucomp_torch.formats.zstd import (LL_BASE, LL_BITS, LL_DEFAULT, LL_DEFAULT_ACC, MAGIC,
                                        ML_BASE, ML_BITS, ML_DEFAULT, ML_DEFAULT_ACC,
                                        OF_DEFAULT, OF_DEFAULT_ACC)
from tpucomp_torch.ops.cuda import _build

HUF_CAP = 2048          # 2^11: literal Huffman max_bits <= 11
FSE_CAP = 512           # 2^9: sequence table accuracy logs <= 9
TAB_LL, TAB_OF, TAB_ML, TAB_W = 0, FSE_CAP, 2 * FSE_CAP, 3 * FSE_CAP
FSE_TOTAL = 3 * FSE_CAP + 64   # + the Huffman-weight table (acc <= 6)
BLOCK_CAP = 1 << 17     # RFC 8878 Block_Maximum_Size: bounds a block and its literals
LANE = 128              # the reference's lane row: lit_cap rounds to it

_LL = [(int(b), int(n)) for b, n in zip(LL_BASE, LL_BITS)]
_ML = [(int(b), int(n)) for b, n in zip(ML_BASE, ML_BITS)]
# (norm, accuracy log, table base, the largest symbol) per sequence table
_PREDEF = {"ll": ([int(v) for v in LL_DEFAULT], LL_DEFAULT_ACC, TAB_LL, 35),
           "of": ([int(v) for v in OF_DEFAULT], OF_DEFAULT_ACC, TAB_OF, 31),
           "ml": ([int(v) for v in ML_DEFAULT], ML_DEFAULT_ACC, TAB_ML, 52)}


def lit_cap_of(out_cap: int, big: bool) -> int:
    """The literal capacity of each wrapper (``zstd_decode.py:1226,1291``)."""
    return BLOCK_CAP if big else min(BLOCK_CAP, round_up(out_cap, LANE))


def uses_big(comp_cap: int, out_cap: int) -> bool:
    """The reference dispatch's VMEM-fit gate (``ops/pallas/__init__.py:114-115``):
    chunks whose estimate passes 12 MiB take ``decompress_batch_big``."""
    return 2 * 4 * (out_cap + comp_cap) + (1 << 21) > 12 << 20


def _bitlen(x: int, hi: int) -> int:
    """The reference's ``bitlen(x, hi)``: how many k < hi have x >= 2^k."""
    return min(x.bit_length(), hi) if x > 0 else 0


def _fse_build(tab: list, norm: list, nsym: int, acc: int, tbase: int) -> None:
    """Decode table from ``norm[:nsym]`` into ``tab[tbase:tbase + 2^acc]``,
    entries ``base << 16 | nbits << 8 | symbol`` (``zstd_decode.py:333-392``).
    The counts sum to 2^acc (the caller checked), so the spread ends."""
    size = 1 << acc
    high = size - 1
    for s in range(nsym):
        if norm[s] == -1:
            tab[tbase + high] = s
            high -= 1
    step = (size >> 1) + (size >> 3) + 3
    p = 0
    for s in range(nsym):
        for _ in range(max(norm[s], 0)):
            tab[tbase + p] = s
            p = (p + step) & (size - 1)
            while p > high:
                p = (p + step) & (size - 1)
    nxt = [1 if n == -1 else max(n, 0) for n in norm[:nsym]]
    for i in range(size):
        s = tab[tbase + i]
        x = nxt[s]
        nxt[s] = x + 1
        nb = acc - (_bitlen(x, 11) - 1)
        tab[tbase + i] = (((x << nb) - size) << 16) | (nb << 8) | s


def _decode_chunk(row: bytes, csize: int, out_cap: int,
                  lit_cap: int) -> tuple[bytearray, int, int]:
    """One frame -> (output row of out_cap bytes, size, status).  ``row`` is
    the chunk's whole row of ``comp_cap`` bytes."""
    cap = len(row)

    def getb(i: int) -> int:
        if i >= 0:
            return row[i] if i < cap else 0
        return row[i & 3] if (i & 3) < cap else 0

    def bits(pos: int, n: int) -> int:                 # n <= 30 bits at pos >= 0
        p = pos >> 3
        return (int.from_bytes(row[p:p + 5], "little") >> (pos & 7)) & ((1 << n) - 1)

    def bwd_init(start: int, nbytes: int) -> tuple[int, int, bool]:
        """-> (base bit, bits left, err) of a backward stream: the top set
        bit of its last byte is the padding marker."""
        last = getb(start + nbytes - 1)
        return start * 8, (nbytes - 1) * 8 + _bitlen(last, 8) - 1, nbytes <= 0 or last == 0

    def bwd_read(base: int, left: int, n: int) -> tuple[int, int]:
        """The top n bits below ``left``; on underflow zeros pad from the bottom."""
        left2 = left - n
        if n <= 0:
            return 0, left2
        if left2 >= 0:
            return bits(base + left2, n), left2
        return bits(base, max(left, 0)) << min(-left2, 30), left2

    tab = [0] * FSE_TOTAL
    huf = [0] * HUF_CAP
    lit = bytearray(lit_cap)
    out = bytearray(out_cap)
    fail = bytearray(out_cap), 0, int(Status.ERROR_CANNOT_DECOMPRESS)

    def read_ncount(bp: int, max_sym: int) -> tuple[int, int, list, bool]:
        """Normalized counts at bit bp -> (acc, next bp, counts, err)."""
        acc = bits(bp, 4) + 5
        norm = [0] * 64
        bp, rem, n, prev0 = bp + 4, (1 << acc) + 1, 0, False
        while acc <= 9 and rem > 1 and n <= max_sym:
            if prev0:
                r = 3
                while r == 3:
                    r = bits(bp, 2)
                    n = min(n + r, 63)
                    bp += 2
                prev0 = False
                if n > max_sym:
                    break
            nbb = _bitlen(rem, 11)
            thr = 1 << max(nbb - 1, 0)
            mx = 2 * thr - 1 - rem
            v = bits(bp, nbb)
            low = v & (thr - 1)
            if low < mx:
                cnt, bp = low - 1, bp + nbb - 1
            else:
                cnt, bp = (v - mx if v >= thr else v) - 1, bp + nbb
            rem -= abs(cnt)
            norm[min(n, 63)] = cnt
            n += 1
            prev0 = cnt == 0
        return acc, bp, norm[:n], acc > 9 or rem != 1

    def huf_weights(tree_pos: int) -> tuple[list, int, bool]:
        """-> (weights incl. the implied last one, tree bytes, err)."""
        thdr = getb(tree_pos)
        w = [0] * 288
        if thdr >= 128:                                # direct 4-bit weights
            n = thdr - 127
            for i in range(n):
                by = getb(tree_pos + 1 + (i >> 1))
                w[i] = by >> 4 if i % 2 == 0 else by & 0xF
            tree_bytes = 1 + ((n + 1) >> 1)
        else:                                          # FSE-coded, two states
            acc, bp, norm, e = read_ncount((tree_pos + 1) * 8, 32)
            if e or acc > 6:
                return w, 0, True
            _fse_build(tab, norm, len(norm), acc, TAB_W)
            start = (bp + 7) >> 3
            base, left, e = bwd_init(start, tree_pos + 1 + thdr - start)
            s0, left = bwd_read(base, left, acc)
            s1, left = bwd_read(base, left, acc)
            if e or left < 0:
                return w, 0, True
            n = 0
            while n < 255:
                ent = tab[TAB_W + s0]
                w[n] = ent & 0xFF
                v, left = bwd_read(base, left, (ent >> 8) & 0xFF)
                n += 1
                if left < 0:                           # emit the other state, stop
                    w[n] = tab[TAB_W + s1] & 0xFF
                    n += 1
                    break
                s0 = ((ent >> 16) & 0xFFFF) + v
                ent = tab[TAB_W + s1]
                w[n] = ent & 0xFF
                v, left = bwd_read(base, left, (ent >> 8) & 0xFF)
                n += 1
                if left < 0:
                    w[n] = tab[TAB_W + s0] & 0xFF
                    n += 1
                    break
                s1 = ((ent >> 16) & 0xFFFF) + v
            tree_bytes = 1 + thdr
        n = min(n, 255)
        total = sum(1 << (min(x, 12) - 1) for x in w[:n] if x > 0)
        tl = _bitlen(total, 20)
        rest = (1 << tl) - total
        w[n] = _bitlen(rest, 20)
        return w[:n + 1], tree_bytes, total <= 0 or rest <= 0 or (rest & (rest - 1)) != 0

    def huf_build(w: list) -> tuple[int, bool]:
        """Weights -> the single-level table in ``huf``; (max_bits, err)."""
        total = sum(1 << (min(x, 12) - 1) for x in w if x > 0)
        max_bits = _bitlen(total, 20) - 1
        if max_bits < 1 or max_bits > 11:
            return max_bits, True
        size = 1 << max_bits
        huf[:] = [0] * HUF_CAP
        p = 0
        for wt in range(1, 13):                        # ascending weight, then symbol
            run = 1 << (wt - 1)
            ent = max_bits + 1 - wt
            for s, x in enumerate(w):
                if x == wt:
                    if p + run <= size:
                        huf[p:p + run] = [(s << 8) | ent] * run
                    p += run
        return max_bits, p != size

    def huf_stream(start: int, nbytes: int, count: int, dst: int, mb: int) -> bool:
        """One backward Huffman stream into lit[dst:dst + count]; -> err."""
        base, left, e = bwd_init(start, nbytes)
        if e:
            return True
        for i in range(count):
            nn = min(max(left, 0), mb)
            ent = huf[bits(base + max(left - mb, 0), nn) << (mb - nn)]
            nb = ent & 0xFF
            if nb == 0:
                return True
            lit[dst + i] = ent >> 8
            left -= nb
            if left < 0:
                return True
        return left != 0

    # ---- frame header
    magic = getb(0) | (getb(1) << 8) | (getb(2) << 16) | (getb(3) << 24)
    fhd = getb(4)
    if csize < 5 or magic != MAGIC or (fhd >> 3) & 1 or fhd & 3:
        return fail
    single = (fhd >> 5) & 1
    pos = 5 + (1 - single) + (single, 2, 4, 8)[fhd >> 6]
    # the predefined tables, so that repeat mode in the first block resolves
    accs = {}
    for name, (norm, acc, tbase, _) in _PREDEF.items():
        _fse_build(tab, norm, len(norm), acc, tbase)
        accs[name] = acc
    op, done, r0, r1, r2, hbits = 0, False, 1, 4, 8, 0

    def emit(src: bytes | bytearray, n: int) -> None:
        if op + n <= out_cap:
            out[op:op + n] = src

    while not done and pos + 3 <= csize:
        bh = getb(pos) | (getb(pos + 1) << 8) | (getb(pos + 2) << 16)
        done, btype, bsize = bool(bh & 1), (bh >> 1) & 3, bh >> 3
        pos += 3
        if btype == 3 or bsize > BLOCK_CAP:
            return fail
        if btype == 0:                                 # raw
            if pos + bsize > csize:
                return fail
            blk = row[pos:pos + bsize]
            emit(blk + bytes(bsize - len(blk)), bsize)
            pos, op = pos + bsize, op + bsize
            continue
        if btype == 1:                                 # RLE
            if pos + 1 > csize:
                return fail
            emit(bytes([getb(pos)]) * bsize, bsize)
            pos, op = pos + 1, op + bsize
            continue
        block_end = pos + bsize                        # compressed
        if block_end > csize:
            return fail
        # -- literals section
        lsh = getb(pos)
        lit_type, fmt = lsh & 3, (lsh >> 2) & 3
        if lit_type <= 1:                              # raw / RLE literals
            hdr = 2 if fmt == 1 else 3 if fmt == 3 else 1
            regen = ((lsh >> 4) | (getb(pos + 1) << 4) if fmt == 1 else
                     (lsh >> 4) | (getb(pos + 1) << 4) | (getb(pos + 2) << 12) if fmt == 3
                     else lsh >> 3)
            lit_end = pos + hdr + (regen if lit_type == 0 else 1)
            if regen > lit_cap or lit_end > block_end:
                return fail
            if lit_type == 0:
                src = row[pos + hdr:pos + hdr + regen]
                lit[:regen] = src + bytes(regen - len(src))
            else:
                lit[:regen] = bytes([getb(pos + hdr)]) * regen
        else:                                          # Huffman / treeless
            hdr, nbits = (3, 10) if fmt <= 1 else (4, 14) if fmt == 2 else (5, 18)
            w40 = (getb(pos) | (getb(pos + 1) << 8) | (getb(pos + 2) << 16)
                   | (getb(pos + 3) << 24) | (getb(pos + 4) << 32))
            mask = (1 << nbits) - 1
            regen, cs = (w40 >> 4) & mask, (w40 >> (4 + nbits)) & mask
            lit_end = pos + hdr + cs
            spos = pos + hdr
            if regen > lit_cap or lit_end > block_end:
                return fail
            if lit_type == 3:
                if hbits == 0:
                    return fail
            else:
                w, tree_bytes, e = huf_weights(spos)
                if e:
                    return fail
                hbits, e = huf_build(w)
                if e:
                    return fail
                spos += tree_bytes
            if fmt >= 1:                               # four streams
                j1 = getb(spos) | (getb(spos + 1) << 8)
                j2 = getb(spos + 2) | (getb(spos + 3) << 8)
                j3 = getb(spos + 4) | (getb(spos + 5) << 8)
                sbase = spos + 6
                j4 = lit_end - sbase - j1 - j2 - j3
                per = (regen + 3) >> 2
                cl = regen - 3 * per
                if j4 <= 0 or cl < 0:
                    return fail
                for k, (start, nb, count) in enumerate((
                        (sbase, j1, per), (sbase + j1, j2, per),
                        (sbase + j1 + j2, j3, per), (sbase + j1 + j2 + j3, j4, cl))):
                    if huf_stream(start, nb, count, k * per, hbits):
                        return fail
            elif huf_stream(spos, lit_end - spos, regen, 0, hbits):
                return fail
        # -- sequences section
        b0 = getb(lit_end)
        if b0 < 128:
            nseq, sq = b0, lit_end + 1
        elif b0 < 255:
            nseq, sq = ((b0 - 128) << 8) + getb(lit_end + 1), lit_end + 2
        else:
            nseq, sq = getb(lit_end + 1) + (getb(lit_end + 2) << 8) + 0x7F00, lit_end + 3
        lit_pos = 0
        if nseq > 0:
            scm = getb(sq)
            sq += 1
            if scm & 3:
                return fail
            for name, shift in (("ll", 6), ("of", 4), ("ml", 2)):
                norm, dacc, tbase, msym = _PREDEF[name]
                mode = (scm >> shift) & 3
                if mode == 0:
                    _fse_build(tab, norm, len(norm), dacc, tbase)
                    accs[name] = dacc
                elif mode == 1:
                    sym = getb(sq)
                    if sym > msym:
                        return fail
                    tab[tbase] = sym
                    sq, accs[name] = sq + 1, 0
                elif mode == 2:
                    acc, bp, cnts, e = read_ncount(sq * 8, msym)
                    if e:
                        return fail
                    _fse_build(tab, cnts, len(cnts), acc, tbase)
                    sq, accs[name] = (bp + 7) >> 3, acc
            base, left, e = bwd_init(sq, block_end - sq)
            ll_s, left = bwd_read(base, left, accs["ll"])
            of_s, left = bwd_read(base, left, accs["of"])
            ml_s, left = bwd_read(base, left, accs["ml"])
            if e or left < 0:
                return fail
            for i in range(nseq):
                ll_e, of_e, ml_e = tab[TAB_LL + ll_s], tab[TAB_OF + of_s], tab[TAB_ML + ml_s]
                of_sym = of_e & 0xFF
                if of_sym > 30:
                    return fail
                ofb, left = bwd_read(base, left, of_sym)
                ofv = (1 << of_sym) + ofb
                mbase, mnb = _ML[min(ml_e & 0xFF, 52)]
                mlb, left = bwd_read(base, left, mnb)
                ml = mbase + mlb
                lbase, lnb = _LL[min(ll_e & 0xFF, 35)]
                llb, left = bwd_read(base, left, lnb)
                ll = lbase + llb
                if left < 0:
                    return fail
                if ofv <= 3:                           # repeat offsets
                    ridx = ofv - 1 + (ll == 0)
                    off = (r0, r1, r2, r0 - 1)[ridx]
                    if ridx > 0:
                        r0, r1, r2 = off, r0, (r1 if ridx >= 2 else r2)
                else:
                    off = ofv - 3
                    r0, r1, r2 = off, r0, r1
                if off <= 0 or lit_pos + ll > regen:
                    return fail
                emit(lit[lit_pos:lit_pos + ll], ll)
                lit_pos, op = lit_pos + ll, op + ll
                if off > op:
                    return fail
                if op + ml <= out_cap:
                    pat = out[op - off:op]
                    out[op:op + ml] = (pat * (ml // off + 1))[:ml] if off < ml else pat[:ml]
                op += ml
                if i + 1 < nseq:                       # state updates: ll, ml, of
                    lnb2, mnb2, onb2 = (ll_e >> 8) & 0xFF, (ml_e >> 8) & 0xFF, (of_e >> 8) & 0xFF
                    v, left = bwd_read(base, left, lnb2 + mnb2 + onb2)
                    ll_s = ((ll_e >> 16) & 0xFFFF) + (v >> (mnb2 + onb2))
                    ml_s = ((ml_e >> 16) & 0xFFFF) + ((v >> onb2) & ((1 << mnb2) - 1))
                    of_s = ((of_e >> 16) & 0xFFFF) + (v & ((1 << onb2) - 1))
                    if left < 0:
                        return fail
            if left != 0:
                return fail
        rest = regen - lit_pos                         # trailing literals
        emit(lit[lit_pos:regen], rest)
        op += rest
        pos = block_end
    if not done:
        return fail
    if op > out_cap:
        return bytearray(out_cap), 0, int(Status.ERROR_OUTPUT_BUFFER_TOO_SMALL)
    return out, op, int(Status.SUCCESS)


def _plain(comp: torch.Tensor, comp_sizes: torch.Tensor, out_cap: int, lit_cap: int):
    data = comp.cpu().numpy()
    sizes = comp_sizes.cpu().numpy().astype(np.int64)
    B = data.shape[0]
    out = np.zeros((B, out_cap), np.uint8)
    osz = np.zeros(B, np.int32)
    stat = np.zeros(B, np.int32)
    for i in range(B):
        row, osz[i], stat[i] = _decode_chunk(data[i].tobytes(), int(sizes[i]), out_cap,
                                             lit_cap)
        out[i] = np.frombuffer(row, np.uint8)
    dev = comp.device
    return (torch.from_numpy(out).to(dev), torch.from_numpy(osz).to(dev),
            torch.from_numpy(stat).to(dev))


def decompress_batch_plain(comp: torch.Tensor, comp_sizes: torch.Tensor, out_cap: int):
    """Plain version of :func:`decompress_batch` (row 18): the same function,
    walked in Python on the host.  Returns tensors on ``comp``'s device."""
    return _plain(comp, comp_sizes, out_cap, lit_cap_of(out_cap, big=False))


def decompress_batch_big_plain(comp: torch.Tensor, comp_sizes: torch.Tensor, out_cap: int):
    """Plain version of :func:`decompress_batch_big` (row 19)."""
    return _plain(comp, comp_sizes, out_cap, lit_cap_of(out_cap, big=True))


def _launch(comp: torch.Tensor, comp_sizes: torch.Tensor, out_cap: int, lit_cap: int):
    if comp.device.type != "cuda":
        raise ValueError(f"the Zstandard decode kernel needs CUDA tensors, got {comp.device}")
    if comp.dtype != torch.uint8 or comp.dim() != 2:
        raise ValueError(f"comp must be uint8[B, cap], got {comp.dtype}{list(comp.shape)}")
    B, comp_cap = comp.shape
    if comp_sizes.shape != (B,):
        raise ValueError(f"comp_sizes must be int32[{B}]")
    comp = comp.contiguous()
    comp_sizes = comp_sizes.to(device=comp.device, dtype=torch.int32).contiguous()
    out = torch.empty((B, out_cap), dtype=torch.uint8, device=comp.device)
    osz = torch.empty((B,), dtype=torch.int32, device=comp.device)
    stat = torch.empty((B,), dtype=torch.int32, device=comp.device)
    lits = torch.empty((B, lit_cap), dtype=torch.uint8, device=comp.device)
    fn = _build.load("zstd_decode").tpucomp_zstd_decode
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, i, p, i, p, i, p, p, p]
    fn.restype = i
    with torch.cuda.device(comp.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(comp.data_ptr(), comp_sizes.data_ptr(), B, comp_cap, out.data_ptr(), out_cap,
                lits.data_ptr(), lit_cap, osz.data_ptr(), stat.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"zstd_decode kernel launch failed: cudaError {rc}")
    return out, osz, stat


def decompress_batch(comp: torch.Tensor, comp_sizes: torch.Tensor, out_cap: int):
    """Row 18: launch ``csrc/zstd_decode.cu`` with the chunk-resident
    wrapper's ``lit_cap`` on ``comp``'s card, on the current stream.  Raises
    for tensors that are not on a CUDA device."""
    r = _launch(comp, comp_sizes, out_cap, lit_cap_of(out_cap, big=False))
    decompress_batch.launches += 1
    return r


def decompress_batch_big(comp: torch.Tensor, comp_sizes: torch.Tensor, out_cap: int):
    """Row 19: the same kernel with the 16 MiB regime's ``lit_cap`` (128 KiB)."""
    r = _launch(comp, comp_sizes, out_cap, lit_cap_of(out_cap, big=True))
    decompress_batch_big.launches += 1
    return r


decompress_batch.launches = 0
decompress_batch_big.launches = 0


def dispatch(comp: torch.Tensor, comp_sizes: torch.Tensor, out_cap: int, plain: bool = False):
    """Row 18 or row 19 by the reference's gate (:func:`uses_big`); the
    kernels, or with ``plain`` their plain versions."""
    big = uses_big(comp.shape[1], out_cap)
    if plain:
        return (decompress_batch_big_plain if big else decompress_batch_plain)(
            comp, comp_sizes, out_cap)
    return (decompress_batch_big if big else decompress_batch)(comp, comp_sizes, out_cap)
