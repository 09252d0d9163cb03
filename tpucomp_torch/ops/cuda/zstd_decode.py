"""Batched Zstandard (RFC 8878) frame decode: the reference's two wrappers
on the card, the frame walk kernel, and their plain version.

Port of :mod:`tpucomp.ops.pallas.zstd_decode` (``_kernel`` behind its two
wrappers ``decompress_batch`` and ``decompress_batch_big``).  On the TPU the
two wrappers differ in where the bytes live (a chunk-resident VMEM block, or
windows over HBM for chunks up to 16 MiB); on the card the output row lives
in device memory either way, so both run the block-parallel passes of
:mod:`tpucomp_torch.ops.cuda.zstd_passes` (``csrc/zstd_passes.cu``) and
differ only in the literal capacity ``lit_cap`` that bounds a block's
regenerated literals: ``min(128 KiB, round_up(out_cap, 128))`` for
:func:`decompress_batch` and 128 KiB for :func:`decompress_batch_big`.  A
block with more literals than ``lit_cap`` is ``ERROR_CANNOT_DECOMPRESS``, so
a frame can fail under the first wrapper and be merely too big for the
output under the second.  :func:`dispatch` chooses the wrapper as the
reference's batched dispatch does (``tpucomp/ops/pallas/__init__.py:100-123``).
The frame walk, one warp a frame (``csrc/zstd_decode.cu``, launched by
:func:`tpucomp_torch.ops.cuda.zstd_passes.settle_kernel`), gives the status
alone of the frames whose smallest output already passes ``out_cap``.

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
:class:`Row` and its helpers are the frame's building blocks, which the plain
passes share.

Contract (the reference's): ``comp uint8[B, comp_cap]`` plus ``comp_sizes
int32[B]`` -> ``(out uint8[B, out_cap], out_sizes int32[B], statuses
int32[B])``; bytes past each size are zero, a failed chunk has size 0 and a
zero row.
"""
from __future__ import annotations

import numpy as np
import torch

from tpucomp_torch.chunk import round_up
from tpucomp_torch.constants import Status
from tpucomp_torch.formats.zstd import (LL_BASE, LL_BITS, LL_DEFAULT, LL_DEFAULT_ACC, MAGIC,
                                        ML_BASE, ML_BITS, ML_DEFAULT, ML_DEFAULT_ACC,
                                        OF_DEFAULT, OF_DEFAULT_ACC)

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


class Row:
    """A compressed row of ``comp_cap`` bytes read as the reference reads it:
    bytes at and past ``comp_cap`` read as 0, a negative index reads byte
    ``i & 3``.  Its methods are the frame's building blocks, shared by the
    walk (:func:`_decode_chunk`) and the plain passes of
    :mod:`tpucomp_torch.ops.cuda.zstd_passes`."""

    def __init__(self, row: bytes):
        self.row = row
        self.cap = len(row)

    def getb(self, i: int) -> int:
        if i >= 0:
            return self.row[i] if i < self.cap else 0
        return self.row[i & 3] if (i & 3) < self.cap else 0

    def bits(self, pos: int, n: int) -> int:           # n <= 30 bits at pos >= 0
        p = pos >> 3
        return (int.from_bytes(self.row[p:p + 5], "little") >> (pos & 7)) & ((1 << n) - 1)

    def span(self, start: int, n: int) -> bytes:
        """``n`` bytes from ``start >= 0``, zeros past the row."""
        b = self.row[start:start + n]
        return b + bytes(n - len(b))

    def bwd_init(self, start: int, nbytes: int) -> tuple[int, int, bool]:
        """-> (base bit, bits left, err) of a backward stream: the top set
        bit of its last byte is the padding marker."""
        last = self.getb(start + nbytes - 1)
        return start * 8, (nbytes - 1) * 8 + _bitlen(last, 8) - 1, nbytes <= 0 or last == 0

    def bwd_read(self, base: int, left: int, n: int) -> tuple[int, int]:
        """The top n bits below ``left``; on underflow zeros pad from the bottom."""
        left2 = left - n
        if n <= 0:
            return 0, left2
        if left2 >= 0:
            return self.bits(base + left2, n), left2
        return self.bits(base, max(left, 0)) << min(-left2, 30), left2

    def read_ncount(self, bp: int, max_sym: int) -> tuple[int, int, list, bool]:
        """Normalized counts at bit bp -> (acc, next bp, counts, err)."""
        bits = self.bits
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

    def seq_table(self, tab: list, name: str, mode: int, sq: int) -> tuple[int, int, bool]:
        """One sequence table of ``mode`` (0 predefined, 1 RLE, 2 FSE; 3,
        repeat, reads nothing) from byte ``sq`` into ``tab`` -> (the next
        byte, its accuracy log or -1 for a repeat, err).  RLE writes entry 0
        only, at accuracy 0."""
        norm, dacc, tbase, msym = _PREDEF[name]
        if mode == 0:
            _fse_build(tab, norm, len(norm), dacc, tbase)
            return sq, dacc, False
        if mode == 1:
            sym = self.getb(sq)
            if sym > msym:
                return sq, 0, True
            tab[tbase] = sym
            return sq + 1, 0, False
        if mode == 2:
            acc, bp, cnts, e = self.read_ncount(sq * 8, msym)
            if e:
                return sq, acc, True
            _fse_build(tab, cnts, len(cnts), acc, tbase)
            return (bp + 7) >> 3, acc, False
        return sq, -1, False

    def huf_weights(self, tree_pos: int, tab: list) -> tuple[list, int, bool]:
        """The tree at ``tree_pos`` -> (weights incl. the implied last one,
        tree bytes, err); FSE-coded weights use ``tab[TAB_W:]``."""
        getb = self.getb
        thdr = getb(tree_pos)
        w = [0] * 288
        if thdr >= 128:                                # direct 4-bit weights
            n = thdr - 127
            for i in range(n):
                by = getb(tree_pos + 1 + (i >> 1))
                w[i] = by >> 4 if i % 2 == 0 else by & 0xF
            tree_bytes = 1 + ((n + 1) >> 1)
        else:                                          # FSE-coded, two states
            acc, bp, norm, e = self.read_ncount((tree_pos + 1) * 8, 32)
            if e or acc > 6:
                return w, 0, True
            _fse_build(tab, norm, len(norm), acc, TAB_W)
            start = (bp + 7) >> 3
            base, left, e = self.bwd_init(start, tree_pos + 1 + thdr - start)
            s0, left = self.bwd_read(base, left, acc)
            s1, left = self.bwd_read(base, left, acc)
            if e or left < 0:
                return w, 0, True
            n = 0
            while n < 255:
                ent = tab[TAB_W + s0]
                w[n] = ent & 0xFF
                v, left = self.bwd_read(base, left, (ent >> 8) & 0xFF)
                n += 1
                if left < 0:                           # emit the other state, stop
                    w[n] = tab[TAB_W + s1] & 0xFF
                    n += 1
                    break
                s0 = ((ent >> 16) & 0xFFFF) + v
                ent = tab[TAB_W + s1]
                w[n] = ent & 0xFF
                v, left = self.bwd_read(base, left, (ent >> 8) & 0xFF)
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

    def huf_stream(self, huf: list, start: int, nbytes: int, count: int, lit, dst: int,
                   mb: int) -> bool:
        """One backward Huffman stream of ``count`` symbols into
        ``lit[dst:dst + count]``; -> err."""
        base, left, e = self.bwd_init(start, nbytes)
        if e:
            return True
        row = self.row
        for i in range(count):
            nn = min(max(left, 0), mb)
            pos = base + max(left - mb, 0)
            p = pos >> 3
            v = (int.from_bytes(row[p:p + 5], "little") >> (pos & 7)) & ((1 << nn) - 1)
            ent = huf[v << (mb - nn)]
            nb = ent & 0xFF
            if nb == 0:
                return True
            lit[dst + i] = ent >> 8
            left -= nb
            if left < 0:
                return True
        return left != 0

    def literals(self, pos: int, block_end: int):
        """The literals section header at ``pos`` -> (type, size format,
        regenerated size, first byte after the header, the section's end)."""
        getb = self.getb
        lsh = getb(pos)
        lit_type, fmt = lsh & 3, (lsh >> 2) & 3
        if lit_type <= 1:                              # raw / RLE
            hdr = 2 if fmt == 1 else 3 if fmt == 3 else 1
            regen = ((lsh >> 4) | (getb(pos + 1) << 4) if fmt == 1 else
                     (lsh >> 4) | (getb(pos + 1) << 4) | (getb(pos + 2) << 12) if fmt == 3
                     else lsh >> 3)
            return lit_type, fmt, regen, pos + hdr, pos + hdr + (regen if lit_type == 0 else 1)
        hdr, nbits = (3, 10) if fmt <= 1 else (4, 14) if fmt == 2 else (5, 18)
        w40 = (getb(pos) | (getb(pos + 1) << 8) | (getb(pos + 2) << 16)
               | (getb(pos + 3) << 24) | (getb(pos + 4) << 32))
        mask = (1 << nbits) - 1
        regen, cs = (w40 >> 4) & mask, (w40 >> (4 + nbits)) & mask
        return lit_type, fmt, regen, pos + hdr, pos + hdr + cs

    def nseq(self, lit_end: int) -> tuple[int, int]:
        """The sequence count at ``lit_end`` -> (nseq, the byte after it)."""
        getb = self.getb
        b0 = getb(lit_end)
        if b0 < 128:
            return b0, lit_end + 1
        if b0 < 255:
            return ((b0 - 128) << 8) + getb(lit_end + 1), lit_end + 2
        return getb(lit_end + 1) + (getb(lit_end + 2) << 8) + 0x7F00, lit_end + 3

    def frame_start(self, csize: int) -> int:
        """The first block's position, or -1 for a header the decoder refuses
        (size, magic, reserved bit, dictionary ID)."""
        getb = self.getb
        magic = getb(0) | (getb(1) << 8) | (getb(2) << 16) | (getb(3) << 24)
        fhd = getb(4)
        if csize < 5 or magic != MAGIC or (fhd >> 3) & 1 or fhd & 3:
            return -1
        single = (fhd >> 5) & 1
        return 5 + (1 - single) + (single, 2, 4, 8)[fhd >> 6]

    def block_header(self, pos: int) -> tuple[bool, int, int]:
        """-> (last, type, size) of the 3-byte block header at ``pos``."""
        bh = self.getb(pos) | (self.getb(pos + 1) << 8) | (self.getb(pos + 2) << 16)
        return bool(bh & 1), (bh >> 1) & 3, bh >> 3


def huf_build(w: list, huf: list) -> tuple[int, bool]:
    """Weights -> the single-level table in ``huf``; (max_bits, err)."""
    total = sum(1 << (min(x, 12) - 1) for x in w if x > 0)
    max_bits = _bitlen(total, 20) - 1
    if max_bits < 1 or max_bits > 11:
        return max_bits, True
    size = 1 << max_bits
    huf[:] = [0] * HUF_CAP
    p = 0
    for wt in range(1, 13):                            # ascending weight, then symbol
        run = 1 << (wt - 1)
        ent = max_bits + 1 - wt
        for s, x in enumerate(w):
            if x == wt:
                if p + run <= size:
                    huf[p:p + run] = [(s << 8) | ent] * run
                p += run
    return max_bits, p != size


def huf_literals(R: Row, huf: list, fmt: int, regen: int, spos: int, lit_end: int, lit,
                 dst: int, hbits: int) -> bool:
    """Huffman-coded literals in one stream or four (the jump table at
    ``spos``) into ``lit[dst:dst + regen]``; -> err."""
    if fmt == 0:
        return R.huf_stream(huf, spos, lit_end - spos, regen, lit, dst, hbits)
    getb = R.getb
    j1 = getb(spos) | (getb(spos + 1) << 8)
    j2 = getb(spos + 2) | (getb(spos + 3) << 8)
    j3 = getb(spos + 4) | (getb(spos + 5) << 8)
    sbase = spos + 6
    j4 = lit_end - sbase - j1 - j2 - j3
    per = (regen + 3) >> 2
    cl = regen - 3 * per
    if j4 <= 0 or cl < 0:
        return True
    for k, (start, nb, count) in enumerate((
            (sbase, j1, per), (sbase + j1, j2, per),
            (sbase + j1 + j2, j3, per), (sbase + j1 + j2 + j3, j4, cl))):
        if R.huf_stream(huf, start, nb, count, lit, dst + k * per, hbits):
            return True
    return False


def _decode_chunk(row: bytes, csize: int, out_cap: int, lit_cap: int,
                  trace: dict | None = None) -> tuple[bytearray, int, int]:
    """The walk: one frame -> (output row of out_cap bytes, size, status).
    ``row`` is the chunk's whole row of ``comp_cap`` bytes.  With ``trace``,
    it records ``(op, r0, r1, r2)`` at each block of nonzero size under
    ``"blocks"`` and each sequence's offset under ``"offs"``."""
    R = Row(row)
    getb = R.getb
    tab = [0] * FSE_TOTAL
    huf = [0] * HUF_CAP
    lit = bytearray(lit_cap)
    out = bytearray(out_cap)
    fail = bytearray(out_cap), 0, int(Status.ERROR_CANNOT_DECOMPRESS)
    pos = R.frame_start(csize)
    if pos < 0:
        return fail
    # the predefined tables, so that repeat mode in the first block resolves
    accs = {name: R.seq_table(tab, name, 0, 0)[1] for name in _PREDEF}
    op, done, r0, r1, r2, hbits = 0, False, 1, 4, 8, 0

    def emit(src: bytes | bytearray, n: int) -> None:
        if op + n <= out_cap:
            out[op:op + n] = src

    while not done and pos + 3 <= csize:
        done, btype, bsize = R.block_header(pos)
        pos += 3
        if btype == 3 or bsize > BLOCK_CAP:
            return fail
        if trace is not None and (btype == 2 or bsize):
            trace["blocks"].append((op, r0, r1, r2))
        if btype == 0:                                 # raw
            if pos + bsize > csize:
                return fail
            emit(R.span(pos, bsize), bsize)
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
        lit_type, fmt, regen, spos, lit_end = R.literals(pos, block_end)
        if regen > lit_cap or lit_end > block_end:
            return fail
        if lit_type == 0:
            lit[:regen] = R.span(spos, regen)
        elif lit_type == 1:
            lit[:regen] = bytes([getb(spos)]) * regen
        else:                                          # Huffman / treeless
            if lit_type == 3:
                if hbits == 0:
                    return fail
            else:
                w, tree_bytes, e = R.huf_weights(spos, tab)
                if e:
                    return fail
                hbits, e = huf_build(w, huf)
                if e:
                    return fail
                spos += tree_bytes
            if huf_literals(R, huf, fmt, regen, spos, lit_end, lit, 0, hbits):
                return fail
        # -- sequences section
        nseq, sq = R.nseq(lit_end)
        lit_pos = 0
        if nseq > 0:
            scm = getb(sq)
            sq += 1
            if scm & 3:
                return fail
            for name, shift in (("ll", 6), ("of", 4), ("ml", 2)):
                sq, acc, e = R.seq_table(tab, name, (scm >> shift) & 3, sq)
                if e:
                    return fail
                if acc >= 0:
                    accs[name] = acc
            base, left, e = R.bwd_init(sq, block_end - sq)
            ll_s, left = R.bwd_read(base, left, accs["ll"])
            of_s, left = R.bwd_read(base, left, accs["of"])
            ml_s, left = R.bwd_read(base, left, accs["ml"])
            if e or left < 0:
                return fail
            for i in range(nseq):
                ll_e, of_e, ml_e = tab[TAB_LL + ll_s], tab[TAB_OF + of_s], tab[TAB_ML + ml_s]
                of_sym = of_e & 0xFF
                if of_sym > 30:
                    return fail
                ofb, left = R.bwd_read(base, left, of_sym)
                ofv = (1 << of_sym) + ofb
                mbase, mnb = _ML[min(ml_e & 0xFF, 52)]
                mlb, left = R.bwd_read(base, left, mnb)
                ml = mbase + mlb
                lbase, lnb = _LL[min(ll_e & 0xFF, 35)]
                llb, left = R.bwd_read(base, left, lnb)
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
                if trace is not None:
                    trace["offs"].append(off)
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
                    v, left = R.bwd_read(base, left, lnb2 + mnb2 + onb2)
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


def _passes(comp: torch.Tensor, comp_sizes: torch.Tensor, out_cap: int, lit_cap: int):
    if comp.device.type != "cuda":
        raise ValueError(f"the Zstandard decode kernels need CUDA tensors, got {comp.device}")
    from tpucomp_torch.ops.cuda import zstd_passes
    return zstd_passes.run(comp, comp_sizes, out_cap, lit_cap)


def decompress_batch(comp: torch.Tensor, comp_sizes: torch.Tensor, out_cap: int):
    """Row 18: the chunk-resident wrapper's ``lit_cap`` through the
    block-parallel passes of :mod:`tpucomp_torch.ops.cuda.zstd_passes` on
    ``comp``'s card, on the current stream.  It reads the scratch sizes to
    the host once, so the call waits for the work queued before it.  Raises
    for tensors that are not on a CUDA device."""
    r = _passes(comp, comp_sizes, out_cap, lit_cap_of(out_cap, big=False))
    decompress_batch.launches += 1
    return r


def decompress_batch_big(comp: torch.Tensor, comp_sizes: torch.Tensor, out_cap: int):
    """Row 19: the same passes with the 16 MiB regime's ``lit_cap`` (128 KiB)."""
    r = _passes(comp, comp_sizes, out_cap, lit_cap_of(out_cap, big=True))
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
