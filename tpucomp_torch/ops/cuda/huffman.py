"""Canonical Huffman decode tables: the plain version of ``csrc/huffman.cuh``.

Port of :mod:`tpucomp.ops.pallas.huffman` (``make_table_builder``,
``make_code_reader``; no ``pallas_call`` of its own).  The serial GDeflate
decoder's kernel (``csrc/gdeflate_decode.cu``) includes the CUDA version, and
the Deflate decoder's kernel (``csrc/deflate_decode.cu``) builds the same
tables with a warp; the plain Deflate decoder (:mod:`.deflate_decode`) calls
the two functions here.  Both follow
the reference step for step, because statuses on corrupt input depend on it:

* the table is the classic inflate two-level table, filled incrementally in
  canonical (length, symbol) order, a subtable opened when a code longer
  than ``root`` enters fresh low ``root`` bits, sized by the remaining
  counts;
* entries pack a leaf ``(sym << 8) | bits``, a link ``SUB_FLAG | (offset <<
  8) | sub_bits``; an uncovered slot stays 0 and reads as invalid when hit,
  so an incomplete code is accepted until such a slot is reached (zlib's
  tolerance of a lone distance code);
* errors: an over-subscribed code (``left < 0`` at some length) and a table
  that outgrows ``enough`` entries.
"""
from __future__ import annotations

SUB_FLAG = 1 << 30


def build_table(tab: list, lens: list, work: list, cnt: list, ofs: list,
                base: int, nsym: int, root: int, tbase: int, enough: int) -> bool:
    """Build the decode table for ``lens[base:base + nsym]`` into
    ``tab[tbase:tbase + enough]`` (``work``/``cnt``/``ofs`` are scratch of
    320/16/16 entries).  Returns True on error."""
    tab[tbase:tbase + enough] = [0] * enough
    cnt[:] = [0] * 16
    for i in range(nsym):
        cnt[lens[base + i]] += 1
    maxl, minl, left, err = 0, 16, 1, False
    for l in range(1, 16):
        c = cnt[l]
        if c > 0:
            maxl = l
            if minl == 16:
                minl = l
        left = (left << 1) - c
        err = err or left < 0
    ofs[1] = 0
    for l in range(1, 15):
        ofs[l + 1] = ofs[l] + cnt[l]
    for i in range(nsym):
        l = lens[base + i]
        if l > 0:
            work[ofs[l]] = i
            ofs[l] += 1
    if maxl == 0 or err:
        return err

    mask = (1 << root) - 1
    sym, ln, huff, nxt, curr, drop, low = 0, minl, 0, tbase, root, 0, -1
    used = 1 << root
    while ln <= maxl:
        if ln > root and (huff & mask) != low:
            drop = root
            nxt += 1 << curr
            curr, lft = ln - drop, 1 << (ln - drop)
            while curr + drop < maxl and lft > 0:     # grow until the rest fits
                lft -= cnt[curr + drop]
                if lft > 0:
                    curr += 1
                    lft <<= 1
            used += 1 << curr
            if used > enough:
                return True
            low = huff & mask
            tab[tbase + low] = SUB_FLAG | ((nxt - tbase) << 8) | curr
        entry = (work[sym] << 8) | (ln - drop)
        incr = 1 << (ln - drop)
        hofs = nxt + (huff >> drop)
        f = 1 << curr
        while f > 0:
            f -= incr
            tab[hofs + f] = entry
        inc = 1 << (ln - 1)             # huff += 1, bit-reversed at width ln
        while huff & inc:
            inc >>= 1
        huff = (huff & (inc - 1)) + inc if inc else 0
        sym += 1
        cnt[ln] -= 1
        if cnt[ln] == 0:
            ln = 16 if ln == maxl else lens[base + work[sym]]
    return False


def read_code(tab: list, peek, tbase: int, root: int) -> tuple[int, int, bool]:
    """Decode one symbol -> ``(sym, nbits, invalid)``; ``peek(n)`` gives the
    next ``n`` unconsumed bits, LSB first, without consuming them."""
    e = tab[tbase + peek(root)]
    drop = 0
    if e & SUB_FLAG:
        v2 = peek(root + (e & 0xFF)) >> root
        e = tab[tbase + ((e >> 8) & 0xFFFF) + v2]
        drop = root
    nb = e & 0xFF
    return e >> 8, drop + nb, nb == 0
