"""Zstandard frame decode as block-parallel passes: the Hopper kernels behind
:func:`tpucomp_torch.ops.cuda.zstd_decode.decompress_batch_big` (row 19) and
their plain versions.

The reference decodes a frame on the TPU's scalar core, one frame a grid
step, block after block (``tpucomp/ops/pallas/zstd_decode.py:109``).  A
frame's blocks depend on each other only through a few small things: the
block positions (the 3-byte headers), the tables a repeat mode or a
treeless block reads, the three repeat offsets, and the output position.
So the decode runs as passes, each a kernel of ``csrc/zstd_passes.cu``
(its header says how each meets the bound) beside its plain version here:

1. :func:`chain` (one thread a frame) walks the block headers and counts
   the blocks, sequences and literals each frame needs; its last CTA sums
   them into each frame's bases and the totals, which the wrapper reads to
   the host (the pipeline's one host read) to size the scratch.
   :func:`fill` walks again and writes one record a block: positions, the
   literals and sequences headers, the blocks whose tables and Huffman tree
   a repeat reads, and the block's scratch offsets.
2. :func:`entropy` (one CTA a compressed block): the block's tables,
   rebuilt from the block that defined them, its literals into the literal
   scratch, its sequences as ``(lit_pos, out_pos, ll, ml, offset code)``
   with repeat offsets kept symbolic (a concrete offset, or "incoming r_j
   minus d"), the block's output size, its outgoing repeat offsets in the
   same code, its errors.
3. :func:`scan` (one thread a frame): each block's output start and
   incoming repeat offsets, the frame's size and status.
4. :func:`resolve` (one CTA a block): every offset made concrete and held
   against the frame-global output position.
5. :func:`settle`: a frame whose smallest possible output already passes
   ``out_cap`` can only end ``ERROR_CANNOT_DECOMPRESS`` or
   ``ERROR_OUTPUT_BUFFER_TOO_SMALL``; the frame walk (``csrc/zstd_decode.cu``,
   one warp a frame) settles which, writing the status alone: no output, no
   scratch.  Such frames never get records, so the scratch of a frame stays
   below its ``out_cap``.
6. :func:`zero` writes the sizes and statuses and zeroes each row past its
   size; :func:`execute` (one CTA a block; in ticket order where a frame has
   more than one) writes the output of every frame that succeeded.

Run together (:func:`run`), the passes give the walk's outputs, statuses
included.  Contract: as :mod:`tpucomp_torch.ops.cuda.zstd_decode`'s.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpucomp_torch.constants import Status
from tpucomp_torch.ops.cuda import _build
from tpucomp_torch.ops.cuda.zstd_decode import (_LL, _ML, _PREDEF, BLOCK_CAP, FSE_TOTAL, HUF_CAP,
                                                TAB_LL, TAB_ML, TAB_OF, Row, _decode_chunk,
                                                huf_build, huf_literals)

# a block record: int64[16]
(F_FRAME, F_TYPE, F_POS, F_BSIZE, F_REGEN, F_SPOS, F_LIT_END, F_NSEQ, F_SQ, F_SRC_LL, F_SRC_OF,
 F_SRC_ML, F_SRC_HUF, F_LIT_OFF, F_SEQ_OFF, F_LOCAL) = range(16)
NF = 16
# a sequence: int32[5]
S_LPOS, S_OPOS, S_LL, S_ML, S_OFF = range(5)
NS = 5
OVERFLOW = 1              # chain status: the smallest output passes out_cap; settle decides
INT32_MAX = (1 << 31) - 1
IDENT = (-1, -2, -3)      # the codes of the incoming r0, r1, r2
CANNOT = int(Status.ERROR_CANNOT_DECOMPRESS)
TOO_SMALL = int(Status.ERROR_OUTPUT_BUFFER_TOO_SMALL)


def _dec(c: int) -> int:
    """The code of ``r - 1`` for the offset of code ``c``."""
    return c - 1 if c > 0 else c - 4


def _value(c: int, rep) -> int:
    """The offset of code ``c`` given the incoming repeat offsets ``rep``:
    ``c > 0`` is itself; ``c = -1 - (j + 4 d)`` is ``rep[j] - d``."""
    if c > 0:
        return c
    k = -1 - c
    return rep[k & 3] - (k >> 2)


# =====================================================================================
# plain versions (host; the kernels compute the same)
# =====================================================================================

def _chain_frame(R: Row, csize: int, out_cap: int, lit_cap: int, f: int = 0, base=None,
                 recs: list | None = None) -> tuple[int, int, int, int]:
    """The block chain of one frame -> (blocks, sequences, literals, status:
    0, ``OVERFLOW`` or 12); with ``recs``, append its records, global
    indices and offsets from ``base = (first block, first seq, first lit)``.
    Raw and RLE blocks of size 0 write nothing and get no record."""
    b0, s0, l0 = base if base is not None else (0, 0, 0)
    pos = R.frame_start(csize)
    if pos < 0:
        return 0, 0, 0, CANNOT
    getb = R.getb
    nblk = nseq_t = nlit = minout = 0
    tree, src = -1, [-1, -1, -1]
    done = False
    while not done and pos + 3 <= csize:
        done, btype, bsize = R.block_header(pos)
        pos += 3
        if btype == 3 or bsize > BLOCK_CAP:
            return 0, 0, 0, CANNOT
        rec = None
        if btype <= 1:                                  # raw, RLE
            if pos + (bsize if btype == 0 else 1) > csize:
                return 0, 0, 0, CANNOT
            if bsize:
                rec = [f, btype, pos, bsize, 0, 0, 0, 0, 0, -1, -1, -1, -1, 0, 0, nblk]
            minout += bsize
            pos += bsize if btype == 0 else 1
        else:
            block_end = pos + bsize
            if block_end > csize:
                return 0, 0, 0, CANNOT
            lit_type, _, regen, spos, lit_end = R.literals(pos, block_end)
            if regen > lit_cap or lit_end > block_end or (lit_type == 3 and tree < 0):
                return 0, 0, 0, CANNOT
            me = b0 + nblk
            if lit_type == 2:
                tree = me
            nseq, sq = R.nseq(lit_end)
            srcs = [-1, -1, -1]
            if nseq > 0:
                scm = getb(sq)
                if scm & 3:
                    return 0, 0, 0, CANNOT
                for t in range(3):
                    if (scm >> (6 - 2 * t)) & 3 == 3:
                        srcs[t] = src[t]
                    else:
                        srcs[t] = src[t] = me
            rec = [f, 2 | (lit_type << 2), pos, bsize, regen, spos, lit_end, nseq, sq, *srcs,
                   tree if lit_type >= 2 else -1, l0 + nlit, s0 + nseq_t, nblk]
            minout += regen + 3 * nseq
            nlit += regen
            nseq_t += nseq
            pos = block_end
        if rec is not None:
            if recs is not None:
                recs.append(rec)
            nblk += 1
    if not done:
        return 0, 0, 0, CANNOT
    if minout > out_cap:
        return 0, 0, 0, OVERFLOW
    return nblk, nseq_t, nlit, 0


def _rows(comp: torch.Tensor, comp_sizes: torch.Tensor):
    data = comp.cpu().numpy()
    return data, comp_sizes.cpu().numpy().astype(np.int64)


def chain_plain(comp: torch.Tensor, comp_sizes: torch.Tensor, out_cap: int, lit_cap: int):
    """Pass 1a -> (counts ``int64[B, 4]``: blocks, sequences, literals, chain
    status; and :func:`bases_of` them)."""
    data, sizes = _rows(comp, comp_sizes)
    fc = np.zeros((data.shape[0], 4), np.int64)
    for f in range(data.shape[0]):
        fc[f] = _chain_frame(Row(data[f].tobytes()), int(sizes[f]), out_cap, lit_cap)
    fcount = torch.from_numpy(fc)
    return (fcount, *bases_of(fcount))


def bases_of(fcount: torch.Tensor) -> tuple[torch.Tensor, list[int]]:
    """Each frame's first block, sequence and literal (``int64[B, 3]``, on
    the counts' device) and ``[blocks, sequences, literals, frames to
    settle, the most blocks a frame has]``: the plain version of the chain
    kernel's tally."""
    csum = torch.cumsum(fcount[:, :3], 0)
    bases = csum - fcount[:, :3]
    if not fcount.shape[0]:
        return bases, [0] * 5
    more = torch.stack([(fcount[:, 3] == OVERFLOW).sum(), fcount[:, 0].max()])
    return bases, [int(v) for v in torch.cat([csum[-1], more]).cpu()]


def fill_plain(comp: torch.Tensor, comp_sizes: torch.Tensor, out_cap: int, lit_cap: int,
               fcount: torch.Tensor, bases: torch.Tensor, nblk: int) -> torch.Tensor:
    """Pass 1b: the block records, ``int64[nblk, 16]``."""
    data, sizes = _rows(comp, comp_sizes)
    recs: list = []
    for f in range(data.shape[0]):
        if int(fcount[f, 3]) == 0:
            _chain_frame(Row(data[f].tobytes()), int(sizes[f]), out_cap, lit_cap, f,
                         [int(v) for v in bases[f]], recs)
    assert len(recs) == nblk
    return torch.tensor(recs, dtype=torch.int64).reshape(nblk, NF)


def _source_table(R: Row, srec, t: int, tab: list) -> tuple[int, bool]:
    """Table ``t`` (0 LL, 1 OF, 2 ML) as block ``srec`` defined it: its
    descriptions before ``t`` skipped, then ``t`` built -> (acc, err)."""
    sq = int(srec[F_SQ])
    scm = R.getb(sq)
    sq += 1
    for u, name in enumerate(("ll", "of", "ml")):
        mode = (scm >> (6 - 2 * u)) & 3
        if u == t:
            _, acc, e = R.seq_table(tab, name, mode, sq)
            return acc, e
        if mode == 1:
            sq += 1
        elif mode == 2:
            _, bp, _, e = R.read_ncount(sq * 8, _PREDEF[name][3])
            if e:
                return 0, True
            sq = (bp + 7) >> 3
    raise AssertionError(t)


def _entropy_block(R: Row, blk: np.ndarray, b: int, lits: np.ndarray,
                   seqs: np.ndarray) -> tuple[int, tuple, bool]:
    """Pass 2 on block ``b`` -> (output size, outgoing repeat-offset codes,
    err); writes its literals and sequences."""
    rec = blk[b]
    btype, lit_type = int(rec[F_TYPE]) & 3, (int(rec[F_TYPE]) >> 2) & 3
    if btype != 2:
        return int(rec[F_BSIZE]), IDENT, False
    pos, bsize, regen, spos, lit_end, nseq, sq = (int(rec[k]) for k in (
        F_POS, F_BSIZE, F_REGEN, F_SPOS, F_LIT_END, F_NSEQ, F_SQ))
    lo, so = int(rec[F_LIT_OFF]), int(rec[F_SEQ_OFF])
    block_end = pos + bsize
    getb = R.getb
    lit = bytearray(regen)
    err = False
    # -- literals
    if lit_type == 0:
        lit[:] = R.span(spos, regen)
    elif lit_type == 1:
        lit[:] = bytes([getb(spos)]) * regen
    else:
        tab = [0] * FSE_TOTAL
        huf = [0] * HUF_CAP
        w, tree_bytes, e = R.huf_weights(int(blk[int(rec[F_SRC_HUF]), F_SPOS]), tab)
        hbits = 0
        if not e:
            hbits, e = huf_build(w, huf)
        err = e or huf_literals(R, huf, (getb(pos) >> 2) & 3, regen,
                                spos + (tree_bytes if lit_type == 2 else 0), lit_end, lit, 0,
                                hbits)
    # -- sequences
    mlsum, sym = 0, IDENT
    rows = []
    if nseq > 0:
        tab = [0] * FSE_TOTAL
        accs = [0, 0, 0]
        scm = getb(sq)
        q = sq + 1
        for t, name in enumerate(("ll", "of", "ml")):
            mode = (scm >> (6 - 2 * t)) & 3
            if mode == 3:
                s = int(rec[F_SRC_LL + t])
                if s < 0:
                    _, accs[t], e = R.seq_table(tab, name, 0, 0)
                else:
                    accs[t], e = _source_table(R, blk[s], t, tab)
            else:
                q, accs[t], e = R.seq_table(tab, name, mode, q)
            if e:
                err = True
                break
        if not err:
            err, mlsum, sym, rows = _sequences(R, tab, accs, q, block_end, nseq, regen)
    if err:
        return 0, IDENT, True
    lits[lo:lo + regen] = np.frombuffer(bytes(lit), np.uint8)
    if rows:
        seqs[so:so + nseq] = np.array(rows, np.int32)
    return regen + mlsum, sym, False


def _sequences(R: Row, tab: list, accs: list, sq: int, block_end: int, nseq: int,
               regen: int):
    """The sequence walk of one block with symbolic repeat offsets ->
    (err, sum of match lengths, outgoing codes, rows)."""
    base, left, e = R.bwd_init(sq, block_end - sq)
    ll_s, left = R.bwd_read(base, left, accs[0])
    of_s, left = R.bwd_read(base, left, accs[1])
    ml_s, left = R.bwd_read(base, left, accs[2])
    if e or left < 0:
        return True, 0, IDENT, []
    r0, r1, r2 = IDENT
    lit_pos = op = mlsum = 0
    rows = []
    rd = R.bwd_read
    for i in range(nseq):
        ll_e, of_e, ml_e = tab[TAB_LL + ll_s], tab[TAB_OF + of_s], tab[TAB_ML + ml_s]
        of_sym = of_e & 0xFF
        if of_sym > 30:
            return True, 0, IDENT, []
        ofb, left = rd(base, left, of_sym)
        ofv = (1 << of_sym) + ofb
        mbase, mnb = _ML[min(ml_e & 0xFF, 52)]
        mlb, left = rd(base, left, mnb)
        ml = mbase + mlb
        lbase, lnb = _LL[min(ll_e & 0xFF, 35)]
        llb, left = rd(base, left, lnb)
        ll = lbase + llb
        if left < 0:
            return True, 0, IDENT, []
        if ofv <= 3:                                   # repeat offsets, as codes
            ridx = ofv - 1 + (ll == 0)
            off = (r0, r1, r2, _dec(r0))[ridx]
            if ridx > 0:
                r0, r1, r2 = off, r0, (r1 if ridx >= 2 else r2)
        else:
            off = ofv - 3
            r0, r1, r2 = off, r0, r1
        if off == 0 or lit_pos + ll > regen:           # a concrete offset of 0
            return True, 0, IDENT, []
        rows.append((lit_pos, min(op, INT32_MAX), ll, ml, off))
        lit_pos += ll
        op += ll + ml
        mlsum += ml
        if i + 1 < nseq:                               # state updates: ll, ml, of
            lnb2, mnb2, onb2 = (ll_e >> 8) & 0xFF, (ml_e >> 8) & 0xFF, (of_e >> 8) & 0xFF
            v, left = rd(base, left, lnb2 + mnb2 + onb2)
            ll_s = ((ll_e >> 16) & 0xFFFF) + (v >> (mnb2 + onb2))
            ml_s = ((ml_e >> 16) & 0xFFFF) + ((v >> onb2) & ((1 << mnb2) - 1))
            of_s = ((of_e >> 16) & 0xFFFF) + (v & ((1 << onb2) - 1))
            if left < 0:
                return True, 0, IDENT, []
    if left != 0:
        return True, 0, IDENT, []
    return False, mlsum, (r0, r1, r2), rows


def entropy_plain(comp: torch.Tensor, blk: torch.Tensor, nlit: int, nseq: int):
    """Pass 2 -> (literals ``uint8[nlit]``, sequences ``int32[nseq, 5]``,
    block output sizes ``int64[nblk]``, outgoing codes ``int32[nblk, 3]``,
    errors ``int32[nblk]``).  A block in error leaves its literals and
    sequences zero, its size 0 and its codes ``IDENT``."""
    data = comp.cpu().numpy()
    blk_np = blk.cpu().numpy()
    n = blk_np.shape[0]
    lits = np.zeros(nlit, np.uint8)
    seqs = np.zeros((nseq, NS), np.int32)
    bout = np.zeros(n, np.int64)
    bsym = np.zeros((n, 3), np.int32)
    berr = np.zeros(n, np.int32)
    rows: dict = {}
    for b in range(n):
        f = int(blk_np[b, F_FRAME])
        if f not in rows:
            rows[f] = Row(data[f].tobytes())
        bout[b], bsym[b], e = _entropy_block(rows[f], blk_np, b, lits, seqs)
        berr[b] = int(e)
    return (torch.from_numpy(lits), torch.from_numpy(seqs), torch.from_numpy(bout),
            torch.from_numpy(bsym), torch.from_numpy(berr))


def scan_plain(fcount: torch.Tensor, bases: torch.Tensor, bout: torch.Tensor,
               bsym: torch.Tensor, berr: torch.Tensor, out_cap: int):
    """Pass 3 -> (block output starts ``int64[nblk]``, incoming repeat
    offsets ``int64[nblk, 3]``, frame sizes ``int64[B]``, statuses
    ``int32[B]``: the chain's 12 and ``OVERFLOW``, else 12 for an error in a
    block, 15 for a frame past ``out_cap``, 0)."""
    fc, bs = fcount.cpu().numpy(), bases.cpu().numpy()
    bo, sy, be = bout.cpu().numpy(), bsym.cpu().numpy(), berr.cpu().numpy()
    n, B = bo.shape[0], fc.shape[0]
    bstart = np.zeros(n, np.int64)
    bin_ = np.zeros((n, 3), np.int64)
    fsize = np.zeros(B, np.int64)
    fstat = np.zeros(B, np.int32)
    for f in range(B):
        if fc[f, 3]:
            fstat[f] = fc[f, 3]
            continue
        s, rep, err = 0, (1, 4, 8), False
        for b in range(int(bs[f, 0]), int(bs[f, 0] + fc[f, 0])):
            bstart[b], bin_[b] = s, rep
            s += int(bo[b])
            err |= bool(be[b])
            rep = tuple(_value(int(c), rep) for c in sy[b])
        fsize[f] = s
        fstat[f] = CANNOT if err else TOO_SMALL if s > out_cap else 0
    return (torch.from_numpy(bstart), torch.from_numpy(bin_), torch.from_numpy(fsize),
            torch.from_numpy(fstat))


def resolve_plain(blk: torch.Tensor, seqs: torch.Tensor, bstart: torch.Tensor,
                  bin_: torch.Tensor, fstat: torch.Tensor):
    """Pass 4 -> (concrete offsets ``int32[nseq]``, 0 where an offset is
    not positive; statuses with 12 for a frame where an offset is not
    positive or reaches before the frame's first byte).  Blocks of frames
    whose status is neither 0 nor 15 are skipped."""
    rec, sq = blk.cpu().numpy(), seqs.cpu().numpy()
    bst, bi = bstart.cpu().numpy(), bin_.cpu().numpy()
    st_in = fstat.cpu().numpy()
    st = st_in.copy()
    offs = np.zeros(sq.shape[0], np.int32)
    for b in range(rec.shape[0]):
        f = int(rec[b, F_FRAME])
        if int(rec[b, F_TYPE]) & 3 != 2 or st_in[f] not in (0, TOO_SMALL):
            continue
        rep = [int(v) for v in bi[b]]
        s0 = int(rec[b, F_SEQ_OFF])
        for s in range(s0, s0 + int(rec[b, F_NSEQ])):
            off = _value(int(sq[s, S_OFF]), rep)
            if off <= 0 or off > int(bst[b]) + int(sq[s, S_OPOS]) + int(sq[s, S_LL]):
                st[f] = CANNOT
            offs[s] = max(off, 0)
    return torch.from_numpy(offs), torch.from_numpy(st)


def settle_plain(comp: torch.Tensor, comp_sizes: torch.Tensor, out_cap: int, lit_cap: int,
                 fstat: torch.Tensor) -> torch.Tensor:
    """Pass 5: the walk's status (12 or 15) for each ``OVERFLOW`` frame."""
    data, sizes = _rows(comp, comp_sizes)
    st = fstat.cpu().numpy().copy()
    for f in np.nonzero(st == OVERFLOW)[0]:
        st[f] = _decode_chunk(data[f].tobytes(), int(sizes[f]), out_cap, lit_cap)[2]
    return torch.from_numpy(st)


def zero_plain(fstat: torch.Tensor, fsize: torch.Tensor, out_cap: int):
    """Pass 6a -> (zero rows ``uint8[B, out_cap]``, sizes, statuses)."""
    st = fstat.cpu().to(torch.int32)
    osz = torch.where(st == 0, fsize.cpu(), 0).to(torch.int32)
    return torch.zeros((st.shape[0], out_cap), dtype=torch.uint8), osz, st


def execute_plain(comp: torch.Tensor, blk: torch.Tensor, lits: torch.Tensor,
                  seqs: torch.Tensor, offs: torch.Tensor, bstart: torch.Tensor,
                  bout: torch.Tensor, fstat: torch.Tensor, out: torch.Tensor,
                  multi: bool = True) -> torch.Tensor:
    """Pass 6b: the output of every block of a frame with status 0, into a
    copy of ``out`` (literal runs, matches byte-serial, raw and RLE blocks),
    block after block (``multi``, the kernel's ticket order, changes no byte)."""
    data = comp.cpu().numpy()
    rec, sq, of = blk.cpu().numpy(), seqs.cpu().numpy(), offs.cpu().numpy()
    lit, bst, bo = lits.cpu().numpy().tobytes(), bstart.cpu().numpy(), bout.cpu().numpy()
    st = fstat.cpu().numpy()
    res = out.cpu().numpy().copy()
    rows: dict = {}
    for b in range(rec.shape[0]):
        f = int(rec[b, F_FRAME])
        if st[f] != 0:
            continue
        if f not in rows:
            rows[f] = bytearray(res[f].tobytes())
        dst = rows[f]
        R = Row(data[f].tobytes())
        base, n = int(bst[b]), int(bo[b])
        btype, pos = int(rec[b, F_TYPE]) & 3, int(rec[b, F_POS])
        if btype == 0:
            dst[base:base + n] = R.span(pos, n)
            continue
        if btype == 1:
            dst[base:base + n] = bytes([R.getb(pos)]) * n
            continue
        lo, regen = int(rec[b, F_LIT_OFF]), int(rec[b, F_REGEN])
        s0 = int(rec[b, F_SEQ_OFF])
        lp = 0
        for s in range(s0, s0 + int(rec[b, F_NSEQ])):
            lpos, opos, ll, ml = (int(v) for v in sq[s, :4])
            off = int(of[s])
            q = base + opos
            dst[q:q + ll] = lit[lo + lpos:lo + lpos + ll]
            q += ll
            pat = dst[q - off:q]
            dst[q:q + ml] = (pat * (ml // off + 1))[:ml] if off < ml else pat[:ml]
            lp = lpos + ll
        rest = regen - lp                              # trailing literals
        dst[base + n - rest:base + n] = lit[lo + lp:lo + regen]
    for f, row in rows.items():
        res[f] = np.frombuffer(bytes(row), np.uint8)
    return torch.from_numpy(res)


PLAIN = {"chain": chain_plain, "fill": fill_plain, "entropy": entropy_plain, "scan": scan_plain,
         "resolve": resolve_plain, "settle": settle_plain, "zero": zero_plain,
         "execute": execute_plain}


# =====================================================================================
# the kernels (CUDA tensors only)
# =====================================================================================

_P, _I = ctypes.c_void_p, ctypes.c_int


def _fn(name: str, argtypes: list, lib: str = "zstd_passes"):
    """The C entry point ``name`` of ``csrc/<lib>.cu``; each takes the
    stream last."""
    fn = getattr(_build.load(lib), name)
    fn.argtypes = [*argtypes, _P]
    fn.restype = _I
    return fn


def _on_card(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"the Zstandard {what} kernel needs CUDA tensors, got {x.device}")


def _call(what: str, wrapper, n: int, fn, *args) -> None:
    """Launch ``fn`` over ``n`` frames or blocks on the current stream and
    count it on ``wrapper``; with ``n == 0`` nothing launches or counts."""
    if n <= 0:
        return
    stream = torch.cuda.current_stream().cuda_stream
    rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"zstd {what} kernel launch failed: cudaError {rc}")
    wrapper.launches += 1


def _row_args(comp: torch.Tensor, comp_sizes: torch.Tensor):
    if comp.dtype != torch.uint8 or comp.dim() != 2:
        raise ValueError(f"comp must be uint8[B, cap], got {comp.dtype}{list(comp.shape)}")
    B = comp.shape[0]
    if comp_sizes.shape != (B,):
        raise ValueError(f"comp_sizes must be int32[{B}]")
    return (comp.contiguous(),
            comp_sizes.to(device=comp.device, dtype=torch.int32).contiguous())


def _chain_launch(comp, comp_sizes, out_cap, lit_cap, fcount, bases, blk, tally=None):
    """Count (``blk`` None) or fill; a fill with no block to write launches
    nothing."""
    fn = _fn("tpucomp_zstd_chain", [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P])
    n = comp.shape[0] if blk is None else min(comp.shape[0], blk.shape[0])
    with torch.cuda.device(comp.device):
        _call("chain", chain_kernel, n, fn, comp.data_ptr(), comp_sizes.data_ptr(),
              comp.shape[0], comp.shape[1], out_cap, lit_cap, fcount.data_ptr(),
              bases.data_ptr(), 0 if blk is None else blk.data_ptr(),
              0 if tally is None else tally.data_ptr())


def chain_kernel(comp, comp_sizes, out_cap: int, lit_cap: int):
    """Pass 1a on the card (one thread a frame) -> as :func:`chain_plain`:
    the kernel's last CTA computes the bases and the totals, and the totals
    come to the host (the pipeline's one host read)."""
    _on_card(comp, "chain")
    comp, comp_sizes = _row_args(comp, comp_sizes)
    B, dev = comp.shape[0], comp.device
    fcount = torch.empty((B, 4), dtype=torch.int64, device=dev)
    bases = torch.empty((B, 3), dtype=torch.int64, device=dev)
    tally = torch.zeros(6, dtype=torch.int64, device=dev)   # CTAs done, then the totals
    _chain_launch(comp, comp_sizes, out_cap, lit_cap, fcount, bases, None, tally)
    return fcount, bases, [int(v) for v in tally[1:].cpu()]


def fill_kernel(comp, comp_sizes, out_cap: int, lit_cap: int, fcount, bases, nblk: int):
    """Pass 1b on the card: the same kernel, writing the records."""
    _on_card(comp, "chain")
    comp, comp_sizes = _row_args(comp, comp_sizes)
    blk = torch.empty((nblk, NF), dtype=torch.int64, device=comp.device)
    _chain_launch(comp, comp_sizes, out_cap, lit_cap, fcount.contiguous(), bases.contiguous(),
                  blk)
    return blk


def entropy_kernel(comp, blk, nlit: int, nseq: int):
    """Pass 2 on the card (one CTA a block)."""
    _on_card(comp, "entropy")
    comp, blk = comp.contiguous(), blk.contiguous()
    dev, n = comp.device, blk.shape[0]
    lits = torch.empty(nlit, dtype=torch.uint8, device=dev)
    seqs = torch.empty((nseq, NS), dtype=torch.int32, device=dev)
    bout = torch.empty(n, dtype=torch.int64, device=dev)
    bsym = torch.empty((n, 3), dtype=torch.int32, device=dev)
    berr = torch.empty(n, dtype=torch.int32, device=dev)
    fn = _fn("tpucomp_zstd_entropy", [_P, _I, _P, _I, _P, _P, _P, _P, _P])
    with torch.cuda.device(dev):
        _call("entropy", entropy_kernel, n, fn, comp.data_ptr(), comp.shape[1], blk.data_ptr(),
              n, lits.data_ptr(), seqs.data_ptr(), bout.data_ptr(), bsym.data_ptr(),
              berr.data_ptr())
    return lits, seqs, bout, bsym, berr


def scan_kernel(fcount, bases, bout, bsym, berr, out_cap: int):
    """Pass 3 on the card (one thread a frame)."""
    _on_card(fcount, "scan")
    dev, B, n = fcount.device, fcount.shape[0], bout.shape[0]
    bstart = torch.empty(n, dtype=torch.int64, device=dev)
    bin_ = torch.empty((n, 3), dtype=torch.int64, device=dev)
    fsize = torch.empty(B, dtype=torch.int64, device=dev)
    fstat = torch.empty(B, dtype=torch.int32, device=dev)
    fn = _fn("tpucomp_zstd_scan", [_P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _P])
    with torch.cuda.device(dev):
        _call("scan", scan_kernel, B, fn, fcount.contiguous().data_ptr(),
              bases.contiguous().data_ptr(), B, bout.contiguous().data_ptr(),
              bsym.contiguous().data_ptr(), berr.contiguous().data_ptr(), out_cap,
              bstart.data_ptr(), bin_.data_ptr(), fsize.data_ptr(), fstat.data_ptr())
    return bstart, bin_, fsize, fstat


def resolve_kernel(blk, seqs, bstart, bin_, fstat):
    """Pass 4 on the card (one CTA a block)."""
    _on_card(blk, "resolve")
    offs = torch.empty(seqs.shape[0], dtype=torch.int32, device=blk.device)
    st = fstat.clone()
    fn = _fn("tpucomp_zstd_resolve", [_P, _I, _P, _P, _P, _P, _P, _P])
    with torch.cuda.device(blk.device):
        _call("resolve", resolve_kernel, blk.shape[0], fn, blk.contiguous().data_ptr(),
              blk.shape[0], seqs.contiguous().data_ptr(), bstart.contiguous().data_ptr(),
              bin_.contiguous().data_ptr(), fstat.contiguous().data_ptr(), st.data_ptr(),
              offs.data_ptr())
    return offs, st


def settle_kernel(comp, comp_sizes, out_cap: int, lit_cap: int, fstat):
    """Pass 5 on the card: the frame walk, one warp a frame, on the
    ``OVERFLOW`` frames; it writes their statuses alone (the others' warps
    leave at once)."""
    _on_card(comp, "walk")
    comp, comp_sizes = _row_args(comp, comp_sizes)
    st = fstat.clone()
    fn = _fn("tpucomp_zstd_settle", [_P, _P, _I, _I, _I, _I, _P], "zstd_decode")
    with torch.cuda.device(comp.device):
        _call("walk", settle_kernel, comp.shape[0], fn, comp.data_ptr(), comp_sizes.data_ptr(),
              comp.shape[0], comp.shape[1], out_cap, lit_cap, st.data_ptr())
    return st


def zero_kernel(fstat, fsize, out_cap: int):
    """Pass 6a on the card."""
    _on_card(fstat, "zero")
    dev, B = fstat.device, fstat.shape[0]
    out = torch.empty((B, out_cap), dtype=torch.uint8, device=dev)
    osz = torch.empty(B, dtype=torch.int32, device=dev)
    st = torch.empty(B, dtype=torch.int32, device=dev)
    fn = _fn("tpucomp_zstd_zero", [_P, _P, _I, _I, _P, _P, _P])
    with torch.cuda.device(dev):
        _call("zero", zero_kernel, B, fn, fstat.contiguous().data_ptr(),
              fsize.contiguous().data_ptr(), B, out_cap, out.data_ptr(), osz.data_ptr(),
              st.data_ptr())
    return out, osz, st


def execute_kernel(comp, blk, lits, seqs, offs, bstart, bout, fstat, out,
                   multi: bool = True):
    """Pass 6b on the card (one CTA a block, in ticket order), into ``out``
    in place; returns it.  CTAs take blocks by ticket in the order (block
    index within its frame, frame), so every frame moves at once and a
    block only waits on blocks of lower tickets, whose CTAs already run.
    With ``multi`` False (no frame has a second block) CTA ``b`` takes
    block ``b``, nothing is sorted, waited on or published, and the kernel
    runs its narrow shape (more CTAs an SM)."""
    _on_card(comp, "execute")
    comp, blk = comp.contiguous(), blk.contiguous()
    dev, n, B = comp.device, blk.shape[0], out.shape[0]
    if not n:
        return out
    order = sync = None
    if multi:   # the ticket order, and each block's progress then the ticket counter
        order = torch.argsort(blk[:, F_LOCAL] * max(B, 1) + blk[:, F_FRAME]).to(torch.int32)
        sync = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    fn = _fn("tpucomp_zstd_execute", [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                      _P])
    with torch.cuda.device(dev):
        _call("execute", execute_kernel, n, fn, comp.data_ptr(), comp.shape[1], blk.data_ptr(),
              n, 0 if order is None else order.data_ptr(), lits.contiguous().data_ptr(),
              seqs.contiguous().data_ptr(), offs.contiguous().data_ptr(),
              bstart.contiguous().data_ptr(), bout.contiguous().data_ptr(),
              fstat.contiguous().data_ptr(), out.data_ptr(), out.shape[1],
              0 if sync is None else sync.data_ptr())
    return out


for _k in (chain_kernel, entropy_kernel, scan_kernel, resolve_kernel, settle_kernel, zero_kernel,
           execute_kernel):
    _k.launches = 0

KERNEL = {"chain": chain_kernel, "fill": fill_kernel, "entropy": entropy_kernel,
          "scan": scan_kernel, "resolve": resolve_kernel, "settle": settle_kernel,
          "zero": zero_kernel, "execute": execute_kernel}


# =====================================================================================
# the pipeline
# =====================================================================================

def run(comp: torch.Tensor, comp_sizes: torch.Tensor, out_cap: int, lit_cap: int,
        plain: bool = False, keep: dict | None = None):
    """All passes -> ``(out, out_sizes, statuses)``: the kernels on the
    card, or with ``plain`` the plain versions on the host (tensors returned
    on ``comp``'s device).  One host read, of the chain's totals, sizes the
    scratch.  With ``keep``, every pass's inputs and outputs are stored in
    it, for holding each kernel against its plain pass."""
    P = PLAIN if plain else KERNEL
    k = keep if keep is not None else {}
    k["fcount"], k["bases"], k["totals"] = P["chain"](comp, comp_sizes, out_cap, lit_cap)
    nblk, nseq, nlit, nover, most = k["totals"]
    k["blk"] = P["fill"](comp, comp_sizes, out_cap, lit_cap, k["fcount"], k["bases"], nblk)
    k["lits"], k["seqs"], k["bout"], k["bsym"], k["berr"] = P["entropy"](comp, k["blk"], nlit,
                                                                         nseq)
    k["bstart"], k["bin"], k["fsize"], k["fstat0"] = P["scan"](
        k["fcount"], k["bases"], k["bout"], k["bsym"], k["berr"], out_cap)
    k["offs"], k["fstat1"] = P["resolve"](k["blk"], k["seqs"], k["bstart"], k["bin"],
                                          k["fstat0"])
    k["fstat"] = (P["settle"](comp, comp_sizes, out_cap, lit_cap, k["fstat1"]) if nover
                  else k["fstat1"])
    k["out0"], osz, stat = P["zero"](k["fstat"], k["fsize"], out_cap)
    out = P["execute"](comp, k["blk"], k["lits"], k["seqs"], k["offs"], k["bstart"], k["bout"],
                       k["fstat"], k["out0"], most > 1)
    dev = comp.device
    return out.to(dev), osz.to(dev), stat.to(dev)
