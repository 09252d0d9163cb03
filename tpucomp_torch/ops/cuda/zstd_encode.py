"""Batched Zstandard encode: sort-matched candidates, exact-entropy tables,
then the Hopper kernels.

Port of :mod:`tpucomp.ops.pallas.zstd_encode` (``_kernel`` in its modes
``hist`` and ``full``, ``_seq_tables``, ``_predef_fse_tab``,
``compress_batch``).  :func:`tpucomp_torch.ops.match.candidates2` (64 KiB
window: an offset may reach the whole chunk) finds the match candidates;
``csrc/zstd_encode.cu`` (its header says what it replaces, what bounds it
and how it is built) turns them into the walk's sequences by one gated
parse, one resident CTA an SM with a row of global scratch each
(:func:`parse_scratch`): every candidate position tabulated at once
(:func:`position_table_plain`), the chain the cost gate gives
(:func:`next_kept_plain`), rounds that add the repeat offsets' keeps
(:func:`gated_chain_plain`).  Two modes follow the parse:

* ``hist`` — the exact literal-byte histogram and the LL/ML/OF code
  histograms of the sequences, :func:`hist_kernel`: the codes' counts and
  the bytes no kept match covers (:func:`hist_from_chain_plain`);
* ``full`` — one complete single-block frame: 4-stream Huffman literals (or
  raw ones), the sequences through three FSE state machines, and a raw-block
  rewrite when that is not shorter, :func:`full_kernel`: the literal
  streams and the FSE states from prefix sums (:func:`huf_offsets_plain`,
  :func:`fse_states_plain`, :func:`frame_from_parse_plain`).

Between them, in torch ops over the batch, :func:`seq_tables` builds each
chunk's FSE tables (custom where they pay, else the predefined ones) and
:func:`tpucomp_torch.formats.zstd.huf_tree` the literal Huffman table.  With
``exact_entropy=False`` (the speed rung) there is no ``hist`` kernel: the
Huffman table comes from the whole chunk's byte histogram and the sequences
use the predefined tables.  The plain versions run the same walk in Python;
the CPU tests hold them against the reference and ``chip_smoke.py`` holds the
kernels against them.

Contract: ``data uint8[B, cap]`` (``cap <= 65536``) plus ``sizes int32[B]``
(each in ``[0, cap]``; values outside are clamped) -> ``(out uint8[B,
out_cap], out_sizes int32[B], statuses int32[B])``, zstd frames
byte-identical to the reference's.  A frame longer than ``out_cap`` gives
``ERROR_OUTPUT_BUFFER_TOO_SMALL``, size 0 and a zero row.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from tpucomp_torch.formats import zstd as fzstd
from tpucomp_torch.ops import match
from tpucomp_torch.ops.cuda import _build
from tpucomp_torch.ops.cuda.deflate_encode import _frames, _int32, _rows
from tpucomp_torch.ops.cuda.lz4_encode2 import _clamped_sizes, _match_len
from tpucomp_torch.ops.cuda.lz_parse import _common_prefix

MIN_MATCH = 4
MAX_CAP = 65536   # 16-bit (ll, ml - 3) packing; wider chunks take the multi-block encoder

# ---- the constant table: code lookups and the packed predefined encoders ----------
# zstd's own LL_Code[64] / ML_Code[128] (beyond them: the high bit plus a delta)
_LL_CODE64 = np.array(
    list(range(16)) + [16, 16, 17, 17, 18, 18, 19, 19]
    + [20] * 4 + [21] * 4 + [22] * 8 + [23] * 8 + [24] * 16, np.int32)
_ML_CODE128 = np.array(
    list(range(32)) + [32, 32, 33, 33, 34, 34, 35, 35]
    + [36] * 4 + [37] * 4 + [38] * 8 + [39] * 8
    + [40] * 16 + [41] * 16 + [42] * 32, np.int32)
_LL_XTRA = ((fzstd.LL_BASE.astype(np.int64) << 8) | fzstd.LL_BITS).astype(np.int32)
_ML_XTRA = ((fzstd.ML_BASE.astype(np.int64) << 8) | fzstd.ML_BITS).astype(np.int32)


def _pack_enc(enc):
    st, nb, bs, first = enc
    return ((st | (nb << 8) | (bs << 16)).reshape(-1).astype(np.int32),
            first.astype(np.int32))


_LLE, _LLF = _pack_enc(fzstd.LL_ENC)
_MLE, _MLF = _pack_enc(fzstd.ML_ENC)
_OFE, _OFF = _pack_enc(fzstd.OF_ENC)
_PARTS = [_LL_CODE64, _ML_CODE128, _LL_XTRA, _ML_XTRA, _LLE, _MLE, _OFE, _LLF, _MLF, _OFF]
_OFFS = np.cumsum([0] + [p.shape[0] for p in _PARTS])
(O_LLC, O_MLC, O_LLX, O_MLX, O_LLE, O_MLE, O_OFE,
 O_LLF, O_MLF, O_OFF) = [int(x) for x in _OFFS[:10]]
CONST = np.concatenate(_PARTS)

# ---- each chunk's FSE table block (packed state | nb << 10 | base << 14) ----------
LL_ACC, ML_ACC, OF_ACC = 9, 9, 8
O2_LL = 0
O2_ML = O2_LL + 36 * 512
O2_OF = O2_ML + 53 * 512
O2_LLF = O2_OF + 32 * 256
O2_MLF = O2_LLF + 36
O2_OFF = O2_MLF + 53
O2_META = O2_OFF + 32      # [ll_acc, ml_acc, of_acc, scm, nc_len_bytes, 0, 0, 0]
FSE_TT = ((O2_META + 8 + 127) // 128) * 128
NC_CAP = 512               # the ncount bytes (three tables, at most about 80 bytes each)
HUF_META = 258             # 256 packed code | nbits << 12, tree bytes, huf_ok


def _predef_fse_tab() -> np.ndarray:
    """The FSE block of the predefined tables in :func:`seq_tables`' layout
    (scm 0, no ncount bytes): the speed rung's sequence side."""
    def pack(def_enc, size_c, rows):
        st, nb, bs, first = (np.asarray(a) for a in def_enc)
        pad = ((0, rows - st.shape[0]), (0, size_c - st.shape[1]))
        st, nb, bs = (np.pad(a, pad) for a in (st, nb, bs))
        first = np.pad(first, (0, rows - first.shape[0]))
        return ((st | (nb << 10) | (bs << 14)).reshape(-1).astype(np.int32),
                first.astype(np.int32))

    p_ll, f_ll = pack(fzstd.LL_ENC, 512, 36)
    p_ml, f_ml = pack(fzstd.ML_ENC, 512, 53)
    p_of, f_of = pack(fzstd.OF_ENC, 256, 32)
    meta = np.array([fzstd.LL_DEFAULT_ACC, fzstd.ML_DEFAULT_ACC, fzstd.OF_DEFAULT_ACC,
                     0, 0, 0, 0, 0], np.int32)
    tab = np.concatenate([p_ll, p_ml, p_of, f_ll, f_ml, f_of, meta])
    return np.pad(tab, (0, FSE_TT - tab.shape[0])).astype(np.int32)


PREDEF_FSE_TAB = _predef_fse_tab()


# --- the table layer (torch ops over B) ---------------------------------------------

def _pack_fields(vals: torch.Tensor, bits: torch.Tensor):
    """Fields ``[B, n]`` of ``bits`` bits each, LSB first from bit 0 ->
    ``(bytes int64[B, NC_CAP], byte count int64[B])``; the words are sums
    of the fields' parts mod 2^32, as the reference's masked sums."""
    B = vals.shape[0]
    off = torch.cumsum(bits, dim=1) - bits
    nbytes = (bits.sum(dim=1) + 7) >> 3
    word, sh = off >> 5, off & 31
    v = vals & 0xFFFFFFFF
    live = bits > 0
    W = NC_CAP // 4
    words = torch.zeros((B, W + 1), dtype=torch.int64, device=vals.device)
    for w, part in ((word, (v << sh) & 0xFFFFFFFF),
                    (word + 1, torch.where(sh > 0, v >> (32 - sh), 0))):
        words.scatter_add_(1, torch.where(live & (w < W), w, W), part)   # column W: nowhere
    words = words[:, :W] & 0xFFFFFFFF
    by = (words[:, :, None] >> (8 * torch.arange(4, device=vals.device))) & 0xFF
    return by.reshape(B, NC_CAP), nbytes


def _one_table(freq, nseq, acc, def_norm, def_acc, def_enc, size_c):
    """One sequence code's table (``_seq_tables.one``, ``zstd_encode.py:155-180``),
    :func:`tpucomp_torch.formats.zstd.seq_table` packed into this layout."""
    use, st, nb, bs, first, acc_used, dvals, dbits = fzstd.seq_table(
        freq, nseq, acc, def_norm, def_acc, def_enc, size_c)
    packed = (st | (nb << 10) | (bs << 14)).reshape(freq.shape[0], -1)
    return use, packed, first, acc_used, dvals, dbits


def seq_tables(sch: torch.Tensor):
    """Each chunk's sequence tables from the ``hist`` walk's code histograms
    ``sch int32[B, 121]`` (LL at 0, ML at 36, OF at 89;
    ``zstd_encode.py:136-234``), on their device.

    Returns ``(fse_tab int32[B, FSE_TT], nc uint8[B, NC_CAP])``: the three
    encode tables packed ``state | nb << 10 | base << 14`` (LL and ML 512
    columns, OF 256), their first slots, the meta row ``[ll_acc, ml_acc,
    of_acc, scm, nc_len]``, and the custom tables' descriptions, byte-aligned
    each, in the order LL, OF, ML.
    """
    B = sch.shape[0]
    dev = sch.device
    sch = sch.to(torch.int64)
    nseq = sch[:, :36].sum(dim=1)
    u_ll, p_ll, f_ll, a_ll, llv, llb = _one_table(
        sch[:, 0:36], nseq, LL_ACC, fzstd.LL_DEFAULT, fzstd.LL_DEFAULT_ACC, fzstd.LL_ENC, 512)
    u_ml, p_ml, f_ml, a_ml, mlv, mlb = _one_table(
        sch[:, 36:89], nseq, ML_ACC, fzstd.ML_DEFAULT, fzstd.ML_DEFAULT_ACC, fzstd.ML_ENC, 512)
    u_of, p_of, f_of, a_of, ofv, ofb = _one_table(
        sch[:, 89:118], nseq, OF_ACC, fzstd.OF_DEFAULT, fzstd.OF_DEFAULT_ACC, fzstd.OF_ENC, 256)
    p_of = torch.nn.functional.pad(p_of, (0, 3 * 256))         # OF symbols padded to 32 rows
    f_of = torch.nn.functional.pad(f_of, (0, 3))

    idx = torch.arange(NC_CAP, device=dev)[None]
    nc = torch.zeros((B, NC_CAP), dtype=torch.int64, device=dev)
    off = torch.zeros((B, 1), dtype=torch.int64, device=dev)
    for vals, bits in ((llv, llb), (ofv, ofb), (mlv, mlb)):
        by, nb = _pack_fields(vals, bits)
        src = (idx - off).clamp(0, NC_CAP - 1)
        nc = torch.where((idx >= off) & (idx < off + nb[:, None]), torch.gather(by, 1, src), nc)
        off = off + nb[:, None]

    two = lambda u: torch.where(u, 2, 0)       # noqa: E731  (FSE_Compressed_Mode)
    scm = (two(u_ll) << 6) | (two(u_of) << 4) | (two(u_ml) << 2)
    zeros = torch.zeros_like(scm)
    meta = torch.stack([a_ll, a_ml, a_of, scm, off[:, 0], zeros, zeros, zeros], dim=1)
    tab = torch.cat([p_ll, p_ml, p_of, f_ll, f_ml, f_of, meta], dim=1)
    tab = torch.nn.functional.pad(tab, (0, FSE_TT - tab.shape[1]))
    return tab.to(torch.int32), nc.to(torch.uint8)


def huf_meta(freq: torch.Tensor):
    """The literal Huffman input of the ``full`` walk from a byte histogram
    ``freq int32[B, 256]`` (``zstd_encode.py:904-919``): ``(meta int32[B,
    258] = code | nbits << 12 for each byte, the tree bytes, huf_ok; tree
    uint8[B, TREE_CAP])``.  ``huf_ok`` skips the Huffman attempt when the
    table cannot beat raw literals (7.5 bits a byte or more)."""
    codes, nbits, tree, tree_bytes, tok = fzstd.huf_tree(freq)
    freq = freq.to(torch.int64)
    tot = freq.sum(dim=1).clamp(min=1)
    est_bits = (freq * nbits).sum(dim=1)
    huf_ok = tok & (est_bits * 8 <= tot * 60)
    meta = torch.cat([codes | (nbits << 12), tree_bytes[:, None],
                      huf_ok.to(torch.int32)[:, None]], dim=1)
    return meta.to(torch.int32), tree


def whole_chunk_hist(data: torch.Tensor, sizes: torch.Tensor) -> torch.Tensor:
    """The speed rung's byte histogram of each chunk's first ``size`` bytes."""
    B, cap = data.shape
    live = torch.arange(cap, device=data.device)[None] < sizes.to(torch.int64)[:, None]
    freq = torch.zeros((B, 256), dtype=torch.int32, device=data.device)
    return freq.scatter_add_(1, data.to(torch.int64), live.to(torch.int32))


def speed_tables(B: int, device):
    """The speed rung's sequence side: the predefined block, no ncount bytes."""
    tab = torch.from_numpy(PREDEF_FSE_TAB).to(device)[None].expand(B, FSE_TT).contiguous()
    return tab, torch.zeros((B, NC_CAP), dtype=torch.uint8, device=device)


# --- plain versions: the same walk in Python ----------------------------------------

def _ll_code(ll: int) -> int:
    return int(_LL_CODE64[ll]) if ll < 64 else 19 + ll.bit_length() - 1


def _ml_code(mlv: int) -> int:
    return int(_ML_CODE128[mlv]) if mlv < 128 else 36 + max(mlv, 1).bit_length() - 1


def _walk(row: bytes, size: int, cand, cand8, nxt, cap_seq: int):
    """The token walk over one chunk -> ``([(ll, ml, ofv) for each kept
    sequence], the literal bytes in order)``.

    At ``nm = nxt[scan]`` (stop at ``nm >= size - 3`` or a full sequence
    buffer) both candidates extend forward (the longer wins, ``cand8`` only
    if strictly longer), then backward while the bytes before agree.  The
    cost gate keeps a sequence when its offset is a repeat offset or ``ml *
    5 >= floor(log2 offset) + 18``; a sequence that does not pay moves
    ``scan`` one byte on and leaves ``anchor``.  Offsets go through the
    3-deep repeat stack of RFC 8878 3.1.1.5.
    """
    seqs, lits = [], bytearray()
    mflimit = size - MIN_MATCH + 1
    anchor = scan = 0
    r0, r1, r2 = 1, 4, 8
    while scan < mflimit:
        nm = nxt[scan]
        if nm >= mflimit or len(seqs) >= cap_seq:
            break
        p4 = cand[nm] if cand[nm] >= 0 else cand8[nm]
        p8 = cand8[nm] if cand8[nm] >= 0 else p4
        fcap = size - (nm + MIN_MATCH)
        l4 = _match_len(row, nm + MIN_MATCH, p4 + MIN_MATCH, fcap)
        l8 = _match_len(row, nm + MIN_MATCH, p8 + MIN_MATCH, fcap) if p8 != p4 else l4
        src = p8 if l8 > l4 else p4
        c = nm - src
        nm2, src2 = nm, src
        while nm2 > anchor and src2 > 0 and row[nm2 - 1] == row[src2 - 1]:
            nm2 -= 1
            src2 -= 1
        ml = nm - nm2 + MIN_MATCH + max(l4, l8)
        ll = nm2 - anchor
        if not (c in (r0, r1, r2) or ml * 5 >= c.bit_length() - 1 + 18):
            scan = nm + 1
            continue
        lits += row[anchor:nm2]
        if ll > 0:
            ofv = 1 if c == r0 else 2 if c == r1 else 3 if c == r2 else c + 3
        else:
            ofv = 1 if c == r1 else 2 if c == r2 else c + 3
        keep = ll > 0 and ofv == 1
        swap = (ll > 0 and ofv <= 2) or (ll == 0 and ofv == 1)
        r0, r1, r2 = (r0 if keep else c), (r1 if keep else r0), (r2 if swap else r1)
        seqs.append((ll, ml, ofv))
        anchor = scan = nm2 + ml
    lits += row[anchor:size]
    return seqs, bytes(lits)


def _hist_chunk(seqs: list, lits: bytes) -> tuple[list, list]:
    freq = np.bincount(np.frombuffer(lits, np.uint8), minlength=256).tolist()
    sch = [0] * 121
    for ll, ml, ofv in seqs:
        sch[_ll_code(ll)] += 1
        sch[36 + _ml_code(ml - 3)] += 1
        sch[89 + min(ofv.bit_length() - 1, 31)] += 1
    return freq, sch


class _Bits:
    """The LSB-first bit writer of the kernel: a 64-bit accumulator that
    writes 4 bytes whenever it holds 32 bits, and whole bytes at the end."""

    def __init__(self):
        self.out, self.acc, self.nb = bytearray(), 0, 0

    def put(self, v: int, n: int) -> None:
        self.acc |= (v & 0xFFFFFFFF) << self.nb
        self.nb += n
        if self.nb >= 32:
            self.out += (self.acc & 0xFFFFFFFF).to_bytes(4, "little")
            self.acc >>= 32
            self.nb -= 32

    def finish(self) -> bytearray:
        while self.nb > 0:
            self.out.append(self.acc & 0xFF)
            self.acc >>= 8
            self.nb = max(self.nb - 8, 0)
        return self.out


def _huf_streams(lits: bytes, hufpk: list) -> list:
    """The four Huffman streams: stream k holds ``per = ceil(n / 4)`` literals
    (the last the rest), each written backward, then a 1-bit sentinel."""
    n = len(lits)
    per = (n + 3) >> 2
    streams = []
    for k in range(4):
        cnt = per if k < 3 else n - 3 * per
        bits = _Bits()
        for idx in range(k * per + cnt - 1, k * per - 1, -1):
            pk = hufpk[lits[idx]]
            bits.put(pk & 0xFFF, pk >> 12)
        bits.put(1, 1)
        streams.append(bits.finish())
    return streams


def _seq_stream(seqs: list, fse: list) -> bytearray:
    """The sequences' backward bitstream: the last sequence sets the three
    states; every earlier one appends the OF, ML and LL state transitions,
    then (every sequence) the LL, ML and OF extra bits; then the final ML,
    OF and LL states and the padding bit."""
    bits = _Bits()
    tab = lambda i: fse[min(max(i, 0), FSE_TT - 1)]     # noqa: E731
    s_ll = s_ml = s_of = 0
    for j, (ll, ml, ofv) in enumerate(reversed(seqs)):
        mlv = ml - 3
        llc, mlc, ofc = _ll_code(ll), _ml_code(mlv), ofv.bit_length() - 1
        ofr = min(ofc, 31)
        if j == 0:
            s_ll, s_ml, s_of = tab(O2_LLF + llc), tab(O2_MLF + mlc), tab(O2_OFF + ofr)
        else:
            pk = tab(O2_OF + ofr * 256 + s_of)
            bits.put(s_of - (pk >> 14), (pk >> 10) & 0xF)
            n_of = pk & 0x3FF
            pk = tab(O2_ML + mlc * 512 + s_ml)
            bits.put(s_ml - (pk >> 14), (pk >> 10) & 0xF)
            n_ml = pk & 0x3FF
            pk = tab(O2_LL + llc * 512 + s_ll)
            bits.put(s_ll - (pk >> 14), (pk >> 10) & 0xF)
            s_ll, s_ml, s_of = pk & 0x3FF, n_ml, n_of
        llpk, mlpk = int(_LL_XTRA[llc]), int(_ML_XTRA[mlc])
        bits.put(ll - (llpk >> 8), llpk & 0xFF)
        bits.put(ml - (mlpk >> 8), mlpk & 0xFF)
        bits.put(ofv - (1 << ofc), ofc)
    bits.put(s_ml, tab(O2_META + 1))
    bits.put(s_of, tab(O2_META + 2))
    bits.put(s_ll, tab(O2_META))
    bits.put(1, 1)
    return bits.finish()


def _emit_chunk(row: bytes, size: int, seqs: list, lits: bytes, meta: list, tree: bytes,
                fse: list, nc: bytes) -> bytes:
    """One chunk's whole frame (its length decides the status)."""
    n_lit = len(lits)
    lit_sec = None
    tree_b = meta[256]
    if meta[257] > 0 and n_lit >= 64:
        streams = _huf_streams(lits, meta[:256])
        sb = [len(s) for s in streams]
        csize = tree_b + 6 + sum(sb)
        if 5 + csize < 3 + n_lit:
            w = 2 | (3 << 2) | ((n_lit & 0x3FFFF) << 4) | ((csize & 0x3FF) << 22)
            lit_sec = (w.to_bytes(4, "little") + bytes([(csize >> 10) & 0xFF]) + tree[:tree_b]
                       + b"".join((s & 0xFFFF).to_bytes(2, "little") for s in sb[:3])
                       + b"".join(streams))
    if lit_sec is None:            # raw literals, Size_Format 3 (a 20-bit size)
        lit_sec = bytes([(3 << 2) | ((n_lit & 0xF) << 4), (n_lit >> 4) & 0xFF,
                         (n_lit >> 12) & 0xFF]) + lits
    nseq = len(seqs)
    if nseq:
        nc_len = min(fse[O2_META + 4], NC_CAP)
        seq_sec = (bytes([128 + (nseq >> 8), nseq & 0xFF, fse[O2_META + 3] & 0xFF])
                   + nc[:nc_len] + _seq_stream(seqs, fse))
    else:
        seq_sec = b"\x00"
    body = lit_sec + seq_sec
    if 13 + len(body) >= 13 + size:                   # a raw block is no longer
        bh, body = 1 | (size << 3), row[:size]
    else:
        bh = 1 | (2 << 1) | (len(body) << 3)
    bl = max(size - 1, 1).bit_length()
    wl = 10 if size <= 1024 else max(bl, 10)
    head = (bytes([0x28, 0xB5, 0x2F, 0xFD, 0x80, ((wl - 10) << 3) & 0xFF])
            + (size & 0xFFFFFFFF).to_bytes(4, "little") + (bh & 0xFFFFFF).to_bytes(3, "little"))
    return head + body


# --- the full kernel's pieces, plain ---------------------------------------------------
# The full kernel does not walk: it tabulates every candidate position at once
# (offset, forward length, the back extension the cost gate needs), follows
# the chain of kept sequences that the gate alone gives (32 merged chases of
# next()), then checks in rounds whether a repeat offset keeps an earlier
# candidate; the literal streams and the FSE states come from prefix sums.
# These are those passes' plain versions, one chunk at a time; the CPU tests
# hold them against :func:`_walk` and the frames against :func:`full_plain`.

def _hibit(v: np.ndarray) -> np.ndarray:
    """floor(log2 v) for v >= 1, exactly."""
    return np.frexp(np.maximum(v, 1).astype(np.float64))[1].astype(np.int64) - 1


def position_table_plain(row: torch.Tensor, size: int, cand: torch.Tensor,
                         cand8: torch.Tensor) -> dict:
    """The full kernel's per-position pass, for one chunk (``row uint8[cap]``,
    candidates2's ``cand`` and ``cand8`` rows): at every position ``p <
    mflimit`` with a candidate, the offset ``c = p - src`` of the walk's
    source (cand8 only if its forward extension is longer), ``lf = 4 +``
    the forward extension (no cap), and ``lvl``: the least back extension
    ``b`` with ``(lf + b) * 5 >= floor(log2 c) + 18`` when the position's
    own back extension (up to 3 bytes, ``src2 > 0``) reaches it, else 4 (the
    gate fails whatever the anchor); 7 where there is no candidate.  Int64
    tensors over ``[0, mflimit)``."""
    mflimit = max(size - MIN_MATCH + 1, 0)
    buf = np.zeros(size + 16, np.uint8)
    buf[:size] = row[:size].numpy()
    pos = np.arange(mflimit)
    c4, c8 = cand[:mflimit].numpy().astype(np.int64), cand8[:mflimit].numpy().astype(np.int64)
    isc = (c4 >= 0) | (c8 >= 0)
    p4 = np.where(c4 >= 0, c4, c8)
    p8 = np.where(c8 >= 0, c8, p4)
    two = isc & (p8 != p4)
    words = np.lib.stride_tricks.sliding_window_view(buf, 8).copy().view("<u8")[:, 0]
    at = np.nonzero(isc)[0]
    la = np.zeros(mflimit, np.int64)
    la[at] = _common_prefix(words, pos[at] + MIN_MATCH, p4[at] + MIN_MATCH,
                            size - (pos[at] + MIN_MATCH), row=buf[:size])
    lb = la.copy()
    tw = np.nonzero(two)[0]
    lb[tw] = _common_prefix(words, pos[tw] + MIN_MATCH, p8[tw] + MIN_MATCH,
                            size - (pos[tw] + MIN_MATCH), row=buf[:size])
    src = np.where(two & (lb > la), p8, p4)
    lf = MIN_MATCH + np.maximum(la, lb)
    c = np.where(isc, pos - src, 0)
    b3 = np.zeros(mflimit, np.int64)
    ok = isc.copy()
    for k in range(3):
        xs, ys = pos - 1 - k, src - 1 - k
        ok &= (ys >= 0) & (buf[np.maximum(xs, 0)] == buf[np.maximum(ys, 0)])
        b3 += ok
    need = np.maximum(0, (_hibit(c) + 18 + 4) // 5 - lf)
    lvl = np.where(isc, np.where(need <= b3, need, 4), 7)
    t = lambda v: torch.from_numpy(np.asarray(v, np.int64))     # noqa: E731
    return {"c": t(c), "lf": t(np.where(isc, lf, 0)), "lvl": t(lvl)}


def next_kept_plain(tab: dict) -> torch.Tensor:
    """The full kernel's next(): from an anchor ``s``, the first candidate
    ``K >= s`` that the cost gate keeps (``lvl[K] <= min(3, K - s)``), and the
    end of its match ``K + lf[K]``; -1 where none is left.  Repeat offsets
    are not looked at (the rounds add them)."""
    lvl, lf = tab["lvl"].numpy(), tab["lf"].numpy()
    n = lvl.shape[0]
    g = np.where(lvl <= 3, np.arange(n), n)
    first = np.minimum.accumulate(g[::-1])[::-1] if n else g          # first G at or past x
    out = np.full(n, -1, np.int64)
    for s in range(n):
        k = first[s]
        while k < n and k - s < 3 and lvl[k] > k - s:
            k = first[k + 1] if k + 1 < n else n
        if k < n:
            out[s] = k + lf[k]
    return torch.from_numpy(out)


def gated_chain_plain(row: bytes, size: int, tab: dict, cap_seq: int):
    """The chain of kept sequences over the per-position table, from ``(scan,
    anchor, r0, r1, r2) = (0, 0, 1, 4, 8)``: the next kept candidate is the
    first one at or past the anchor that the gate keeps or whose offset is
    on the repeat stack; its back extension (bounded by the anchor and
    ``src2 > 0``) gives ``ll`` and ``ml``; the stack follows RFC 8878
    3.1.1.5.  Returns ``([(anchor, K, ll, ml, ofv, stack after) ...], the
    trailing literals' anchor)`` -- :func:`_walk`'s sequences."""
    lvl, lf, c = (tab[k].tolist() for k in ("lvl", "lf", "c"))
    mflimit = len(lvl)
    out = []
    s = 0
    r0, r1, r2 = 1, 4, 8
    while s < mflimit and len(out) < cap_seq:
        k = s
        while k < mflimit and not (lvl[k] != 7 and (lvl[k] <= min(3, k - s)
                                                    or c[k] in (r0, r1, r2))):
            k += 1
        if k >= mflimit:
            break
        off = c[k]
        nm2, src2 = k, k - off
        while nm2 > s and src2 > 0 and row[nm2 - 1] == row[src2 - 1]:
            nm2, src2 = nm2 - 1, src2 - 1
        ll, ml = nm2 - s, k - nm2 + lf[k]
        if ll > 0:
            ofv = 1 if off == r0 else 2 if off == r1 else 3 if off == r2 else off + 3
        else:
            ofv = 1 if off == r1 else 2 if off == r2 else off + 3
        keep = ll > 0 and ofv == 1
        swap = (ll > 0 and ofv <= 2) or (ll == 0 and ofv == 1)
        r0, r1, r2 = (r0 if keep else off), (r1 if keep else r0), (r2 if swap else r1)
        out.append((s, k, ll, ml, ofv, (r0, r1, r2)))
        s = k + lf[k]
    return out, s


def hist_from_chain_plain(row: bytes, size: int, chain: list) -> tuple[list, list]:
    """The hist kernel's counting phase on :func:`gated_chain_plain`'s
    sequences: each sequence's LL, ML and OF codes (OF capped at 31), and
    the bytes of ``row[:size]`` that no kept match ``[nm2, nm2 + ml)``
    covers (the literals and the tail), found through a coverage bitmask as
    the kernel finds them -> ``(freq [256], sch [121])``,
    :func:`_hist_chunk`'s counts."""
    covered = np.zeros(size, bool)
    sch = [0] * 121
    for s, _, ll, ml, ofv, _ in chain:
        covered[s + ll:s + ll + ml] = True
        sch[_ll_code(ll)] += 1
        sch[36 + _ml_code(ml - 3)] += 1
        sch[89 + min(ofv.bit_length() - 1, 31)] += 1
    lits = np.frombuffer(row[:size], np.uint8)[~covered]
    return np.bincount(lits, minlength=256).tolist(), sch


def huf_offsets_plain(lits: bytes, hufpk: list) -> tuple[list, list]:
    """Each literal's bit offset inside its Huffman stream (streams of
    ``ceil(n / 4)`` literals, the last the rest, each written backward: a
    literal's offset is the bits of the stream's literals after it, a suffix
    sum), and each stream's bit count before its sentinel."""
    n = len(lits)
    per = (n + 3) >> 2
    nb = np.array([hufpk[v] >> 12 for v in lits], np.int64)
    offs, totals = np.zeros(n, np.int64), []
    for k in range(4):
        lo, hi = k * per, n if k == 3 else min(n, (k + 1) * per)
        inc = np.cumsum(nb[lo:hi])
        tot = int(inc[-1]) if inc.size else 0
        offs[lo:hi] = tot - inc
        totals.append(tot)
    return offs.tolist(), totals


def huf_streams_from_offsets(lits: bytes, hufpk: list, offs: list, totals: list) -> list:
    """The four streams from :func:`huf_offsets_plain`: each code at its
    offset, the sentinel bit after the stream's last bit, ``ceil((bits +
    1) / 8)`` bytes a stream (:func:`_huf_streams`' bytes)."""
    n = len(lits)
    per = (n + 3) >> 2
    out = []
    for k in range(4):
        lo, hi = k * per, n if k == 3 else min(n, (k + 1) * per)
        acc = 1 << totals[k]
        for i in range(lo, hi):
            acc |= (hufpk[lits[i]] & 0xFFF) << offs[i]
        out.append(acc.to_bytes((totals[k] + 1 + 7) >> 3, "little"))
    return out


def fse_states_plain(seqs: list, fse: list) -> list:
    """The three FSE states (ll, ml, of) after each step, step b coding
    sequence ``len(seqs) - 1 - b``: the first step takes the first slots,
    each later one the encode table's next state at the one before."""
    tab = lambda i: fse[min(max(i, 0), FSE_TT - 1)]     # noqa: E731
    states = []
    for b, (ll, ml, ofv) in enumerate(reversed(seqs)):
        llc, mlc, ofr = _ll_code(ll), _ml_code(ml - 3), min(ofv.bit_length() - 1, 31)
        if b == 0:
            st = (tab(O2_LLF + llc), tab(O2_MLF + mlc), tab(O2_OFF + ofr))
        else:
            s_ll, s_ml, s_of = states[-1]
            st = (tab(O2_LL + llc * 512 + s_ll) & 0x3FF, tab(O2_ML + mlc * 512 + s_ml) & 0x3FF,
                  tab(O2_OF + ofr * 256 + s_of) & 0x3FF)
        states.append(st)
    return states


def seq_stream_from_states_plain(seqs: list, fse: list, states: list) -> bytes:
    """The sequences' bitstream from :func:`fse_states_plain`: every step's
    fields (the OF, ML and LL transitions, each the low ``bits`` bits of the
    state before it, then the LL, ML and OF extra bits) at offsets from a
    prefix sum of their widths, then the final ML, OF and LL states and the
    padding bit (:func:`_seq_stream`'s bytes)."""
    tab = lambda i: fse[min(max(i, 0), FSE_TT - 1)]     # noqa: E731
    vals, widths = [], []
    for b, (ll, ml, ofv) in enumerate(reversed(seqs)):
        llc, mlc, ofc = _ll_code(ll), _ml_code(ml - 3), ofv.bit_length() - 1
        ofr = min(ofc, 31)
        if b > 0:
            s_ll, s_ml, s_of = states[b - 1]
            for st, e in ((s_of, tab(O2_OF + ofr * 256 + s_of)),
                          (s_ml, tab(O2_ML + mlc * 512 + s_ml)),
                          (s_ll, tab(O2_LL + llc * 512 + s_ll))):
                nb = (e >> 10) & 0xF
                vals.append(st & ((1 << nb) - 1))
                widths.append(nb)
        llpk, mlpk = int(_LL_XTRA[llc]), int(_ML_XTRA[mlc])
        vals += [ll - (llpk >> 8), ml - (mlpk >> 8), ofv - (1 << ofc)]
        widths += [llpk & 0xFF, mlpk & 0xFF, ofc]
    s_ll, s_ml, s_of = states[-1]
    vals += [s_ml, s_of, s_ll, 1]
    widths += [tab(O2_META + 1), tab(O2_META + 2), tab(O2_META), 1]
    offs = np.cumsum([0] + widths[:-1]).tolist()
    acc = 0
    for v, w, o in zip(vals, widths, offs):
        acc |= (v & ((1 << w) - 1)) << o
    total = offs[-1] + widths[-1]
    return acc.to_bytes((total + 7) >> 3, "little")


def frame_from_parse_plain(row: bytes, size: int, chain: list, tail: int, meta: list,
                           tree: bytes, fse: list, nc: bytes) -> bytes:
    """One chunk's frame assembled as the full kernel assembles it, from
    :func:`gated_chain_plain`'s sequences: the literals of each sequence and
    the tail, the Huffman streams from :func:`huf_offsets_plain` (each
    stream's bytes known before it is written), the sequence stream from
    :func:`fse_states_plain`; the raw block when the frame is not shorter."""
    parts = []
    for s, k, ll, ml, ofv, _ in chain:
        parts.append(row[s:s + ll])
    lits = b"".join(parts) + row[tail:size]
    seqs = [(ll, ml, ofv) for _, _, ll, ml, ofv, _ in chain]
    n_lit, tree_b = len(lits), meta[256]
    lit_sec = None
    if meta[257] > 0 and n_lit >= 64:
        offs, totals = huf_offsets_plain(lits, meta[:256])
        sb = [(t + 1 + 7) >> 3 for t in totals]
        csize = tree_b + 6 + sum(sb)
        if 5 + csize < 3 + n_lit:
            streams = huf_streams_from_offsets(lits, meta[:256], offs, totals)
            w = 2 | (3 << 2) | ((n_lit & 0x3FFFF) << 4) | ((csize & 0x3FF) << 22)
            lit_sec = (w.to_bytes(4, "little") + bytes([(csize >> 10) & 0xFF]) + tree[:tree_b]
                       + b"".join((b & 0xFFFF).to_bytes(2, "little") for b in sb[:3])
                       + b"".join(streams))
    if lit_sec is None:
        lit_sec = bytes([(3 << 2) | ((n_lit & 0xF) << 4), (n_lit >> 4) & 0xFF,
                         (n_lit >> 12) & 0xFF]) + lits
    if seqs:
        nc_len = min(fse[O2_META + 4], NC_CAP)
        seq_sec = (bytes([128 + (len(seqs) >> 8), len(seqs) & 0xFF, fse[O2_META + 3] & 0xFF])
                   + nc[:nc_len]
                   + seq_stream_from_states_plain(seqs, fse, fse_states_plain(seqs, fse)))
    else:
        seq_sec = b"\x00"
    body = lit_sec + seq_sec
    if len(body) >= size:                               # a raw block is no longer
        bh, body = 1 | (size << 3), row[:size]
    else:
        bh = 1 | (2 << 1) | (len(body) << 3)
    wl = 10 if size <= 1024 else max(max(size - 1, 1).bit_length(), 10)
    return (bytes([0x28, 0xB5, 0x2F, 0xFD, 0x80, ((wl - 10) << 3) & 0xFF])
            + (size & 0xFFFFFFFF).to_bytes(4, "little") + (bh & 0xFFFFFF).to_bytes(3, "little")
            + body)


def _cap_seq(cap: int) -> int:
    """Sequence slots: every sequence covers at least MIN_MATCH bytes."""
    return cap // 4 + 8


def _walks(data, sizes, cands):
    rows, szs, per = _rows(data, sizes, cands)
    cap_seq = _cap_seq(data.shape[1])
    out = []
    for i, (c4, c8, nx) in enumerate(per):
        row = rows[i].tobytes()
        out.append((row, szs[i], *_walk(row, szs[i], c4, c8, nx, cap_seq)))
    return out


def hist_plain(data, sizes, cands):
    """Plain version of :func:`hist_kernel`."""
    freq, sch = [], []
    for _, _, seqs, lits in _walks(data, sizes, cands):
        f, s = _hist_chunk(seqs, lits)
        freq.append(f)
        sch.append(s)
    dev = data.device
    return (torch.tensor(freq, dtype=torch.int32, device=dev).reshape(-1, 256),
            torch.tensor(sch, dtype=torch.int32, device=dev).reshape(-1, 121))


def full_plain(data, sizes, cands, meta, tree, fse_tab, nc, out_cap: int):
    """Plain version of :func:`full_kernel`."""
    meta, fse = meta.cpu().tolist(), fse_tab.cpu().tolist()
    tree, nc = tree.cpu().numpy(), nc.cpu().numpy()
    frames = [_emit_chunk(row, size, seqs, lits, meta[i], tree[i].tobytes(), fse[i],
                          nc[i].tobytes())
              for i, (row, size, seqs, lits) in enumerate(_walks(data, sizes, cands))]
    return _frames(frames, out_cap, data.device)


# --- the kernels ----------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int


def _inputs(data, sizes, cands, n_cands: int) -> list:
    """The checked launch arguments both modes start with: data, sizes and
    the first ``n_cands`` candidate arrays."""
    if data.device.type != "cuda":
        raise ValueError(f"the Zstandard encode kernel needs CUDA tensors, got {data.device}")
    if data.dtype != torch.uint8 or data.dim() != 2:
        raise ValueError(f"data must be uint8[B, cap], got {data.dtype}{list(data.shape)}")
    B, cap = data.shape
    if cap > MAX_CAP:
        raise ValueError(f"the Zstandard encode kernel supports cap <= {MAX_CAP}")
    cands = [_int32(name, t, (B, cap), data.device)
             for name, t in zip(("cand", "cand8", "nxt")[:n_cands], cands)]
    return [data.contiguous(), _clamped_sizes(data, sizes).contiguous(), *cands]


@functools.cache
def _const_on(device) -> torch.Tensor:
    """CONST on ``device``, copied once: a copy from pageable host memory
    waits for the stream, which would stall the card at every call."""
    return torch.from_numpy(CONST).to(device)


@functools.cache
def _scratch_words() -> int:
    """The parse's scratch a CTA, in int32 words (``csrc/zstd_encode.cu``)."""
    return _build.load("zstd_encode").tpucomp_zstd_encode_scratch_words()


@functools.cache
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def parse_scratch(batch: int, device) -> torch.Tensor:
    """The parse's global scratch, a row of ``tpucomp_zstd_encode_scratch_words()``
    int32 words for each CTA a launch starts (one an SM, at most ``batch``):
    864 KiB a row, 132 rows (111 MiB) on an H100.  The hist and full kernels
    may share one on a stream."""
    ctas = max(1, min(batch, _sm_count(device)))
    return torch.empty((ctas, _scratch_words()), dtype=torch.int32, device=device)


def _scratch_arg(scratch, batch: int, device) -> list:
    """The launch's scratch and its CTA count (a new scratch where none is given)."""
    if scratch is None:
        scratch = parse_scratch(batch, device)
    if (scratch.dim() != 2 or scratch.shape[1] != _scratch_words() or scratch.shape[0] < 1
            or scratch.dtype != torch.int32 or scratch.device != device
            or not scratch.is_contiguous()):
        raise ValueError(f"scratch must be int32[ctas, {_scratch_words()}] on {device}, "
                         "as parse_scratch makes it")
    return [scratch, scratch.shape[0]]


def _call(mode: str, args: list, device) -> None:
    """Launch mode ``mode`` on ``args`` (tensors go as pointers, which keeps
    them alive through the launch; ints as ints)."""
    fn = getattr(_build.load("zstd_encode"), f"tpucomp_zstd_encode_{mode}")
    fn.argtypes = [_P if torch.is_tensor(a) else _I for a in args] + [_P]
    fn.restype = _I
    ptrs = [a.data_ptr() if torch.is_tensor(a) else a for a in args]
    with torch.cuda.device(device):
        rc = fn(*ptrs, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"zstd_encode ({mode}) kernel launch failed: cudaError {rc}")


def hist_kernel(data, sizes, cands, scratch=None):
    """Launch the ``hist`` parse of ``csrc/zstd_encode.cu`` over ``cands``
    (``match.candidates2``'s tensors; it reads cand and cand8) on ``data``'s
    card, on the current stream -> ``(freq int32[B, 256], sch int32[B,
    121])``.  One CTA an SM (at most B), each with a row of ``scratch``
    (:func:`parse_scratch`; a new one when none is given)."""
    args = _inputs(data, sizes, cands, 2)
    (B, cap), dev = data.shape, data.device
    freq = torch.empty((B, 256), dtype=torch.int32, device=dev)
    sch = torch.empty((B, 121), dtype=torch.int32, device=dev)
    _call("hist", args + [B, cap, _const_on(dev)] + _scratch_arg(scratch, B, dev)
          + [freq, sch], dev)
    hist_kernel.launches += 1
    return freq, sch


def full_kernel(data, sizes, cands, meta, tree, fse_tab, nc, out_cap: int, scratch=None):
    """Launch the ``full`` parse against the tables of :func:`huf_meta` and
    :func:`seq_tables` (or :func:`speed_tables`); it reads ``cands``' cand
    and cand8.  One CTA an SM (at most B), each with a row of ``scratch``
    (:func:`parse_scratch`; a new one when none is given)."""
    args = _inputs(data, sizes, cands, 2)
    (B, cap), dev = data.shape, data.device
    if tree.shape != (B, fzstd.TREE_CAP) or tree.dtype != torch.uint8 or tree.device != dev:
        raise ValueError(f"tree must be uint8[{B}, {fzstd.TREE_CAP}] on {dev}")
    if nc.shape != (B, NC_CAP) or nc.dtype != torch.uint8 or nc.device != dev:
        raise ValueError(f"nc must be uint8[{B}, {NC_CAP}] on {dev}")
    tables = [_int32("meta", meta, (B, HUF_META), dev), tree.contiguous(),
              _int32("fse_tab", fse_tab, (B, FSE_TT), dev), nc.contiguous()]
    out = torch.empty((B, out_cap), dtype=torch.uint8, device=dev)
    osz = torch.empty((B,), dtype=torch.int32, device=dev)
    stat = torch.empty((B,), dtype=torch.int32, device=dev)
    _call("full", args + [B, cap, _const_on(dev)] + tables + _scratch_arg(scratch, B, dev)
          + [out, out_cap, osz, stat], dev)
    full_kernel.launches += 1
    return out, osz, stat


hist_kernel.launches = 0
full_kernel.launches = 0


# --- the batched entries ---------------------------------------------------------------

def _check_cap(data: torch.Tensor) -> None:
    if data.shape[1] > MAX_CAP:
        raise ValueError(f"the zstd kernel encoder supports cap <= {MAX_CAP} "
                         f"(got {data.shape[1]})")


def compress_batch(data: torch.Tensor, sizes: torch.Tensor, out_cap: int,
                   exact_entropy: bool = True):
    """The candidates, the ``hist`` kernel (``exact_entropy``), the tables and
    the ``full`` kernel, all on the card (``zstd_encode.py:796-982``); both
    kernels use one parse scratch, allocated once a call."""
    if data.device.type != "cuda":
        raise ValueError(f"the Zstandard encode kernels need CUDA tensors, got {data.device}")
    _check_cap(data)
    sizes = _clamped_sizes(data, sizes)
    cands = match.candidates2(data, sizes, window=MAX_CAP)
    scratch = parse_scratch(data.shape[0], data.device)
    if exact_entropy:
        freq, sch = hist_kernel(data, sizes, cands, scratch)
        fse_tab, nc = seq_tables(sch)
    else:
        freq = whole_chunk_hist(data, sizes)
        fse_tab, nc = speed_tables(data.shape[0], data.device)
    meta, tree = huf_meta(freq)
    return full_kernel(data, sizes, cands, meta, tree, fse_tab, nc, out_cap, scratch)


def compress_batch_plain(data: torch.Tensor, sizes: torch.Tensor, out_cap: int,
                         exact_entropy: bool = True):
    """Plain version of :func:`compress_batch` (candidates and tables on
    ``data``'s device, the walks in Python); tensors on ``data``'s device."""
    _check_cap(data)
    sizes = _clamped_sizes(data, sizes)
    cands = match.candidates2(data, sizes, window=MAX_CAP)
    if exact_entropy:
        freq, sch = hist_plain(data, sizes, cands)
        fse_tab, nc = seq_tables(sch)
    else:
        freq = whole_chunk_hist(data, sizes)
        fse_tab, nc = speed_tables(data.shape[0], data.device)
    meta, tree = huf_meta(freq)
    return full_plain(data, sizes, cands, meta, tree, fse_tab, nc, out_cap)


def dispatch(data: torch.Tensor, sizes: torch.Tensor, out_cap: int, plain: bool = False):
    """The registry's zstd encoder (``tpucomp/ops/pallas/__init__.py:253-267``):
    the kernel pipeline (or its plain version) for chunks up to 64 KiB; above
    that, as the reference, the multi-block encoder of
    :func:`tpucomp_torch.formats.zstd.compress_batch` (torch ops on
    ``data``'s device), up to 16 MiB chunks."""
    if data.shape[1] > MAX_CAP:
        if not plain and data.device.type != "cuda":
            raise ValueError(f"the Zstandard kernel path needs CUDA tensors, got {data.device}")
        return fzstd.compress_batch(data, sizes, fzstd.DEFAULT_OPTS, out_cap)
    return (compress_batch_plain if plain else compress_batch)(data, sizes, out_cap)
