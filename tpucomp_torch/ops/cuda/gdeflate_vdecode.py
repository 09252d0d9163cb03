"""Batched GDeflate tile decode: the 32-lane parse and the token replay as
Hopper kernels, with their plain versions.

Port of :mod:`tpucomp.ops.pallas.gdeflate_vdecode` (``_parse_kernel``,
``_exec_kernel``, ``decompress_batch``).  Two kernels in
``csrc/gdeflate_vdecode.cu`` (one warp per tile each; its header says what
they replace, what bounds them and how they are built):

* :func:`parse_kernel` — builds the tile's header fields and canonical tables
  in shared memory (what :func:`tpucomp_torch.formats.gdeflate.tile_tables`
  computes), then decodes 32 tokens a round, warp lane ``j`` on GDeflate lane
  ``j``, into one packed int32 token each: a literal is its byte, a match
  ``1 << 25 | (mlen - 3) << 17 | dist``;
* :func:`exec_kernel` — replays the tokens into the output row.

The plain versions compute the same outputs: :func:`parse_plain` with
``tile_tables`` and the rounds in torch ops over the batch, :func:`exec_plain`
in Python.  :func:`decompress_batch` composes the statuses exactly as the
reference (``gdeflate_vdecode.py:435-467``); :func:`decompress_batch_plain` is
its plain twin.

Contract (the reference's): ``comp uint8[B, comp_cap]`` plus ``comp_sizes
int32[B]`` -> ``(out uint8[B, out_cap], out_sizes int32[B], statuses
int32[B])``; bytes past each size are zero.  A corrupt tile gives
``ERROR_CANNOT_DECOMPRESS``; a valid parse whose raw size passes ``out_cap``
gives ``ERROR_OUTPUT_BUFFER_TOO_SMALL``; both with size 0.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from tpucomp_torch.constants import Status
from tpucomp_torch.formats.deflate import decode_sym
from tpucomp_torch.formats.gdeflate import HDR, N_LANES, tile_tables
from tpucomp_torch.ops.cuda import _build

MATCH_FLAG = 1 << 25
# the per-tile table row the parse kernel writes (and parse_plain builds):
# [btype, n_tokens, raw_size, dw_start, tbl_ok, 0, 0, 0], D[32], lcount,
# lfirst, loffset [16 each], dcount, dfirst, doffset, lsor[288], dsor[32]
T_D, T_LTAB, T_DTAB, T_LSOR, T_DSOR = 8, 40, 88, 136, 424
NTAB = 456
_WIN = 256   # the reference's stream padding, in dwords (two 128-lane rows)


def round_cap(out_cap: int) -> int:
    """Rounds a tile may take: ``out_cap // 32 + 1`` (the reference's cap;
    a longer token count is cut silently and fails the size check)."""
    return out_cap // N_LANES + 1


def _max_dw(comp_cap: int) -> int:
    """The clamp of the stream's dword window start: ``(wrows - 2) * 128``
    for the reference's padded stream of ``wrows`` 128-dword rows."""
    wpad = -(-max(comp_cap, 8) // 4) * 4 + 4 * _WIN
    wrows = -(-(wpad // 4) // 128)
    return (wrows - 2) * 128


def _table_rows(comp: torch.Tensor) -> torch.Tensor:
    """:func:`tile_tables` packed into the parse kernel's ``int32[B, NTAB]`` rows."""
    (btype, n_tok, raw, D, (lc, lf, lo, lsor), (dc, df, do, dsor), dw_start,
     tbl_ok) = tile_tables(comp)
    B = comp.shape[0]
    head = torch.zeros((B, 8), dtype=torch.int32, device=comp.device)
    head[:, 0], head[:, 1], head[:, 2] = btype, n_tok, raw
    head[:, 3], head[:, 4] = dw_start, tbl_ok.to(torch.int32)
    return torch.cat([head, D, lc, lf, lo, dc, df, do, lsor, dsor], dim=1).to(torch.int32)


@functools.cache
def _rev15_table(device: str) -> torch.Tensor:
    """The 15-bit reversal of every 15-bit value."""
    v = torch.arange(1 << 15, dtype=torch.int64)
    r = torch.zeros_like(v)
    for k in range(15):
        r |= ((v >> k) & 1) << (14 - k)
    return r.to(device)


def parse_plain(comp: torch.Tensor, comp_sizes: torch.Tensor, out_cap: int):
    """Plain version of :func:`parse_kernel`: :func:`tile_tables`, then the
    rounds of all tiles at once in torch ops (``[B, 32]`` lane state, an
    int64 bit buffer of at most 63 bits).  Returns ``(tabs int32[B, NTAB],
    tokens int32[B, R_cap * 32], sp int32[B], err int32[B])`` on ``comp``'s
    device; tokens past the tile's count are 0."""
    i64, i32 = torch.int64, torch.int32
    dev = comp.device
    B, comp_cap = comp.shape
    tabs = _table_rows(comp)
    R_cap = round_cap(out_cap)
    tokens = torch.zeros((B, R_cap, N_LANES), dtype=i32, device=dev)
    n_tok = tabs[:, 1].to(i64)
    D = tabs[:, T_D:T_D + 32].to(i64)
    dw0 = (tabs[:, 3] >> 2).to(i64)
    max_dw = _max_dw(comp_cap)
    ltab, dtab = tabs[:, T_LTAB:T_LTAB + 48], tabs[:, T_DTAB:T_DTAB + 48]
    ltabs = (ltab[:, :16], ltab[:, 16:32], ltab[:, 32:], tabs[:, T_LSOR:T_LSOR + 288])
    dtabs = (dtab[:, :16], dtab[:, 16:32], dtab[:, 32:], tabs[:, T_DSOR:T_DSOR + 32])
    # the stream as dwords, zero past the row and out to the clamp's reach
    nw = max_dw + N_LANES
    padded = torch.nn.functional.pad(comp, (0, max(0, 4 * nw - comp_cap)))[:, :4 * nw]
    dwords = padded.contiguous().view(torch.int32).to(i64) & 0xFFFFFFFF

    lane = torch.arange(N_LANES, device=dev)
    buf = torch.zeros((B, N_LANES), dtype=i64, device=dev)
    nb = torch.zeros_like(buf)
    taken = torch.zeros_like(buf)
    sp = torch.zeros(B, dtype=i64, device=dev)
    err = torch.zeros(B, dtype=torch.bool, device=dev)
    rounds = int(torch.clamp((n_tok + N_LANES - 1) // N_LANES, 0, R_cap).max()) if B else 0

    def refill(act):
        nonlocal buf, nb, taken, sp
        need = act & (nb < 32) & (taken < D)
        rank = torch.cumsum(need, dim=1) - need.to(i64)
        at = torch.clamp(dw0 + sp, max=max_dw)[:, None] + rank
        w = torch.gather(dwords, 1, at)
        buf = torch.where(need, buf | (w << nb.clamp(0, 31)), buf)
        nb = nb + 32 * need
        taken = taken + need
        sp = sp + need.sum(dim=1)

    def consume(n):
        nonlocal buf, nb
        buf = buf >> n
        nb = nb - n

    rev15 = _rev15_table(str(dev))

    def decode(tabs4):
        rev = rev15[buf & 0x7FFF].to(i32)
        sym, ln, found = decode_sym(rev, *tabs4)
        return torch.where(found, sym, tabs4[3][:, :1]), ln.to(i64), found

    for r in range(rounds):
        act = (r * N_LANES + lane)[None, :] < n_tok[:, None]
        refill(act)
        sym, l1, ok1 = decode(ltabs)
        err = err | (act & (~ok1 | (sym == 256) | (sym > 285))).any(dim=1)
        consume(torch.where(act, l1, 0))
        is_m = act & (sym >= 257)
        li = (sym - 257).clamp(0, 28)
        refill(act)
        le = ((li >> 2) - 1).clamp(min=0)
        lbase = ((4 + (li & 3)) << le) + 3
        lbase = torch.where(li < 8, li + 3, torch.where(li == 28, 258, lbase))
        le = torch.where((li < 8) | (li == 28), 0, le)
        n2 = torch.where(is_m, le, 0).to(i64)
        ex2 = (buf & ((1 << n2) - 1)).to(i32)
        consume(n2)
        mlen = torch.where(is_m, lbase + ex2, 0)
        refill(act)
        dsym, l3, ok3 = decode(dtabs)
        err = err | (is_m & ~ok3).any(dim=1)
        consume(torch.where(is_m, l3, 0))
        dsym = dsym.clamp(0, 31)
        refill(act)
        de = ((dsym >> 1) - 1).clamp(min=0)
        dbase = ((2 + (dsym & 1)) << de) + 1
        dbase = torch.where(dsym < 4, dsym + 1, dbase)
        de = torch.where(dsym < 4, 0, de)
        n4 = torch.where(is_m, de, 0).to(i64)
        ex4 = (buf & ((1 << n4) - 1)).to(i32)
        consume(n4)
        dist = torch.where(is_m, dbase + ex4, 0)
        tok = torch.where(is_m, MATCH_FLAG | ((mlen - 3) << 17) | dist.clamp(0, 0x1FFFF),
                          sym.clamp(0, 255))
        tokens[:, r] = torch.where(act, tok, 0)
    bad = (taken != D).any(dim=1)
    perr = err.to(i32) | (bad.to(i32) << 1)
    return tabs, tokens.reshape(B, -1), sp.to(i32), perr


def exec_plain(tokens: torch.Tensor, n_tok: torch.Tensor, out_cap: int):
    """Plain version of :func:`exec_kernel`: replay ``max(n_tok, 0)`` tokens
    of each row in Python.  Returns ``(out uint8[B, out_cap], op int32[B],
    derr int32[B])``; a byte no token wrote is 0."""
    toks = tokens.cpu().numpy()
    counts = n_tok.cpu().numpy().astype(np.int64)
    B = toks.shape[0]
    out = np.zeros((B, out_cap), np.uint8)
    ops = np.zeros(B, np.int32)
    derr = np.zeros(B, np.int32)
    for b in range(B):
        row = bytearray(out_cap)
        op, err, live = 0, 0, True
        for tok in toks[b, :max(0, int(counts[b]))].tolist():
            if tok < MATCH_FLAG:
                if live and op < out_cap:
                    row[op] = tok
                else:
                    live = False
                op += 1
                continue
            dist = tok & 0x1FFFF
            ml = ((tok >> 17) & 0xFF) + 3
            if dist < 1 or dist > op:
                err = 1
            if live and err == 0 and op + ml <= out_cap:
                if dist >= ml:
                    row[op:op + ml] = row[op - dist:op - dist + ml]
                else:
                    for k in range(ml):
                        row[op + k] = row[op + k - dist]
            else:
                live = False
            op += ml
        out[b] = np.frombuffer(bytes(row), np.uint8)
        ops[b], derr[b] = op, err
    dev = tokens.device
    return (torch.from_numpy(out).to(dev), torch.from_numpy(ops).to(dev),
            torch.from_numpy(derr).to(dev))


# --- the kernels ---------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int


def _on_card(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"the GDeflate {what} kernel needs CUDA tensors, got {t.device}")


def _call(name: str, argtypes: list, args: list, device) -> None:
    fn = getattr(_build.load("gdeflate_vdecode"), f"tpucomp_gdeflate_{name}")
    fn.argtypes = argtypes + [_P]
    fn.restype = _I
    ptrs = [a.data_ptr() if torch.is_tensor(a) else a for a in args]
    with torch.cuda.device(device):
        rc = fn(*ptrs, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gdeflate {name} kernel launch failed: cudaError {rc}")


def parse_kernel(comp: torch.Tensor, comp_sizes: torch.Tensor, out_cap: int):
    """Launch the parse of ``csrc/gdeflate_vdecode.cu`` on ``comp``'s card, on
    the current stream (same outputs as :func:`parse_plain`)."""
    _on_card(comp, "parse")
    if comp.dtype != torch.uint8 or comp.dim() != 2:
        raise ValueError(f"comp must be uint8[B, cap], got {comp.dtype}{list(comp.shape)}")
    B, comp_cap = comp.shape
    comp = comp.contiguous()
    R_cap = round_cap(out_cap)
    dev = comp.device
    tabs = torch.empty((B, NTAB), dtype=torch.int32, device=dev)
    tokens = torch.empty((B, R_cap * N_LANES), dtype=torch.int32, device=dev)
    sp = torch.empty((B,), dtype=torch.int32, device=dev)
    err = torch.empty((B,), dtype=torch.int32, device=dev)
    _call("parse", [_P, _I, _I, _I, _I, _P, _P, _P, _P],
          [comp, B, comp_cap, R_cap, _max_dw(comp_cap), tabs, tokens, sp, err], dev)
    parse_kernel.launches += 1
    return tabs, tokens, sp, err


def exec_kernel(tokens: torch.Tensor, n_tok: torch.Tensor, out_cap: int):
    """Launch the replay of ``csrc/gdeflate_vdecode.cu`` (same outputs as
    :func:`exec_plain`)."""
    _on_card(tokens, "replay")
    if tokens.dtype != torch.int32 or tokens.dim() != 2:
        raise ValueError(f"tokens must be int32[B, n], got {tokens.dtype}{list(tokens.shape)}")
    B, ntok_cap = tokens.shape
    dev = tokens.device
    if n_tok.shape != (B,):
        raise ValueError(f"n_tok must be int32[{B}]")
    tokens = tokens.contiguous()
    n_tok = n_tok.to(device=dev, dtype=torch.int32).clamp(0, ntok_cap).contiguous()
    out = torch.empty((B, out_cap), dtype=torch.uint8, device=dev)
    op = torch.empty((B,), dtype=torch.int32, device=dev)
    derr = torch.empty((B,), dtype=torch.int32, device=dev)
    _call("exec", [_P, _P, _I, _I, _P, _I, _P, _P],
          [tokens, n_tok, B, ntok_cap, out, out_cap, op, derr], dev)
    exec_kernel.launches += 1
    return out, op, derr


parse_kernel.launches = 0
exec_kernel.launches = 0


# --- the wrappers --------------------------------------------------------------------

def _compose(comp, comp_sizes, out_cap, tabs, sp, perr, out, op_fin, derr):
    """The reference's final composition (``gdeflate_vdecode.py:435-467``):
    scan and distance errors gate ``ERROR_OUTPUT_BUFFER_TOO_SMALL``;
    everything else fails as ``ERROR_CANNOT_DECOMPRESS``.  int32, as the
    reference (sums wrap)."""
    B, comp_cap = comp.shape
    btype, n_tok, raw, dw_start = tabs[:, 0], tabs[:, 1], tabs[:, 2], tabs[:, 3]
    tbl_ok = tabs[:, 4] != 0
    comp_sizes = comp_sizes.to(device=comp.device, dtype=torch.int32)
    err = ((perr & 1) != 0) | (derr != 0)
    ok = ((btype != 0) & (btype <= 2) & ~err & (op_fin == raw) & (raw <= out_cap)
          & (n_tok <= out_cap) & tbl_ok & ((perr & 2) == 0)
          & (comp_sizes >= dw_start + 4 * sp))
    is_stored = btype == 0
    stored_ok = is_stored & (raw <= out_cap) & (comp_sizes >= HDR + raw)
    stored = torch.nn.functional.pad(comp, (0, max(0, HDR + out_cap - comp_cap)))
    stored = stored[:, HDR:HDR + out_cap]
    too_big = ~is_stored & ~err & (raw > out_cap)
    good = torch.where(is_stored, stored_ok, ok)
    osz = torch.where(good, raw.clamp(0, out_cap), 0).to(torch.int32)
    stat = torch.where(good, int(Status.SUCCESS),
                       torch.where(too_big, int(Status.ERROR_OUTPUT_BUFFER_TOO_SMALL),
                                   int(Status.ERROR_CANNOT_DECOMPRESS))).to(torch.int32)
    opos = torch.arange(out_cap, device=comp.device)
    res = torch.where(is_stored[:, None], stored, out)
    res = torch.where(opos[None, :] < osz[:, None], res, 0).to(torch.uint8)
    return res, osz, stat


def _decompress(parse, execute, comp, comp_sizes, out_cap):
    tabs, tokens, sp, perr = parse(comp, comp_sizes, out_cap)
    n_tok_eff = torch.minimum(tabs[:, 1], torch.tensor(tokens.shape[1], dtype=torch.int32,
                                                       device=tabs.device))
    out, op_fin, derr = execute(tokens, n_tok_eff, out_cap)
    return _compose(comp, comp_sizes, out_cap, tabs, sp, perr, out, op_fin, derr)


def decompress_batch(comp: torch.Tensor, comp_sizes: torch.Tensor, out_cap: int):
    """The two kernels, then the status composition, all on ``comp``'s card.
    Raises for tensors that are not on a CUDA device (:func:`parse_kernel`'s
    check)."""
    return _decompress(parse_kernel, exec_kernel, comp, comp_sizes, out_cap)


def decompress_batch_plain(comp: torch.Tensor, comp_sizes: torch.Tensor, out_cap: int):
    """Plain version of :func:`decompress_batch`; tensors on ``comp``'s device."""
    return _decompress(parse_plain, exec_plain, comp, comp_sizes, out_cap)
