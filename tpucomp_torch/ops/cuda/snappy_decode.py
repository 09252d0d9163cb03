"""Batched Snappy block decode: the Hopper kernels and their plain versions.

Port of :mod:`tpucomp.ops.pallas.snappy_decode` (``decompress_batch`` /
``_kernel``).  The kernels are in ``csrc/snappy_decode.cu`` (its header says
what they replace, what bounds them and how they are built):
:func:`decompress_batch` launches the parse, one CTA a chunk, where the
shape fits its shared memory (:func:`parse_fits`: ``out_cap <= 65536`` and a
row of at most 81920 bytes, every shape the batched API makes at its 64 KiB
chunk size), and otherwise the walk, one warp a chunk
(:func:`decompress_batch_walk`); the choice is made once a call, by shape.
The plain version walks each chunk's elements in Python with the same
semantics, statuses included (:func:`_decode_chunk`); the CPU tests hold it
against the reference and the parse's plain pieces against it
(:func:`element_lengths_plain`, :func:`block_leavers_plain`,
:func:`chain_plain`, :func:`status_plain`, :func:`sources_plain`, composed by
:func:`decode_chunk_parse_plain`), and
``chip_smoke.py`` holds both kernels against it.

Contract (same as the reference): ``comp uint8[B, comp_cap]`` plus
``comp_sizes int32[B]`` -> ``(out uint8[B, out_cap], out_sizes int32[B],
statuses int32[B])``; bytes past each chunk's output size are zero, a corrupt
chunk gives ``ERROR_CANNOT_DECOMPRESS`` and size 0, a chunk whose preamble
exceeds ``out_cap`` gives ``ERROR_OUTPUT_BUFFER_TOO_SMALL`` and size 0.

The reference reads tag bytes through int32 words of the row padded to
``wpad = round_up(max(comp_cap, 8), 4)`` bytes, with the word index clipped
(``snappy_decode.py:34-49``); a tag in the last word of that padding reads
the bytes 4 before it.  All versions here read through the same clipped
words, so they give the reference's status there too (``ROADMAP.md`` §C).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpucomp_torch.chunk import wrap_i32
from tpucomp_torch.constants import Status
from tpucomp_torch.ops.cuda import _build


def _decode_chunk(row: bytes, csize: int, out_cap: int,
                  trace: list | None = None) -> tuple[bytearray, int, int]:
    """One chunk -> (output row of out_cap bytes, size, status).  ``row`` is
    the chunk's whole row of ``comp_cap`` bytes.  ``trace`` (a list) gets
    ``(ip, op)`` at every element the walk reads."""
    comp_cap = len(row)
    wpad = (max(comp_cap, 8) + 3) // 4 * 4
    words = row + bytes(wpad - comp_cap)       # the reference's padded words
    nw = wpad // 4

    def getb(i: int) -> int:
        ic = min(max(i, 0), wpad - 1)
        return words[(ic & ~3) | (i & 3)]

    expected, more, pre_len = words[0] & 0x7F, words[0] & 0x80, 1
    for k in range(1, 5):
        if more:
            expected |= (words[k] & 0x7F) << (7 * k)
            pre_len += 1
            more = words[k] & 0x80
    expected = wrap_i32(expected)
    err = bool(more) or csize < pre_len or expected < 0
    too_big = not err and expected > out_cap

    out = bytearray(out_cap)
    ip, op = (csize if err else pre_len), 0
    # past out_cap + 1 the end check must fail (op only grows): stop there
    while not err and ip < csize and op <= out_cap + 1:
        if trace is not None:
            trace.append((ip, op))
        base = 4 * min(ip >> 2, nw - 2) + (ip & 3)
        tag, b1, b2, b3 = words[base:base + 4]
        t6 = tag >> 2
        if tag & 3 == 0:                       # literal
            extra = min(max(t6 - 59, 0), 4)
            acc = b1 | (b2 << 8 if extra > 1 else 0) | (b3 << 16 if extra > 2 else 0) \
                | (getb(ip + 4) << 24 if extra > 3 else 0)
            ll = wrap_i32(acc) + 1 if extra else t6 + 1
            src = ip + 1 + extra
            err = ll < 1 or src + ll > csize
            if not err and op + ll <= out_cap:
                lit = row[src:src + ll]        # reads past comp_cap give 0
                out[op:op + ll] = lit + bytes(ll - len(lit))
            ip, op = src + ll, op + ll
            continue
        if tag & 3 == 1:                       # copy-1
            ml, off, hdr = (t6 & 7) + 4, ((tag >> 5) << 8) | b1, 2
        elif tag & 3 == 2:                     # copy-2
            ml, off, hdr = t6 + 1, b1 | (b2 << 8), 3
        else:                                  # copy-4
            ml, hdr = t6 + 1, 5
            off = wrap_i32(b1 | (b2 << 8) | (b3 << 16) | (getb(ip + 4) << 24))
        err = ip + hdr > csize or off <= 0 or off > op
        if not err and op + ml <= out_cap:
            pat = out[op - off:op]
            out[op:op + ml] = (pat * (ml // off + 1))[:ml] if off < ml else pat[:ml]
        ip, op = ip + hdr, op + ml
    err = (err or op != min(max(expected, 0), out_cap + 1)) and not too_big
    if err or too_big:
        return bytearray(out_cap), 0, int(Status.ERROR_OUTPUT_BUFFER_TOO_SMALL
                                          if too_big else Status.ERROR_CANNOT_DECOMPRESS)
    return out, op, int(Status.SUCCESS)


# --- the parse's pieces, plain -------------------------------------------------------
# The parse kernel does not walk: every position gets the length its element
# would have if a tag started there, the chain of element starts follows
# from those lengths, the status from a prefix sum of the output lengths,
# and the bytes from each output byte's source, resolved by pointer jumping.
# These are those phases' plain versions, one chunk at a time; the CPU tests
# hold them against :func:`_decode_chunk`.

def _words(row: bytes) -> tuple[np.ndarray, int]:
    """The row padded to ``wpad`` bytes (the reference's words), and wpad."""
    wpad = (max(len(row), 8) + 3) // 4 * 4
    return np.frombuffer(row + bytes(wpad - len(row)), np.uint8).astype(np.int64), wpad


def _elements(w: np.ndarray, wpad: int, xs: np.ndarray, csize: int) -> dict:
    """The elements whose tags are at positions ``xs`` (int64), read as the
    walk reads them: ``in`` (the stream length), ``out`` (the bytes
    written), ``lit`` (a literal's first byte, -1 for a copy), ``off`` and
    ``ok`` (the element's own check) -- arrays."""
    nw = wpad // 4
    base = 4 * np.minimum(xs >> 2, nw - 2) + (xs & 3)
    tag, b1, b2, b3 = (w[base + k] for k in range(4))
    ic = np.clip(xs + 4, 0, wpad - 1)
    b4 = w[(ic & ~3) | ((xs + 4) & 3)]
    t6, kind = tag >> 2, tag & 3
    extra = np.clip(t6 - 59, 0, 4)
    acc = (b1 | np.where(extra > 1, b2 << 8, 0) | np.where(extra > 2, b3 << 16, 0)
           | np.where(extra > 3, b4 << 24, 0))
    acc = np.where(acc >= 1 << 31, acc - (1 << 32), acc)                 # int32
    ll = np.where(extra > 0, acc + 1, t6 + 1)
    off4 = b1 | (b2 << 8) | (b3 << 16) | (b4 << 24)
    off = np.select([kind == 1, kind == 2, kind == 3],
                    [((tag >> 5) << 8) | b1, b1 | (b2 << 8),
                     np.where(off4 >= 1 << 31, off4 - (1 << 32), off4)], 0)
    hdr = np.select([kind == 1, kind == 2], [2, 3], 5)
    lit = kind == 0
    s = xs + 1 + extra
    return {"in": np.where(lit, 1 + extra + ll, hdr),
            "out": np.select([lit, kind == 1], [ll, (t6 & 7) + 4], t6 + 1),
            "lit": np.where(lit, s, -1), "off": off,
            "ok": np.where(lit, (ll >= 1) & (s + ll <= csize), (xs + hdr <= csize) & (off > 0))}


def _preamble(w: np.ndarray, csize: int) -> tuple[int, int, bool]:
    """(length, expected as int32, broken) of the varint32 preamble."""
    expected, more, n = int(w[0]) & 0x7F, int(w[0]) & 0x80, 1
    for k in range(1, 5):
        if more:
            expected |= (int(w[k]) & 0x7F) << (7 * k)
            n += 1
            more = int(w[k]) & 0x80
    expected = wrap_i32(expected)
    return n, expected, bool(more) or csize < n or expected < 0


def element_lengths_plain(row: bytes, csize: int) -> tuple[int, int, np.ndarray]:
    """Phase 2: ``(pre_len, np, d)``: for every position ``x`` in ``[pre_len,
    np)``, ``np = min(csize, wpad)``, ``d[x - pre_len]`` the length in the
    stream of the element whose tag would be at ``x``, 0 where it fails its
    own check."""
    w, wpad = _words(row)
    pre_len = _preamble(w, csize)[0]
    np_ = min(csize, wpad)
    xs = np.arange(pre_len, max(np_, pre_len), dtype=np.int64)
    e = _elements(w, wpad, xs, csize)
    return pre_len, np_, np.where(e["ok"], e["in"], 0)


BLOCK = 128    # positions a block of the parse's leavers (kBlk in csrc/snappy_decode.cu)


def block_leavers_plain(pre_len: int, np_: int, d: np.ndarray) -> np.ndarray:
    """Phase 3a: for every position ``x`` in ``[pre_len, np)`` (index ``x``
    of the result), the offset in its block of ``BLOCK`` positions of the
    chain's last element there from ``x`` (its leaver: its next is past the
    block or at or past np), -1 where the chain meets an element that fails
    its check; by six rounds of pointer jumping (a block holds at most 64
    elements)."""
    out = np.full(max(np_, pre_len), -1, np.int64)
    xs = np.arange(pre_len, np_, dtype=np.int64)
    if xs.size == 0:
        return out
    b0 = xs & ~(BLOCK - 1)
    nxt = xs + d
    out[pre_len:] = np.where(d == 0, -1, np.where((nxt >= b0 + BLOCK) | (nxt >= np_), xs - b0,
                                                  nxt - b0))
    for _ in range(6):
        v = out[pre_len:]
        out[pre_len:] = np.where(v >= 0, out[b0 + np.maximum(v, 0)], -1)
    return out


def chain_plain(pre_len: int, np_: int, d: np.ndarray) -> tuple[list, str, int]:
    """Phase 3b-c: the chain from ``pre_len`` through ``x + d[x]``: one lane
    goes from leaver to leaver (:func:`block_leavers_plain`), which gives
    each block's entry; each entered block's elements follow from its entry
    -> ``(starts, end, at)``: the element starts in ``[pre_len, np)`` that
    pass their own check, and how the chain ends: ``"bad"`` (the element at
    ``at`` fails its check) or ``"end"`` (the last one ends at ``at``: at
    csize, or past np where the tail goes on)."""
    if np_ <= pre_len:
        return [], "end", pre_len
    leav = block_leavers_plain(pre_len, np_, d)
    entries, e, end, at = [], pre_len, "end", pre_len
    while True:
        b0 = e & ~(BLOCK - 1)
        entries.append(e)
        if leav[e] < 0:
            end = "bad"
            break
        y = b0 + int(leav[e])
        z = y + int(d[y - pre_len])
        if z >= np_:
            at = z
            break
        e = z
    starts = []
    for e in entries:
        y, stop = e, min((e & ~(BLOCK - 1)) + BLOCK, np_)
        while y < stop:
            if d[y - pre_len] == 0:
                return starts, "bad", y
            starts.append(y)
            y += int(d[y - pre_len])
    return starts, end, at


def _tail_walk(w: np.ndarray, wpad: int, x: int, csize: int, cap1: int, op: int):
    """The kernel's tail walk from ``x >= wpad``: ``(ok, op)``, whole cycles
    of elements skipped once a position's ``x & 3`` comes round again."""
    seen = {}
    skipped = False
    while x < csize:
        if op > cap1:
            return False, op
        r = x & 3
        if not skipped and r in seen:
            dx, dop = x - seen[r][0], op - seen[r][1]
            k = max(0, min((csize - x) // dx, (cap1 - op) // dop) - 1)
            x, op, skipped = x + k * dx, op + k * dop, True
        seen[r] = (x, op)
        e = {k: int(v[0]) for k, v in _elements(w, wpad, np.array([x]), csize).items()}
        if not e["ok"] or (e["lit"] < 0 and e["off"] > op):
            return False, op
        x, op = x + e["in"], op + e["out"]
    return True, op


def status_plain(row: bytes, csize: int, out_cap: int, starts: list, end: str,
                 at: int) -> tuple[int, int, np.ndarray, int]:
    """Phase 4: ``(status, size, ops, row_total)``: ``ops`` the output
    offset of each start (an exclusive prefix sum of the output lengths),
    each copy's offset checked against it, the tail walked past the row;
    SUCCESS when nothing fails and the total is the preamble's value."""
    w, wpad = _words(row)
    pre_len, expected, broken = _preamble(w, csize)
    if broken:
        return int(Status.ERROR_CANNOT_DECOMPRESS), 0, np.zeros(0, np.int64), 0
    if expected > out_cap:
        return int(Status.ERROR_OUTPUT_BUFFER_TOO_SMALL), 0, np.zeros(0, np.int64), 0
    e = _elements(w, wpad, np.array(starts, np.int64), csize)
    ops = np.cumsum(e["out"]) - e["out"]
    row_total = int(e["out"].sum())
    ok = end != "bad" and not np.any((e["lit"] < 0) & (e["off"] > ops))
    total = row_total
    if ok and end == "end" and at < csize:              # the tail, past wpad
        ok, total = _tail_walk(w, wpad, at, csize, out_cap + 1, total)
    if not (ok and total == expected):
        return int(Status.ERROR_CANNOT_DECOMPRESS), 0, ops, row_total
    return int(Status.SUCCESS), expected, ops, row_total


def sources_plain(row: bytes, csize: int, size: int, starts: list, ops: np.ndarray,
                  tail: int, row_total: int) -> tuple[np.ndarray, np.ndarray, int]:
    """Phase 5 on success: the window (each literal's bytes at its output
    offsets; bytes past comp_cap read 0) and each output byte's source from
    the last run start ``s0`` at or before it and its distance ``d`` (a run:
    a literal, or copies in a row at one offset, which are one copy): its
    own offset for a literal's byte, ``s0 - d + (o - s0) mod d`` for a
    copied one (the tail's elements placed after the row's); then pointer
    jumping, ``src = src[src]`` until every source is a literal's ->
    ``(window, roots, rounds)``."""
    w, wpad = _words(row)
    comp = np.frombuffer(row, np.uint8)
    win = np.zeros(size, np.uint8)
    xs, os_ = list(starts), ops.tolist()
    x, o = tail, row_total
    while 0 <= x < csize:                                # the tail's elements
        xs.append(x)
        os_.append(o)
        e = {k: int(v[0]) for k, v in _elements(w, wpad, np.array([x]), csize).items()}
        x, o = x + e["in"], o + e["out"]
    e = _elements(w, wpad, np.array(xs, np.int64), csize)
    first = np.zeros(size, bool)                         # each run's output start
    dist = np.zeros(size, np.int64)                      # and its bytes' source distance
    prev = None
    for o, n, lit, off in zip(os_, e["out"].tolist(), e["lit"].tolist(), e["off"].tolist()):
        if lit >= 0 or off != prev:                      # a copy at the offset before it
            first[o] = True                              # continues that copy's run
            dist[o] = off if lit < 0 else 0
        prev = off if lit < 0 else None
        if lit >= 0:
            part = comp[lit:min(lit + n, len(comp))]
            win[o:o + len(part)] = part
    o = np.arange(size, dtype=np.int64)
    s0 = np.maximum.accumulate(np.where(first, o, 0))    # the last run start
    d = dist[s0]
    src = np.where(d > 0, s0 - d + (o - s0) % np.maximum(d, 1), o)
    rounds = 0
    while np.any(src[src] != src):
        src = src[src]
        rounds += 1
    return win, src, rounds


def decode_chunk_parse_plain(row: bytes, csize: int, out_cap: int) -> tuple[bytearray, int, int]:
    """The parse kernel's phases composed: :func:`_decode_chunk`'s result."""
    pre_len, np_, d = element_lengths_plain(row, csize)
    starts, end, at = chain_plain(pre_len, np_, d)
    status, size, ops, row_total = status_plain(row, csize, out_cap, starts, end, at)
    out = bytearray(out_cap)
    if status == int(Status.SUCCESS):
        tail = at if end == "end" and at < csize else -1
        win, roots, _ = sources_plain(row, csize, size, starts, ops, tail, row_total)
        out[:size] = win[roots].tobytes()
    return out, size, status


def decompress_batch_plain(comp: torch.Tensor, comp_sizes: torch.Tensor,
                           out_cap: int):
    """Plain version of the kernel: the same function, walked in Python on the
    host.  Returns tensors on ``comp``'s device."""
    data = comp.cpu().numpy()
    sizes = comp_sizes.cpu().numpy().astype(np.int64)
    B = data.shape[0]
    out = np.zeros((B, out_cap), np.uint8)
    osz = np.zeros(B, np.int32)
    stat = np.zeros(B, np.int32)
    for i in range(B):
        row, osz[i], stat[i] = _decode_chunk(data[i].tobytes(), int(sizes[i]), out_cap)
        out[i] = np.frombuffer(row, np.uint8)
    dev = comp.device
    return (torch.from_numpy(out).to(dev), torch.from_numpy(osz).to(dev),
            torch.from_numpy(stat).to(dev))


PARSE_MAX_OUT = 65536     # the parse's output window (kMaxOut in csrc/snappy_decode.cu)
PARSE_MAX_COMP = 81920    # its padded compressed row, wpad (kMaxComp)


def parse_fits(comp_cap: int, out_cap: int) -> bool:
    """Whether the parse kernel takes this shape (its shared memory):
    ``out_cap <= 65536`` and ``round_up(max(comp_cap, 8), 4) <= 81920``."""
    return out_cap <= PARSE_MAX_OUT and (max(comp_cap, 8) + 3) // 4 * 4 <= PARSE_MAX_COMP


def _launch(entry: str, comp: torch.Tensor, comp_sizes: torch.Tensor, out_cap: int):
    if comp.device.type != "cuda":
        raise ValueError(f"the Snappy decode kernels need CUDA tensors, got {comp.device}")
    if comp.dtype != torch.uint8 or comp.dim() != 2:
        raise ValueError(f"comp must be uint8[B, cap], got {comp.dtype}{list(comp.shape)}")
    B, comp_cap = comp.shape
    if comp_sizes.shape != (B,):
        raise ValueError(f"comp_sizes must be int32[{B}], got {list(comp_sizes.shape)}")
    comp = comp.contiguous()
    comp_sizes = comp_sizes.to(device=comp.device, dtype=torch.int32).contiguous()
    out = torch.empty((B, out_cap), dtype=torch.uint8, device=comp.device)
    osz = torch.empty((B,), dtype=torch.int32, device=comp.device)
    stat = torch.empty((B,), dtype=torch.int32, device=comp.device)
    fn = getattr(_build.load("snappy_decode"), entry)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, i, p, i, p, p, p]
    fn.restype = i
    with torch.cuda.device(comp.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(comp.data_ptr(), comp_sizes.data_ptr(), B, comp_cap,
                out.data_ptr(), out_cap, osz.data_ptr(), stat.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: cudaError {rc}")
    return out, osz, stat


def decompress_batch(comp: torch.Tensor, comp_sizes: torch.Tensor, out_cap: int):
    """Decode on ``comp``'s card, on the current stream: the parse kernel
    where :func:`parse_fits` (counted here), else :func:`decompress_batch_walk`.
    Raises for tensors that are not on a CUDA device."""
    if comp.device.type == "cuda" and comp.dim() == 2 and not parse_fits(comp.shape[1], out_cap):
        return decompress_batch_walk(comp, comp_sizes, out_cap)
    got = _launch("tpucomp_snappy_decode_parse", comp, comp_sizes, out_cap)
    decompress_batch.launches += 1
    return got


def decompress_batch_walk(comp: torch.Tensor, comp_sizes: torch.Tensor, out_cap: int):
    """The walk kernel, one warp a chunk, for any shape (the one
    :func:`decompress_batch` takes where the parse does not fit)."""
    got = _launch("tpucomp_snappy_decode_walk", comp, comp_sizes, out_cap)
    decompress_batch_walk.launches += 1
    return got


decompress_batch.launches = 0
decompress_batch_walk.launches = 0
