"""Snappy streams that stress the decoder's parallel element parse.

Shared by ``tests/test_torch_snappy_parse.py`` (the parse's plain pieces
against the serial walk ``snappy_decode._decode_chunk``),
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` (both decode kernels
against ``decompress_batch_plain``).  Every row is made from a fixed seed,
in rows of ``COMP_CAP`` bytes (the batched API's compressed row at a 64 KiB
chunk size; its padded row ``wpad`` is the same), some with a ``csize``
other than the stream's length:

- ``lit_extra_1`` .. ``lit_extra_4``: literals with 1-4 extra length bytes;
  ``lit_bit31``, ``lit_neg``, ``lit_huge``: a 4-byte length with bit 31 set
  (lengths 0 and -2^31 + 1) and one of 2^31 - 1 (past csize);
- ``copy4``: copy-4 elements, one with bit 31 set in its offset;
- ``off_eq_op``, ``off_op_plus1``: a copy's offset equal to the output
  before it (fine), and one past it (an error);
- ``periods``: a literal of p bytes and a 64-byte copy at offset p, for
  every period p below 64;
- ``tag_last_word_k``: the last element's tag at wpad - k (k 1-4): the
  reference reads it from the word before;
- ``past_comp_cap``, ``past_wpad``, ``past_wpad_far``, ``csize_max``: a
  good stream with csize past comp_cap, past wpad, past wpad + 2 x
  (out_cap + 2), and 2^31 - 1; ``tail_ok``: a stream whose chain goes on
  past wpad, where every element is one of four (copy-1s, 11 bytes at offset
  1), and ends at csize: it decodes;
- ``pre_5_bytes``, ``pre_negative``, ``pre_short``, ``too_big``: preamble
  errors (a continuation after 5 bytes, a negative value, a csize shorter
  than the preamble) and a preamble beyond out_cap;
- ``over_then_bad``: elements that pass out_cap + 1, then an offset of 0;
- ``incompressible``: 64 KiB of random bytes as 256-byte literals, its last
  tags past position 65,535; ``port_mixed``, ``port_mortgage``,
  ``port_random``: the port's encoder on a mixed, a mortgage and a random
  64 KiB chunk; ``copy_last_byte``, ``lit_last_byte``: 64 KiB whose last
  byte is a copy at offset 65,535 or a literal; ``empty``: a preamble of 0
  and nothing else.
"""
from __future__ import annotations

import numpy as np
import torch

from tpucomp_torch.chunk import ChunkBatch
from tpucomp_torch.formats import snappy as fsnappy
from tpucomp_torch.ops.cuda import snappy_encode2
from tpucomp_torch.utils import synth

CHUNK = 1 << 16
COMP_CAP = fsnappy.max_compressed_chunk_size(CHUNK)   # 76,800 (a multiple of 4: wpad)
OUT_CAPS = (CHUNK, 1000, CHUNK + 1024)   # the parse, too small, the walk (past 64 KiB)


def varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def literal(data: bytes) -> bytes:
    n = len(data) - 1
    if n < 60:
        return bytes([n << 2]) + data
    nb = (n.bit_length() + 7) // 8
    return bytes([(59 + nb) << 2]) + n.to_bytes(nb, "little") + data


def literal_extra(data: bytes, extra: int) -> bytes:
    """A literal with exactly ``extra`` length bytes (tag 59 + extra)."""
    return bytes([(59 + extra) << 2]) + (len(data) - 1).to_bytes(extra, "little") + data


def copy1(off: int, ml: int) -> bytes:
    return bytes([1 | ((ml - 4) << 2) | ((off >> 8) << 5), off & 0xFF])


def copy2(off: int, ml: int) -> bytes:
    return bytes([2 | ((ml - 1) << 2)]) + off.to_bytes(2, "little")


def copy4(off: int, ml: int) -> bytes:
    return bytes([3 | ((ml - 1) << 2)]) + (off & 0xFFFFFFFF).to_bytes(4, "little")


def _good(rng) -> tuple[bytes, int]:
    """A small valid body and its output length."""
    lit = rng.integers(0, 256, 40, dtype=np.uint8).tobytes()
    return literal(lit) + copy2(40, 64) + copy1(7, 11), 40 + 64 + 11


def _tag_last_word(k: int) -> bytes:
    """A stream of COMP_CAP bytes whose chain reaches a tag at wpad - k: a
    literal sized to land it there, copy-4 elements (5 bytes, 1 byte out),
    the last one's offset 0x105.  The reference reads that tag from the word
    before: the offset's bytes, a copy-1 of 5 bytes at offset 1 (two bytes),
    which ends the stream at k = 2."""
    at = COMP_CAP - k
    for lit_len in range(64, 69):
        n_copy = (at - 2 - (2 + lit_len)) // 5
        total = lit_len + n_copy + 5
        head = varint(total) + literal_extra(bytes(range(lit_len)), 1)
        if len(head) + 5 * n_copy == at:
            break
    stream = head + copy4(1, 1) * (n_copy - 1) + copy4(0x105, 1)
    return (stream + b"\x05\x01\x05\x01")[:COMP_CAP]


def _tail_ok() -> tuple[bytes, int]:
    """Copy-4s up to wpad - 8, then the bytes 1d 01 1d 01 (copy-1, off 1, 11
    bytes at residues 0 and 2): the chain goes on past wpad, where every
    element reads its tag from the last two words, and ends at csize."""
    body_end = COMP_CAP - 8
    steps_past = 300                                       # copy-1s from wpad - 8
    csize = body_end + 2 * steps_past
    for lit_len in range(1, 6):                            # preamble: 3 bytes
        if (body_end - 3 - (lit_len + 1)) % 5 == 0:
            break
    n_copy = (body_end - 3 - (lit_len + 1)) // 5
    out = lit_len + n_copy + 11 * steps_past
    stream = varint(out) + literal(b"a" * lit_len) + copy4(1, 1) * n_copy
    assert len(stream) == body_end, (len(stream), body_end)
    return stream + bytes([0x1D, 0x01, 0x1D, 0x01, 0, 0, 0, 0]), csize


def rows() -> list[tuple[str, bytes, int]]:
    """``(name, stream, csize)`` for every stress row."""
    rng = np.random.default_rng(16)
    good, n_good = _good(rng)
    out = []
    for extra in (1, 2, 3, 4):
        n = 200 if extra == 1 else 300
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        s = varint(n + 64) + literal_extra(data, extra) + copy2(n, 64)
        out.append((f"lit_extra_{extra}", s, len(s)))
    for name, length in (("lit_bit31", 0xFFFFFFFF), ("lit_neg", 0x80000000),
                         ("lit_huge", 0x7FFFFFFE)):
        s = varint(10) + bytes([63 << 2]) + length.to_bytes(4, "little") + b"x" * 10
        out.append((name, s, len(s)))
    s = varint(20 + 30 + 5) + literal(bytes(range(20))) + copy4(20, 30) + copy4(3, 5)
    out.append(("copy4", s, len(s)))
    s = varint(20 + 5) + literal(bytes(range(20))) + copy4(0x80000014, 5)
    out.append(("copy4_bit31", s, len(s)))
    s = varint(12 + 12) + literal(b"abcdefghijkl") + copy2(12, 12)
    out.append(("off_eq_op", s, len(s)))
    s = varint(12 + 12) + literal(b"abcdefghijkl") + copy2(13, 12)
    out.append(("off_op_plus1", s, len(s)))
    body, n = b"", 0
    for p in range(1, 64):
        body += literal(rng.integers(0, 256, p, dtype=np.uint8).tobytes()) + copy2(p, 64)
        n += p + 64
    out.append(("periods", varint(n) + body, len(varint(n) + body)))
    for k in (1, 2, 3, 4):
        s = _tag_last_word(k)
        out.append((f"tag_last_word_{k}", s, len(s)))
    s = varint(n_good) + good
    wpad = COMP_CAP
    out += [("past_comp_cap", s, COMP_CAP + 5), ("past_wpad", s, wpad + 100),
            ("past_wpad_far", s, wpad + 2 * (CHUNK + 2) + 7), ("csize_max", s, 2**31 - 1)]
    s, csize = _tail_ok()
    out.append(("tail_ok", s, csize))
    out += [("pre_5_bytes", b"\x80\x80\x80\x80\x80\x01" + good, 6 + len(good)),
            ("pre_negative", b"\x80\x80\x80\x80\x08" + good, 5 + len(good)),
            ("pre_short", varint(300) + good, 1),
            ("too_big", varint(CHUNK + 1) + good, len(varint(CHUNK + 1) + good))]
    body = literal(b"z" * 8) + copy2(8, 64) * 1030 + copy2(0, 4)
    out.append(("over_then_bad", varint(CHUNK) + body, len(varint(CHUNK) + body)))
    data = rng.integers(0, 256, CHUNK, dtype=np.uint8).tobytes()
    s = varint(CHUNK) + b"".join(literal_extra(data[i:i + 256], 1)
                                 for i in range(0, CHUNK, 256))
    out.append(("incompressible", s, len(s)))
    raws = {"port_mixed": synth.mixed_corpus(CHUNK, seed=16).tobytes(),
            "port_mortgage": synth.mortgage_like(CHUNK, seed=16).tobytes(),
            "port_random": rng.integers(0, 256, CHUNK, dtype=np.uint8).tobytes()}
    cb = ChunkBatch.from_chunks(list(raws.values()), CHUNK, device="cpu")
    comp, osz, _ = snappy_encode2.compress_batch_plain(cb.data, cb.sizes, COMP_CAP)
    for i, name in enumerate(raws):
        out.append((name, comp[i, :int(osz[i])].numpy().tobytes(), int(osz[i])))
    head = literal(b"a") + copy2(1, 64) * 1023 + copy2(1, 62)        # 65,535 bytes out
    for name, last in (("copy_last_byte", copy2(65535, 1)), ("lit_last_byte", literal(b"z"))):
        s = varint(CHUNK) + head + last
        out.append((name, s, len(s)))
    out.append(("empty", b"\x00", 1))
    return out


def batch() -> tuple[ChunkBatch, list[str]]:
    """The rows as one batch of ``COMP_CAP``-byte rows, each with its csize."""
    rs = rows()
    cb = ChunkBatch.from_chunks([s for _, s, _ in rs], COMP_CAP, device="cpu")
    cb.sizes[:] = torch.tensor([c for _, _, c in rs], dtype=torch.int32)
    return cb, [n for n, _, _ in rs]
