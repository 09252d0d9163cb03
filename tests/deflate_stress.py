"""Deflate streams that stress a decoder's 32 KiB window and its block loop.

Shared by ``tests/test_torch_deflate_window.py`` (the plain decoder against
zlib's inflate), ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` (the
kernel against the plain decoder).  numpy and zlib only; every stream is
made from a fixed seed.

- ``twice``: one random 32 KiB block written twice, as a stored block and a
  fixed-Huffman block whose 128 matches all reach exactly 32,768 bytes back
  (zlib never goes past 32,506); ``twice_zlib``: zlib 9 of 32,000 random
  bytes written twice and again in part;
- ``stored_max``: one stored block of 65,535 bytes; ``stored_zlib0``: zlib
  level 0 (stored blocks) of 64 KiB;
- ``multiblock``: zlib 6 with a ``Z_FULL_FLUSH`` every 16 KiB (five blocks,
  the window reset at each flush) of text, runs and random bytes;
- ``literals``: ``Z_HUFFMAN_ONLY``, 64 KiB of literals and no match;
- ``rle``: ``Z_RLE``, distance-1 matches only; ``periods``: a fixed block
  of matches at every distance below 32, at lengths 3 to 258;
- ``fixed``: ``Z_FIXED``, several fixed-Huffman blocks in a row;

and each of them as a gzip member (``window_members``).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

OUT_CAP_ABOVE = 65536 + 4099   # an out_cap above 64 KiB that is not a multiple of 16

_LEN_BASE = [3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35, 43, 51, 59, 67,
             83, 99, 115, 131, 163, 195, 227, 258]
_LEN_EXTRA = [0] * 8 + [1] * 4 + [2] * 4 + [3] * 4 + [4] * 4 + [5] * 4 + [0]
_DIST_BASE = [1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193, 257, 385, 513, 769,
              1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385, 24577]
_DIST_EXTRA = [0, 0, 0, 0] + [k // 2 for k in range(2, 28)]


class _Bits:
    """An LSB-first bit writer."""

    def __init__(self):
        self.acc, self.n, self.out = 0, 0, bytearray()

    def put(self, value: int, nbits: int) -> None:
        self.acc |= value << self.n
        self.n += nbits
        while self.n >= 8:
            self.out.append(self.acc & 0xFF)
            self.acc >>= 8
            self.n -= 8

    def code(self, code: int, nbits: int) -> None:   # Huffman codes go MSB first
        self.put(int(f"{code:0{nbits}b}"[::-1], 2), nbits)

    def align(self) -> None:
        if self.n:
            self.put(0, 8 - self.n)

    def stored(self, data: bytes, final: bool) -> None:
        self.put(int(final), 1)
        self.put(0, 2)
        self.align()
        self.put(len(data), 16)
        self.put(len(data) ^ 0xFFFF, 16)
        self.out += data

    def fixed(self, tokens, final: bool) -> None:
        """tokens: ints (literals) and (length, distance) pairs."""
        self.put(int(final), 1)
        self.put(1, 2)
        for t in tokens + [256]:
            if isinstance(t, tuple):
                mlen, dist = t
                li = max(i for i, b in enumerate(_LEN_BASE) if b <= mlen)
                self._lit(257 + li)
                self.put(mlen - _LEN_BASE[li], _LEN_EXTRA[li])
                di = max(i for i, b in enumerate(_DIST_BASE) if b <= dist)
                self.code(di, 5)
                self.put(dist - _DIST_BASE[di], _DIST_EXTRA[di])
            else:
                self._lit(t)

    def _lit(self, sym: int) -> None:
        if sym < 144:
            self.code(0x30 + sym, 8)
        elif sym < 256:
            self.code(0x190 + sym - 144, 9)
        elif sym < 280:
            self.code(sym - 256, 7)
        else:
            self.code(0xC0 + sym - 280, 8)

    def bytes(self) -> bytes:
        self.align()
        return bytes(self.out)


def _zlib(raw: bytes, level: int = 6, strategy: int = zlib.Z_DEFAULT_STRATEGY,
          flush_every: int = 0) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15, 8, strategy)
    step = flush_every or len(raw) or 1
    out = b"".join(co.compress(raw[i:i + step]) + (co.flush(zlib.Z_FULL_FLUSH)
                                                    if flush_every else b"")
                   for i in range(0, len(raw), step))
    return out + co.flush()


def _text(rng: np.random.Generator, n: int) -> bytes:
    words = [bytes(rng.integers(97, 123, int(k), dtype=np.uint8)) + b" "
             for k in rng.integers(2, 9, 300)]
    ids = rng.zipf(1.3, n // 3) % len(words)
    return b"".join(words[i] for i in ids)[:n]


def window_streams(seed: int = 12) -> list[tuple[str, bytes, bytes]]:
    """(name, raw deflate stream, decoded bytes) for each stress input."""
    rng = np.random.default_rng(seed)
    half = rng.integers(0, 256, 32768, dtype=np.uint8).tobytes()
    w = _Bits()
    w.stored(half, final=False)
    w.fixed([(258, 32768)] * 126 + [(257, 32768), (3, 32768)], final=True)
    twice = half + half
    near = half[:32000] * 2 + half[:1536]          # zlib's matches reach 32,000 back
    big = rng.integers(0, 256, 65535, dtype=np.uint8).tobytes()
    ws = _Bits()
    ws.stored(big, final=True)
    mixed = (_text(rng, 24576) + bytes(rng.integers(0, 4, 8192, dtype=np.uint8).repeat(2))
             + rng.integers(0, 256, 8192, dtype=np.uint8).tobytes() + _text(rng, 16384))
    skewed = np.minimum(rng.geometric(0.08, 65536), 255).astype(np.uint8).tobytes()
    periods = [int(b) for b in rng.integers(0, 256, 64)]
    periods += [(int(n), d) for d in range(1, 32) for n in (3, d, 31, 32, 33, 95, 258)
                if n >= 3]
    wp = _Bits()
    wp.fixed(periods * 4, final=True)
    runs = np.repeat(rng.integers(0, 256, 700, dtype=np.uint8),
                     rng.integers(1, 190, 700))[:65536].tobytes()
    return [("twice", w.bytes(), twice),
            ("twice_zlib", _zlib(near, 9), near),
            ("stored_max", ws.bytes(), big),
            ("stored_zlib0", _zlib(mixed, 0), mixed),
            ("multiblock", _zlib(mixed, 6, flush_every=16384), mixed),
            ("literals", _zlib(skewed, 6, zlib.Z_HUFFMAN_ONLY), skewed),
            ("rle", _zlib(runs, 6, zlib.Z_RLE), runs),
            ("periods", wp.bytes(), _expand(periods * 4)),
            ("fixed", _zlib(mixed, 6, zlib.Z_FIXED), mixed)]


def _expand(tokens) -> bytes:
    out = bytearray()
    for t in tokens:
        if isinstance(t, tuple):
            for _ in range(t[0]):
                out.append(out[-t[1]])
        else:
            out.append(t)
    return bytes(out)


def gzip_member(stream: bytes, raw: bytes, name: bytes = b"") -> bytes:
    """A gzip member around a raw deflate stream; a name (FNAME) moves the
    stream's start past byte 10."""
    head = b"\x1f\x8b\x08" + bytes([0x08 if name else 0]) + b"\x00" * 4 + b"\x00\xff"
    return (head + (name + b"\x00" if name else b"") + stream
            + struct.pack("<II", zlib.crc32(raw), len(raw) & 0xFFFFFFFF))


def window_members() -> list[bytes]:
    """The stress streams as gzip members, every other one with a name, so
    the streams start at byte 10 or 22."""
    return [gzip_member(s, r, name=b"member%d.bin" % i if i % 2 else b"")
            for i, (_, s, r) in enumerate(window_streams())]


def corrupt(streams: list[bytes], seed: int = 5) -> list[bytes]:
    """Cut and bit-flipped copies: each stream cut to half, to one byte short
    and to 7 bytes, and with two single-bit flips."""
    rng = np.random.default_rng(seed)
    out = []
    for s in streams:
        out += [s[:len(s) // 2], s[:-1], s[:7]]
        for _ in range(2):
            b = bytearray(s)
            b[int(rng.integers(0, len(b)))] ^= 1 << int(rng.integers(0, 8))
            out.append(bytes(b))
    return out
