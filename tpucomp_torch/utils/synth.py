"""Synthetic test/benchmark data generators (numpy only).

The port's copy of :mod:`tpucomp.utils.synth`: the same bytes for the same
seed (checked by ``tests/test_torch_core.py``).

Mirrors the reference's fixtures: ``gen_data(max_byte, size, rng)`` with an entropy
knob (``benchmarks/benchmark_common.h:158-175``), all-zeros / uniform-random ladders
(``benchmarks/benchmark_lz4_synth.cpp:63-73``), and numeric-column distributions for
the Cascaded codec (``benchmarks/text_to_binary.py``).  All generators take explicit
seeds for reproducibility (reference uses fixed mt19937 seeds).
"""
from __future__ import annotations

import numpy as np


def gen_data(max_byte: int, size: int, seed: int = 0) -> np.ndarray:
    """Uniform bytes in [0, max_byte] — entropy dialed by byte range."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, max_byte + 1, size=size, dtype=np.uint8) \
        if max_byte > 0 else np.zeros(size, dtype=np.uint8)


_WORDS = [
    b"the", b"of", b"and", b"a", b"to", b"in", b"is", b"you", b"that", b"it",
    b"he", b"was", b"for", b"on", b"are", b"as", b"with", b"his", b"they",
    b"compression", b"throughput", b"benchmark", b"parallel", b"kernel",
    b"device", b"tensor", b"processing", b"unit", b"systolic", b"pipeline",
    b"lossless", b"entropy", b"dictionary", b"sequence", b"literal", b"match",
]


def text_like(size: int, seed: int = 0) -> np.ndarray:
    """English-ish text with word repetition (LZ-compressible, realistic match lens).

    The same bytes as the reference's word-at-a-time loop, drawn in bulk: each
    word takes two uniform doubles from the generator, one for the
    Zipf-weighted choice (``Generator.choice`` with ``p`` searches the CDF with
    one ``random()``) and one for the newline test.
    """
    rng = np.random.default_rng(seed)
    # Zipf-ish distribution over the vocabulary
    probs = 1.0 / np.arange(1, len(_WORDS) + 1)
    probs /= probs.sum()
    cdf = probs.cumsum()
    cdf /= cdf[-1]
    table = [w + b" " for w in _WORDS] + [w + b" \n" for w in _WORDS]
    out, n = [], 0
    while n < size:
        k = max(1024, (size - n) // 4)
        u = rng.random(2 * k).reshape(k, 2)
        ids = cdf.searchsorted(u[:, 0], side="right") + len(_WORDS) * (u[:, 1] < 0.08)
        piece = b"".join(map(table.__getitem__, ids.tolist()))
        out.append(piece)
        n += len(piece)
    return np.frombuffer(b"".join(out)[:size], dtype=np.uint8)


def runs(size: int, mean_run: int = 64, seed: int = 0) -> np.ndarray:
    """Run-heavy bytes (RLE/long-match stress, mortgage-col0-like)."""
    rng = np.random.default_rng(seed)
    out = np.zeros(size, dtype=np.uint8)
    pos = 0
    while pos < size:
        run = int(rng.exponential(mean_run)) + 1
        val = rng.integers(0, 4, dtype=np.uint8) if rng.random() < 0.9 else \
            rng.integers(0, 256, dtype=np.uint8)
        out[pos:pos + run] = val
        pos += run
    return out


def sorted_ints(size_bytes: int, dtype=np.int64, start: int = 10_000,
                max_step: int = 8, seed: int = 0) -> np.ndarray:
    """Sorted integer column (delta-friendly; Cascaded's sweet spot)."""
    rng = np.random.default_rng(seed)
    n = size_bytes // np.dtype(dtype).itemsize
    steps = rng.integers(0, max_step + 1, size=n, dtype=np.int64)
    vals = start + np.cumsum(steps)
    return vals.astype(dtype).view(np.uint8)


def low_cardinality_ints(size_bytes: int, dtype=np.int32, cardinality: int = 10,
                         seed: int = 0) -> np.ndarray:
    """Repeated categorical integer column (RLE-friendly)."""
    rng = np.random.default_rng(seed)
    n = size_bytes // np.dtype(dtype).itemsize
    vocab = rng.integers(0, 1 << 20, size=cardinality, dtype=np.int64)
    # long runs of identical values
    idx = np.repeat(rng.integers(0, cardinality, size=max(1, n // 50)), 50)[:n]
    if idx.size < n:
        idx = np.pad(idx, (0, n - idx.size), mode="edge")
    return vocab[idx].astype(dtype).view(np.uint8)


def mixed_corpus(total_size: int, seed: int = 0) -> np.ndarray:
    """Deterministic Silesia-like mixture: text, runs, binary columns, random.

    Used as the benchmark corpus when the real Silesia tarball is unavailable
    (no network egress); the mixture of entropies approximates Silesia's spread.
    """
    part = total_size // 5
    pieces = [
        text_like(part, seed=seed),
        runs(part, seed=seed + 1),
        sorted_ints(part, seed=seed + 2),
        low_cardinality_ints(part, seed=seed + 3),
        gen_data(15, total_size - 4 * part, seed=seed + 4),
    ]
    return np.concatenate(pieces)


def mortgage_like(size_bytes: int, seed: int = 0) -> np.ndarray:
    """Synthetic analog of the reference's headline dataset
    (mortgage-2009Q2 col0-long, ``doc/Benchmarks.md:80-95``): an int64
    column of loan-balance-like values — long runs of repeated values from a
    slowly drifting base.  Tuned so liblz4 lands at the reference dataset's
    compression ratio neighborhood (~39:1)."""
    rng = np.random.default_rng(seed)
    n = size_bytes // 8
    # geometric-ish run lengths (mean ~46 values = ~370 bytes/run)
    n_runs = max(1, n // 46)
    runs_len = rng.geometric(1.0 / 46, size=2 * n_runs)
    vals = 150_000_00 + np.cumsum(rng.integers(-2000, 2000, size=2 * n_runs,
                                               dtype=np.int64))
    col = np.repeat(vals, runs_len)[:n]
    if col.size < n:
        col = np.pad(col, (0, n - col.size), mode="edge")
    return col.astype(np.int64).view(np.uint8)
