#!/usr/bin/env python3
"""On-card smoke run of tpucomp_torch: batched LZ4, Snappy, Deflate (algos
0, 1, 2), gzip decompress, Zstandard (up to 16 MiB chunks), GDeflate (algos
0, 1, 2), ANS and Cascaded, the reference's kernel variants that no dispatch
table reaches, the lowering probes, and the Manager frame path with CRC32
checksums, on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure ends the run with a non-zero
exit code and no result line:

1. device: name, count, and ``nvidia-smi``'s name and power limit;
2. build: the seventeen CUDA libraries from ``tpucomp_torch/ops/cuda/csrc`` (one
   ``nvcc`` each, in parallel), with their ``-Xptxas -v`` register/shared-memory
   lines, and the Deflate decoder's registers, shared memory, spills and CTAs
   an SM from the runtime;
3. kernel vs plain: each of the forty-five kernels on the card against its plain
   version on a host copy of the same inputs (<= 8 chunks per corpus at the
   main path's 64 KiB shape, edge and hand-made streams, truncated and
   bit-flipped streams, an out_cap that is too small; rows 3 and 4 (k 1, 3,
   4) against row 1's plain version, which is theirs, with an empty row and
   a size of -1; row 6, the Snappy decoder's parse and walk, also on the
   streams of tests/snappy_stress.py (extra length bytes, bit 31 set,
   copy-4, offsets at the output, every period below 64, a tag read from
   the word before, csizes past the row, preamble errors, an incompressible
   chunk) at out_caps 65536 and 1000 and, the walk alone (the shape the
   parse does not take), 66560; rows 5 and 8, the hash-table encoders, on the head chunks,
   a zero and a random row and cut and out-of-range sizes; row 15, the
   serial GDeflate decoder, on rows 13-14's tiles and two corrupt tiles of
   tests/test_torch_variants.py at out_cap 64 KiB and 256; for Deflate, zlib
   levels 0/1/6/9, libdeflate, a multi-block stream, gzip members through
   the decoder's ``starts``, the window stress streams of
   tests/deflate_stress.py (matches 32,768 back, a 65,535-byte stored
   block, multi-block streams also as gzip members, literal-only, every
   period below 32, cut and flipped copies) at out_cap 65535, 65536, 69635
   and 1000, and the encoder's three modes, with
   ``dyn_tables`` on the card against the CPU; for Zstandard decode, both
   wrappers (the two literal capacities) against the frame walk on libzstd
   frames at levels 1/3/19, edge, hand-made and corrupt frames, and the
   16 MiB wrapper on the first 16 MiB of each corpus at libzstd level 3,
   each pass kernel (chain, entropy, scan, resolve, the walk that settles
   frames too big for out_cap, zero, execute in its wide shape and, where
   every frame is one block, its narrow one) against its plain pass on the
   plain passes' own intermediates (one plain run an input), and the 16 MiB
   wrapper also on each corpus's first 16 MiB at levels 1 and 19 and on the
   port's own 16 MiB frame; the encoder's hist and full kernels
   on the head chunks, the edge inputs of tests/test_pallas_zstd.py and its
   64 KiB sequence-heavy chunk, in exact entropy at two out_caps and in the
   speed rung, with its tables on the card against the CPU, and both (the
   gated parse) on the chunks of tests/zstd_walk_stress.py and mixed's
   64 KiB chunks 850 and 1000, also repeated past the card's SM count (a
   CTA's scratch row reused); Deflate's hist and emit kernels (rows 11
   and 12) also on tests/gdeflate_walk_stress.py's chunks with 32 KiB
   candidates and those two mixed chunks, with matches and entropy only
   (emit at two out_caps); for GDeflate, the hist kernel (row 16) on the
   same chunks with 64 KiB candidates, with matches and entropy only,
   the hist and fixed/emit kernels and the whole encode in algos 0/1/2 on the
   head chunks, the edge rows of tests/test_pallas_gdeflate.py and a 64 KiB
   row with distances above 49152, at out_cap = bound and 4096, with
   ``dyn_tables_gd``, ``schedule_and_assemble`` and ``tile_tables`` on the
   card against the CPU (each plain walk runs once; its lanes are assembled
   at both out_caps), the fixed and emit kernels also on the chunks of
   tests/gdeflate_walk_stress.py (thinned candidates for back extensions,
   the 258 cap, matches ending around mflimit, sizes 0-8, 65535 and 65536,
   a 64 KiB run, a table of 15-bit codes that overflows a lane), then the
   parse and the replay on those tiles,
   truncated, bit-flipped and future-version tiles and the three tiles of
   tests/golden/gdeflate.bin, at a 64 KiB and a too-small out_cap; for ANS,
   both encode walks (words, emits, final states, word counts) and frames on
   the head chunks, the edge rows of tests/test_pallas_ans.py and a batch of
   5, at out_cap = bound and 4096, with ``tables_for`` on the card against
   the CPU, and both decoders on those frames, corrupt frames, rows cut
   below the header, out_cap 1000 and tests/golden/ans.bin; for Cascaded,
   the RLE expansion on whole rows of the fast decoder's ``_stage1`` outputs
   of each configuration's head chunks, hand-made run streams and corrupt
   ones; for row 27, the eleven lowering probes on the reference's inputs
   plus two more scalars each (out of range, negative, overlapping; p7 also
   at s = 1) and a second uint8 block, whole outputs, then ``python -m
   tpucomp_torch.ops.cuda._probe``, which must exit 0); exact equality of
   bytes, sizes, statuses, tokens, table words and values; and the
   Zstandard multi-block encoder (torch ops) on the card against its host
   run, frame for frame, on 4 rows of 128 KiB and each corpus's head
   256 KiB as one row, libzstd reading every frame;
4. full width: two 64 MiB corpora from seed 42 (``mortgage_like``,
   ``mixed_corpus``) cut into 1024 chunks of 64 KiB, one batch each, through
   ``batched.compress`` / ``batched.decompress`` (backend "auto") for LZ4,
   Snappy and Deflate algos 0, 1, 2, and ``batched.decompress("gzip")``,
   ``batched.decompress("zstd")`` on the same chunks staged by libzstd level
   3 (row 18, also on 1 and 8 of them) and on
   each corpus as 4 chunks of 16 MiB (row 19, each pass timed alone), and
   ``batched.compress("zstd")`` (rows 20-21, exact entropy; their ms a
   corpus on lines of their own) with its speed
   rung (``exact_entropy=False``), row 6's ms a corpus on a line of its own,
   ``batched.compress`` /
   ``batched.decompress("gdeflate")`` in algos 0, 1, 2 (rows 13-14, 16-17;
   tests/gdeflate_pyref.py reads three tiles of each; rows 16 and 17's
   hist, fixed and emit ms a corpus on lines of their own, as rows 11 and
   12's for Deflate), ``batched.compress`` /
   ``batched.decompress("ans")`` (rows 25, 23) with rows 24 and 22 through
   their own wrappers on the same chunks, ``batched.compress`` /
   ``batched.decompress("cascaded")`` (row 26) on three configurations of
   1024 x 64 KiB (mortgage as LONGLONG r2 d1, ``low_cardinality_ints`` as
   INT r1 d0, mixed as UINT r2 d1, all bit-packed), with the launch counts of
   that run, the general program's frames (backend "xla") beside the fast
   path's and tests/golden/cascaded.bin through both,
   bit-exact round trips, the decoders reading streams staged by liblz4 /
   libsnappy / zlib level 6 / gzip / libzstd, liblz4, libsnappy, zlib,
   libdeflate and libzstd reading the port's frames, and CUDA-event timings;
   then the variants path, counted on its own: rows 3 and 4 (k 4) on the
   liblz4-staged streams (equal to row 1's output), rows 5 and 8 on both
   corpora (liblz4 and libsnappy, where they load, and rows 1 and 6 read
   every frame; ratios beside the v2 encoders'), row 15 on the port's
   GDeflate tiles of algos 0-2 (equal to rows 13-14's output), with timings;
   the Zstandard settle path, counted on its own: the libzstd-staged 64 KiB
   frames into 64-byte rows through row 19's wrapper, where the frame walk
   gives every frame ``ERROR_OUTPUT_BUFFER_TOO_SMALL``;
   the wide Snappy path, counted on its own: the staged Snappy streams of
   both corpora through ``batched.decompress`` into rows of 64 KiB + 1024
   bytes, a shape the parse does not take, so row 6's walk decodes them;
   the probes path, counted on its own: ``_probe.main()`` and ``main2()``,
   then each probe timed beside the one PyTorch call of the same function,
   and the time of each split into host and device (``torch.profiler``);
   the Zstandard 16 MiB compress path, counted on its own: each corpus as 4
   chunks of 16 MiB through ``batched.compress("zstd")`` (the multi-block
   encoder) and back through ``batched.decompress`` (row 19), libzstd
   reading every frame, with the compress time, the ratio beside libzstd
   level 3's and the match finder, Huffman literals and sequential scans
   each timed alone;
5. manager: each corpus as one 64 MiB buffer through ``Manager(fmt, 65536,
   COMPUTE_AND_VERIFY)`` for LZ4, Snappy, Deflate (algo 1), Zstandard,
   GDeflate (algo 1), ANS and Cascaded (each corpus's configuration),
   ``create_manager`` and
   ``decompress`` (bit-exact, ``SUCCESS``), a flipped payload byte
   (``ERROR_BAD_CHECKSUM``), the frame without its CRC tables through a
   ``NO_COMPUTE_NO_VERIFY`` manager, with its own launch counts and timings;
   then ``Manager("zstd", 16 MiB, COMPUTE_AND_VERIFY)`` over each buffer;
6. the ``kernels`` JSON line, ``nvidia-smi``'s line, and last
   ``{"ok": true, "device": {...}}``.

Exits non-zero without a CUDA device, when the package beside this script is
missing, and when libzstd does not load (it stages the Zstandard input).
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
CHUNK = 1 << 16           # DEFAULT_CHUNK_SIZE: the reference's chunk size
CORPUS_BYTES = 64 << 20   # 1024 chunks per batch
SEED = 42
PHASE3_CHUNKS = 8
BIG_CHUNK = 1 << 24       # the reference's largest zstd chunk (16 MiB)
BIG_ITERS = 3             # timing iterations in the 16 MiB regime
ZSTD_TIGHT = 64           # an out_cap no 64 KiB frame fits: the settle path's walk
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
WARMUP, ITERS = 2, 10
GD_ITERS = 3              # timing iterations of the GDeflate encode stages
PROBE_ITERS = 200         # timing iterations of a probe and its library call
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "lz4_decode": ("lz4_decode.cu", "tpucomp/ops/pallas/lz4_decode2.py:34"),
    "lz4_encode": ("lz4_encode.cu", "tpucomp/ops/pallas/lz4_encode2.py:50"),
    "snappy_decode": ("snappy_decode.cu", "tpucomp/ops/pallas/snappy_decode.py:29"),
    # row 6's walk: the shapes its parse (above) does not take (the wide Snappy path)
    "snappy_decode_walk": ("snappy_decode.cu", "tpucomp/ops/pallas/snappy_decode.py:29"),
    "snappy_encode": ("snappy_encode.cu", "tpucomp/ops/pallas/snappy_encode2.py:33"),
    "deflate_decode": ("deflate_decode.cu", "tpucomp/ops/pallas/deflate_decode.py:65"),
    "deflate_encode_fixed": ("deflate_encode.cu", "tpucomp/ops/pallas/deflate_encode.py:47"),
    "deflate_encode_hist": ("deflate_encode.cu", "tpucomp/ops/pallas/deflate_encode.py:47"),
    "deflate_encode_emit": ("deflate_encode.cu", "tpucomp/ops/pallas/deflate_encode.py:47"),
    # rows 18 and 19: the block-parallel passes as a whole, then each pass,
    # and the frame walk that settles frames too big for their out_cap (the
    # settle path)
    "zstd_decode": ("zstd_passes.cu", "tpucomp/ops/pallas/zstd_decode.py:109"),
    "zstd_decode_big": ("zstd_passes.cu", "tpucomp/ops/pallas/zstd_decode.py:109"),
    **{name: ("zstd_passes.cu", "tpucomp/ops/pallas/zstd_decode.py:109")
       for name in ("zstd_chain", "zstd_entropy", "zstd_scan", "zstd_resolve", "zstd_zero",
                    "zstd_execute")},
    "zstd_walk": ("zstd_decode.cu", "tpucomp/ops/pallas/zstd_decode.py:109"),
    "zstd_encode_hist": ("zstd_encode.cu", "tpucomp/ops/pallas/zstd_encode.py:237"),
    "zstd_encode": ("zstd_encode.cu", "tpucomp/ops/pallas/zstd_encode.py:237"),
    "gdeflate_parse": ("gdeflate_vdecode.cu", "tpucomp/ops/pallas/gdeflate_vdecode.py:67"),
    "gdeflate_exec": ("gdeflate_vdecode.cu", "tpucomp/ops/pallas/gdeflate_vdecode.py:225"),
    "gdeflate_encode_hist": ("gdeflate_encode.cu", "tpucomp/ops/pallas/gdeflate_encode.py:54"),
    "gdeflate_encode": ("gdeflate_encode.cu", "tpucomp/ops/pallas/gdeflate_encode.py:54"),
    "ans_decode": ("ans_decode.cu", "tpucomp/ops/pallas/ans_decode.py:147"),
    "ans_decode_wide": ("ans_decode.cu", "tpucomp/ops/pallas/ans_decode.py:285"),
    "ans_encode": ("ans_encode.cu", "tpucomp/ops/pallas/ans_encode.py:119"),
    "ans_encode_wide": ("ans_encode.cu", "tpucomp/ops/pallas/ans_encode.py:196"),
    "cascaded_expand": ("cascaded_expand.cu", "tpucomp/ops/pallas/cascaded_expand.py:48"),
    # the reference's variants that no dispatch table reaches (the variants path)
    "lz4_decode_single": ("lz4_decode.cu", "tpucomp/ops/pallas/lz4_decode.py:44"),
    "lz4_decode_k": ("lz4_decode.cu", "tpucomp/ops/pallas/lz4_decodek.py:35"),
    "lz4_encode_hash": ("hash_encode.cu", "tpucomp/ops/pallas/lz4_encode.py:43"),
    "snappy_encode_hash": ("hash_encode.cu", "tpucomp/ops/pallas/snappy_encode.py:38"),
    "gdeflate_decode": ("gdeflate_decode.cu", "tpucomp/ops/pallas/gdeflate_decode.py:58"),
    # row 27, the lowering probes (the probes path, behind their own entry point)
    **{f"probe_{p}": ("probe.cu", f"tpucomp/ops/pallas/_probe.py:{line}")
       for p, line in (("p1", 33), ("p2", 47), ("p3", 61), ("p4", 81), ("p5", 96),
                       ("p6", 112), ("p7", 143), ("p8", 163), ("p9", 176), ("p10", 219),
                       ("p11", 239))},
}
ZSTD_PASSES = ("zstd_chain", "zstd_entropy", "zstd_scan", "zstd_resolve", "zstd_zero",
               "zstd_execute")
VARIANTS = ("lz4_decode_single", "lz4_decode_k", "lz4_encode_hash", "snappy_encode_hash",
            "gdeflate_decode")
PROBES = tuple(k for k in KERNELS if k.startswith("probe_"))
OFF_MAIN = VARIANTS + PROBES + ("zstd_walk", "snappy_decode_walk")  # of their own paths
ALGOS = (0, 1, 2)
CAS_ITERS = 3             # timing iterations of the Cascaded stages
# Cascaded configurations: nvCOMP's num_RLEs=2, num_deltas=1, use_bp=1
# (benchmark_cascaded_chunked.cu:35-36) and the reference's per-dataset
# choices (benchmarks/benchmark_all_algorithms.py:46-60): name -> (type, r, d, bp)
CAS_CONFIGS = {"mortgage": ("LONGLONG", 2, 1, True), "lowcard": ("INT", 1, 0, True),
               "mixed": ("UINT", 2, 1, True)}
# the configurations whose fast-path frames must equal the general program's
# on every chunk (the reference's two encoders agree on these columns; on
# mixed's UINT deltas they choose widths on different ladders, W32 and W64)
CAS_SAME_FRAMES = ("mortgage", "lowcard")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters=ITERS, warmup=WARMUP) -> float:
    """Mean milliseconds of ``fn()`` on the card, after warm-up (CUDA events)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_device_ms(torch, fn, n: int = PROBE_ITERS) -> dict:
    """Where a call's time goes: ``host_ms``, the host clock of ``n`` calls
    back to back before the card finishes them, over ``n``; ``device_ms``,
    the card time of the kernels (and copies) ``torch.profiler`` sees in
    ``n`` more calls, over ``n``; ``launches``, those kernels a call."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    host = (time.perf_counter() - t) / n * 1e3
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    dev_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"host_ms": host,
            "device_ms": sum(e.time_range.elapsed_us() for e in dev_events) / n / 1e3,
            "launches": len(dev_events) / n}


def bytes_bound_ms(read: int, written: int) -> float:
    return (read + written) / HBM_BYTES_PER_S * 1e3


def probe_bytes(name: str, x, v) -> tuple[int, int]:
    """(read, written) bytes that probe ``name`` must move on block ``x`` at
    scalar ``v``: each element it reads once, each it writes once, the
    scalar included; never the INT32_MIN fill of the lanes it leaves."""
    row, s = 128 * 4, (0 if v is None else 4)
    if name in ("p1", "p11"):                  # one element
        return s + 4, 4
    if name in ("p3", "p6", "p10"):            # the staged row
        return s + x.numel() * 4, 4
    if name == "p4":                           # two rows, plus one
        return s + 2 * row, 2 * row
    if name == "p5":                           # row 0's lanes from off on
        n = 4 * (128 - min(max(v, 0), 128))
        return s + n, n
    if name == "p9":                           # lanes below n; x unused
        return s, 4 * min(max(v, 0), 128)
    return s + x.numel() * x.element_size(), x.numel() * 4   # p2, p7, p8: the block


def varint(n: int) -> bytes:
    out = b""
    while True:
        b7 = n & 0x7F
        n >>= 7
        out += bytes([b7 | (0x80 if n else 0)])
        if not n:
            return out


def without_crc_tables(frame: np.ndarray, n: int) -> np.ndarray:
    """A Manager frame minus its two CRC tables: checksum_mode 0, the total
    patched, the payload moved up (the frame layout of tpucomp_torch.manager)."""
    head = frame[:56].copy()
    head[28:32] = 0
    head[32:40] = np.frombuffer(np.uint64(len(frame) - 8 * n).tobytes(), np.uint8)
    return np.concatenate([head, frame[56:56 + 4 * n], frame[56 + 12 * n:]])


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    phase_s, clock = {}, [time.perf_counter()]

    def lap(name: str) -> None:
        """Charge the wall time since the last lap to phase ``name``."""
        now = time.perf_counter()
        phase_s[name] = round(now - clock[0], 1)
        clock[0] = now

    import tpucomp_torch
    check(Path(tpucomp_torch.__file__).resolve().parent == HERE / "tpucomp_torch",
          f"tpucomp_torch was imported from {tpucomp_torch.__file__}, not from "
          f"the checkout beside this script")
    from tpucomp_torch import batched
    from tpucomp_torch.chunk import ChunkBatch
    from tpucomp_torch.constants import Status
    from tpucomp_torch.chunk import wrap_i32
    from tpucomp_torch.constants import ElementType
    from tpucomp_torch.formats import ans as fans
    from tpucomp_torch.formats import cascaded as fcas
    from tpucomp_torch.formats import crc32
    from tpucomp_torch.formats import deflate as fdeflate
    from tpucomp_torch.formats import gdeflate as fgdeflate
    from tpucomp_torch.formats import gzip as fgzip
    from tpucomp_torch.formats import lz4 as flz4
    from tpucomp_torch.formats import snappy as fsnappy
    from tpucomp_torch.formats import zstd as fzstd
    from tpucomp_torch.interop import cpu as interop
    from tpucomp_torch.manager import ChecksumPolicy, Manager, create_manager
    from tpucomp_torch.ops import cascaded_fast, match
    from tpucomp_torch.ops.cuda import (_build, _probe, ans_decode, ans_encode, cascaded_expand,
                                        deflate_decode,
                                        deflate_encode, gdeflate_decode, gdeflate_encode,
                                        gdeflate_vdecode, lz4_decode, lz4_decode2, lz4_decodek,
                                        lz4_encode, lz4_encode2, snappy_decode, snappy_encode,
                                        snappy_encode2, zstd_decode, zstd_encode)
    from tpucomp_torch.ops.cuda import zstd_passes as zp
    from tpucomp_torch.utils import synth
    sys.path.insert(0, str(HERE / "tests"))
    import gdeflate_pyref as pyref    # the format's serial Python codec (no JAX)
    import deflate_stress as dstress  # Deflate streams that stress the decoder's window
    import gdeflate_walk_stress as gws  # chunks that stress the GDeflate token parse
    import snappy_stress as ssx         # streams that stress the Snappy element parse
    import zstd_walk_stress as zws      # chunks that stress the Zstandard gated parse

    counters = {"lz4_decode": (lz4_decode2.decompress_batch,),
                "lz4_encode": (lz4_encode2.emit_kernel,),
                "snappy_decode": (snappy_decode.decompress_batch,),
                "snappy_decode_walk": (snappy_decode.decompress_batch_walk,),
                "snappy_encode": (snappy_encode2.emit_kernel,),
                "deflate_decode": (deflate_decode.decompress_batch,),
                "deflate_encode_fixed": (deflate_encode.fixed_kernel,),
                "deflate_encode_hist": (deflate_encode.hist_kernel,),
                "deflate_encode_emit": (deflate_encode.emit_kernel,),
                "zstd_decode": (zstd_decode.decompress_batch,),
                "zstd_decode_big": (zstd_decode.decompress_batch_big,),
                "zstd_chain": (zp.chain_kernel,), "zstd_entropy": (zp.entropy_kernel,),
                "zstd_scan": (zp.scan_kernel,), "zstd_resolve": (zp.resolve_kernel,),
                "zstd_zero": (zp.zero_kernel,), "zstd_execute": (zp.execute_kernel,),
                "zstd_walk": (zp.settle_kernel,),
                "zstd_encode_hist": (zstd_encode.hist_kernel,),
                "zstd_encode": (zstd_encode.full_kernel,),
                "gdeflate_parse": (gdeflate_vdecode.parse_kernel,),
                "gdeflate_exec": (gdeflate_vdecode.exec_kernel,),
                "gdeflate_encode_hist": (gdeflate_encode.hist_kernel,),
                # row 17: one kernel body in the modes fixed (algo 0) and emit
                "gdeflate_encode": (gdeflate_encode.fixed_kernel, gdeflate_encode.emit_kernel),
                "ans_decode": (ans_decode.decompress_batch,),
                "ans_decode_wide": (ans_decode.decompress_batch_wide,),
                "ans_encode": (ans_encode.walk_kernel,),
                "ans_encode_wide": (ans_encode.walk_kernel_wide,),
                "cascaded_expand": (cascaded_expand.expand_batch,),
                "lz4_decode_single": (lz4_decode.decompress_batch,),
                "lz4_decode_k": (lz4_decodek.decompress_batch,),
                "lz4_encode_hash": (lz4_encode.compress_batch,),
                "snappy_encode_hash": (snappy_encode.compress_batch,),
                "gdeflate_decode": (gdeflate_decode.decompress_batch,),
                **{f"probe_{p}": (fn,) for p, fn in _probe.PROBES.items()}}

    def reset_counts() -> None:
        for fns in counters.values():
            for fn in fns:
                fn.launches = 0

    def read_counts() -> dict:
        return {k: sum(fn.launches for fn in fns) for k, fns in counters.items()}

    # ---------------------------------------------------------------- 1 device
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    print(f"[device] {kind}  count={count}  torch={torch.__version__} "
          f"cuda={torch.version.cuda}")
    print(f"[device] nvidia-smi name, power.limit: {smi}")
    dev = torch.device("cuda", 0)

    # ----------------------------------------------------------------- 2 build
    t0 = time.perf_counter()
    secs = _build.build_all()
    print(f"[build] {time.perf_counter() - t0:.1f} s in all, into {_build.build_dir()}")
    for name in _build.KERNELS:
        print(f"[build] {name}: {secs[name]:.1f} s")
        for line in _build.ptxas_report(name):
            print(f"[build]   {line}")
    info = deflate_decode.kernel_info()
    print(f"[build] deflate_decode kernel: {info['registers']} registers, "
          f"{info['shared_bytes']} B static shared memory, {info['local_bytes']} B local "
          f"(spills) a thread, {info['ctas_per_sm']} CTAs an SM")

    lap("1-2 device, imports, build")

    # ------------------------------------------------------------ corpora
    t0 = time.perf_counter()
    corpora = {"mortgage": synth.mortgage_like(CORPUS_BYTES, seed=SEED).tobytes(),
               "mixed": synth.mixed_corpus(CORPUS_BYTES, seed=SEED).tobytes()}
    cas_data = {"mortgage": corpora["mortgage"],
                "lowcard": synth.low_cardinality_ints(CORPUS_BYTES, seed=SEED).tobytes(),
                "mixed": corpora["mixed"]}
    cas_opts = {k: fcas.CascadedOpts(ElementType[t], r, d, bp)
                for k, (t, r, d, bp) in CAS_CONFIGS.items()}
    have = interop.available()
    print(f"[data] two corpora of {CORPUS_BYTES >> 20} MiB, seed {SEED}, "
          f"{time.perf_counter() - t0:.1f} s; liblz4 "
          f"{'loaded' if have['lz4'] else 'did not load: the port encoder stages decode inputs'}"
          f"; libsnappy "
          f"{'loaded' if have['snappy'] else 'did not load: the port encoder stages decode inputs'}"
          f"; libdeflate {'loaded' if have['libdeflate'] else 'did not load'}"
          f"; libzstd {'loaded' if have['zstd'] else 'did not load'}")
    check(have["zstd"], "libzstd did not load: the Zstandard input cannot be staged")
    out_caps = {"lz4": flz4.max_compressed_chunk_size(CHUNK),
                "snappy": fsnappy.max_compressed_chunk_size(CHUNK)}
    oracle = {"lz4": interop.lz4_compress, "snappy": interop.snappy_compress}
    dcap = fdeflate.max_compressed_chunk_size(CHUNK)
    gcap = fgzip.max_compressed_chunk_size(CHUNK)
    zcap = fzstd.max_compressed_chunk_size(CHUNK)
    pool = ThreadPoolExecutor(8)   # zlib releases the GIL: staging and checks in parallel

    def stage(fmt: str, chunks: list[bytes]) -> list[bytes]:
        """Compressed streams for the decoder: the C library's, else the port's."""
        if have[fmt]:
            return [oracle[fmt](c) for c in chunks]
        cb = ChunkBatch.from_chunks(chunks, CHUNK, device=dev)
        comp, st = batched.compress(fmt, cb)
        check(bool((st == Status.SUCCESS).all()), f"staging with the port's {fmt} encoder")
        return comp.chunk_list()

    lap("corpora")

    # ------------------------------------------------------- 3 kernel vs plain
    max_err = {k: 0 for k in KERNELS}
    plain_ms = {k: 0.0 for k in KERNELS}

    def plain_once(names, fn, *args):
        """The plain version once on the host, its time charged to each of ``names``."""
        t = time.perf_counter()
        want = fn(*args)
        ms = (time.perf_counter() - t) * 1e3
        for name in names:
            plain_ms[name] += ms
        return want

    def against(name, got, want, label):
        """Hold a kernel's outputs on the card against its plain version's."""
        torch.cuda.synchronize()
        err = max(int((g.cpu().to(torch.int64) - w.to(torch.int64)).abs().max())
                  if g.numel() else 0 for g, w in zip(got, want))
        max_err[name] = max(max_err[name], err)
        same = all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
        stats = (np.bincount(want[2].numpy(), minlength=16) if len(want) == 3
                 else np.zeros(16, np.int64))
        print(f"[kernel=plain] {name} {label}: B={want[0].shape[0]} "
              f"tolerance=exact equal={same} max_abs_err={err} statuses(ok/cannot/small)="
              f"{stats[0]}/{stats[12]}/{stats[15]}")
        check(same, f"{name} kernel differs from its plain version on {label}")

    def compare(name, kernel_fn, plain_fn, args_cpu, label):
        """Kernel on the card vs plain version on the host; returns the plain result."""
        got = kernel_fn(*[a.to(dev) if torch.is_tensor(a) else a for a in args_cpu])
        torch.cuda.synchronize()
        want = plain_once((name,), plain_fn, *args_cpu)
        against(name, got, want, label)
        return want

    def fuzz(good: bytes) -> list[bytes]:
        """Truncations and bit flips, built as tests/test_pallas_fuzz.py builds them."""
        out = [good[:max(1, c)] for c in (1, 2, len(good) // 4, len(good) // 2,
                                          len(good) - 2, len(good) - 1)]
        frng = np.random.default_rng(len(good))
        for _ in range(6):
            b = bytearray(good)
            b[frng.integers(0, len(good))] ^= 1 << frng.integers(0, 8)
            out.append(bytes(b))
        return out

    head = {k: [v[i * CHUNK:(i + 1) * CHUNK] for i in range(PHASE3_CHUNKS)]
            for k, v in corpora.items()}
    rng = np.random.default_rng(SEED)
    edge_raw = [b"", b"x", b"\x00" * 3000, b"ab" * 1500, b"abcdefg" * 400,
                (b"0123456789abcdef" * 20)[:300] * 12, b"\x00" * CHUNK,
                bytes(rng.integers(0, 256, 5000, dtype=np.uint8))]
    handmade = {
        "lz4": [b"\x04abcd\x00\x00", b"\x04abcd\xff\xff\x04abcd",
                b"\x10a\x02\x00\x10b", b"\x10a\x01\x00\x10b",
                b"\x40abcd\x01\x00", b"\xff" * 64, b"\x10", b"\xf0\xff\xff\xff"],
        "snappy": [  # tests/test_pallas_snappy.py:72-85 and :101-106, then the
                     # preamble in int32 and a preamble beyond out_cap
            varint(20) + b"\x10abcd" + bytes([((16 - 4) << 2) | 1, 4]),
            varint(12) + b"\x0cabcd" + bytes([1 | ((8 - 4) << 2), 4]),
            varint(70) + b"\x00Z" + bytes([(63 << 2) | 3, 1, 0, 0, 0, (4 << 2) | 3, 1, 0, 0, 0]),
            varint(300) + bytes([61 << 2, 299 & 0xFF, 299 >> 8]) + bytes(range(100)) * 3,
            b"\xff\xff\xff\xff\xff\x01", b"\x05\x01\x00\x00", b"\x0a\xfcabc",
            bytes(np.random.default_rng(9).integers(0, 256, 128, dtype=np.uint8)),
            b"\x80\x80\x80\x80\x10", b"\x85\x80\x80\x80\x70\x10abcde",
            b"\x80\x80\x80\x80\x08", varint(CHUNK + 1) + b"\x0cabcd\x05\x00\x00",
            varint(10) + bytes([63 << 2, 0, 0, 0, 0x80]),
            varint(8) + b"\x0cabcd" + bytes([(3 << 2) | 3, 0, 0, 0, 0x80])],
    }
    decoders = {"lz4": (lz4_decode2.decompress_batch, lz4_decode2.decompress_batch_plain),
                "snappy": (snappy_decode.decompress_batch,
                           snappy_decode.decompress_batch_plain)}
    encoders = {"lz4": (lz4_encode2.compress_batch, lz4_encode2.compress_batch_plain,
                        (0, 1, 12, 13, 17), 4096),
                "snappy": (snappy_encode2.compress_batch,
                           snappy_encode2.compress_batch_plain, (0, 1, 3, 4, 5, 17), 2048)}
    enc_rows = head["mortgage"] + head["mixed"]
    for fmt, (kernel_fn, plain_fn) in decoders.items():
        good = stage(fmt, [synth.mixed_corpus(2048, seed=33).tobytes()])[0]
        streams = (stage(fmt, head["mortgage"] + head["mixed"] + edge_raw) + [good]
                   + fuzz(good) + handmade[fmt])
        if fmt == "lz4":    # and, of tests/test_torch_variants.py, an empty row and size -1
            streams += [b"", good]
        dec_in = ChunkBatch.from_chunks(streams, out_caps[fmt], device="cpu")
        if fmt == "lz4":
            dec_in.sizes[-1] = -1
        for cap, label in ((CHUNK, "64 KiB out_cap"), (1000, "out_cap too small")):
            what = f"{len(streams)} streams, {label}"
            if fmt == "snappy":   # row 6: the parse (the wrapper's choice here) and the walk
                want = plain_once(("snappy_decode", "snappy_decode_walk"), plain_fn,
                                  dec_in.data, dec_in.sizes, cap)
                c, n = dec_in.data.to(dev), dec_in.sizes.to(dev)
                check(snappy_decode.parse_fits(c.shape[1], cap), "snappy: the parse's shape")
                against("snappy_decode", kernel_fn(c, n, cap), want, what)
                against("snappy_decode_walk", snappy_decode.decompress_batch_walk(c, n, cap),
                        want, what)
                continue
            # rows 3 and 4 compute row 1's function: one plain run for the three
            want = plain_once(("lz4_decode", "lz4_decode_single", "lz4_decode_k"), plain_fn,
                              dec_in.data, dec_in.sizes, cap)
            c, n = dec_in.data.to(dev), dec_in.sizes.to(dev)
            against("lz4_decode", kernel_fn(c, n, cap), want, what)
            against("lz4_decode_single", lz4_decode.decompress_batch(c, n, cap), want, what)
            for k in (1, 3, 4):
                against("lz4_decode_k", lz4_decodek.decompress_batch(c, n, cap, k=k), want,
                        f"{what}, k {k}")
    # row 6 on tests/snappy_stress.py's streams: the wrapper's choice (the
    # parse up to 64 KiB, the walk past it) and the walk at every out_cap
    ss_in, ss_names = ssx.batch()
    c, n = ss_in.data.to(dev), ss_in.sizes.to(dev)
    for cap in ssx.OUT_CAPS:
        want = plain_once(("snappy_decode", "snappy_decode_walk"),
                          snappy_decode.decompress_batch_plain, ss_in.data, ss_in.sizes, cap)
        what = f"{len(ss_names)} snappy stress streams, out_cap {cap}"
        fits = snappy_decode.parse_fits(c.shape[1], cap)
        check(fits == (cap <= CHUNK), f"snappy: out_cap {cap} takes the wrong kernel")
        against("snappy_decode" if fits else "snappy_decode_walk",
                snappy_decode.decompress_batch(c, n, cap), want, what)
        against("snappy_decode_walk", snappy_decode.decompress_batch_walk(c, n, cap), want, what)
    for fmt, (kernel_fn, plain_fn, short, small_cap) in encoders.items():
        enc_in = ChunkBatch.from_chunks(enc_rows + [head["mixed"][0]] * len(short), CHUNK,
                                        device="cpu")
        enc_in.sizes[len(enc_rows):] = torch.tensor(short, dtype=torch.int32)
        if fmt == "lz4":
            cand_gpu = match.candidates2(enc_in.data.to(dev), enc_in.sizes.to(dev))
            cand_cpu = match.candidates2(enc_in.data, enc_in.sizes)
            check(all(torch.equal(g.cpu(), c) for g, c in zip(cand_gpu, cand_cpu)),
                  "candidates2 on the card differs from the CPU")
            print("[kernel=plain] candidates2 on the card == on the CPU")
        for cap, label in ((out_caps[fmt], "out_cap = bound"),
                           (small_cap, "out_cap too small")):
            compare(f"{fmt}_encode", kernel_fn, plain_fn, (enc_in.data, enc_in.sizes, cap),
                    f"{enc_in.num_chunks} chunks, {label}")
    # rows 5 and 8, the hash-table scans: the head chunks, a zero and a random
    # row, and sizes 0, 1, 13, -3 and cap + 9 (the last two clamped)
    hash_in = ChunkBatch.from_chunks(enc_rows + [bytes(CHUNK), np.random.default_rng(8).bytes(CHUNK)]
                                     + [head["mixed"][0]] * 5, CHUNK, device="cpu")
    hash_in.sizes[-5:] = torch.tensor((0, 1, 13, -3, CHUNK + 9), dtype=torch.int32)
    hash_encoders = {"lz4": (lz4_encode.compress_batch, lz4_encode.compress_batch_plain, 4096),
                     "snappy": (snappy_encode.compress_batch, snappy_encode.compress_batch_plain,
                                2048)}
    for fmt, (kernel_fn, plain_fn, small_cap) in hash_encoders.items():
        for cap, label in ((out_caps[fmt], "out_cap = bound"), (small_cap, "out_cap too small")):
            compare(f"{fmt}_encode_hash", kernel_fn, plain_fn,
                    (hash_in.data, hash_in.sizes, cap), f"{hash_in.num_chunks} chunks, {label}")

    # Deflate decode: zlib levels 6 (every head chunk) and 0/1/9, libdeflate, a
    # multi-block stream, the corrupt streams of tests/test_pallas_deflate.py:101-108,
    # fuzz; then gzip members through the decoder's starts
    dstreams = [interop.deflate_compress(c, 6) for c in head["mortgage"] + head["mixed"]]
    dstreams += [interop.deflate_compress(c, lv) for c in [head["mixed"][0], head["mortgage"][0]]
                 + edge_raw for lv in (0, 1, 9)]
    if have["libdeflate"]:
        dstreams += [interop.libdeflate_compress(c, 9) for c in head["mixed"][:2]]
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    dstreams.append(co.compress(head["mixed"][1][:20000]) + co.flush(zlib.Z_FULL_FLUSH)
                    + co.compress(head["mixed"][1][20000:]) + co.flush())
    dgood = interop.deflate_compress(synth.mixed_corpus(2048, seed=33).tobytes(), 6)
    dstreams += [dgood] + fuzz(dgood) + [
        b"\x07" * 40, b"\x05\x00", b"\x01\x05\x00\x00\x00hi", b"\x01\xff\xff\x00\x00",
        bytes(np.random.default_rng(9).integers(0, 256, 96, dtype=np.uint8)), b""]
    dec_in = ChunkBatch.from_chunks(dstreams, dcap, device="cpu")
    for cap, label in ((CHUNK, "64 KiB out_cap"), (1000, "out_cap too small")):
        compare("deflate_decode", deflate_decode.decompress_batch,
                deflate_decode.decompress_batch_plain, (dec_in.data, dec_in.sizes, cap),
                f"{len(dstreams)} streams, {label}")
    # the window's stress inputs (tests/deflate_stress.py) and their cut and
    # flipped copies, at out_cap one byte short of 64 KiB, 64 KiB, above it
    # (not a multiple of 16) and 1000; then as gzip members at their starts
    wstreams = [s for _, s, _ in dstress.window_streams()]
    win_in = ChunkBatch.from_chunks(wstreams + dstress.corrupt(wstreams), device="cpu")
    for cap in (CHUNK - 1, CHUNK, dstress.OUT_CAP_ABOVE, 1000):
        compare("deflate_decode", deflate_decode.decompress_batch,
                deflate_decode.decompress_batch_plain, (win_in.data, win_in.sizes, cap),
                f"{win_in.num_chunks} window stress streams, out_cap {cap}")
    members = dstress.window_members()
    wgz_in = ChunkBatch.from_chunks(members + dstress.corrupt(members[:3]), device="cpu")
    w_off, w_end, _, _, w_ok = fgzip.parse_member(wgz_in.data, wgz_in.sizes)
    for cap in (CHUNK, 1000):
        compare("deflate_decode",
                lambda c, e, oc, st: deflate_decode.decompress_batch(c, e, oc, starts=st),
                lambda c, e, oc, st: deflate_decode.decompress_batch_plain(c, e, oc, starts=st),
                (wgz_in.data, w_end, cap, torch.where(w_ok, w_off, 0)),
                f"{wgz_in.num_chunks} window stress gzip members at their starts, out_cap {cap}")
    gz = [interop.gzip_compress(c) for c in head["mixed"][:4] + [b"", b"gzip " * 999]]
    gz += [gz[0][:-6] + bytes([gz[0][-6] ^ 0xFF]) + gz[0][-5:], gz[1][:20]]
    gz_in = ChunkBatch.from_chunks(gz, gcap, device="cpu")
    g_off, g_end, _, _, g_ok = fgzip.parse_member(gz_in.data, gz_in.sizes)
    compare("deflate_decode",
            lambda c, e, oc, st: deflate_decode.decompress_batch(c, e, oc, starts=st),
            lambda c, e, oc, st: deflate_decode.decompress_batch_plain(c, e, oc, starts=st),
            (gz_in.data, g_end, CHUNK, torch.where(g_ok, g_off, 0)),
            f"{len(gz)} gzip members at their starts")

    # Zstandard decode, both wrappers: libzstd levels 1/3/19 on every head chunk,
    # edge inputs, many literals (the two lit_caps part at out_cap 1000), the
    # corrupt frames of tests/test_pallas_zstd.py:94-105 and fuzz; then the
    # 16 MiB wrapper at the main path's shape, one 16 MiB chunk per corpus
    zgood = interop.zstd_compress(synth.mixed_corpus(4000, seed=9).tobytes(), 3)
    zstreams = [interop.zstd_compress(c, lv) for c in head["mortgage"] + head["mixed"]
                for lv in (1, 3, 19)]
    zstreams += [interop.zstd_compress(c, 3) for c in edge_raw]
    zstreams += [interop.zstd_compress(bytes(rng.integers(0, 16, n, dtype=np.uint8)), 3)
                 for n in (3000, 20000)]
    zstreams += [zgood] + fuzz(zgood) + [
        b"\x00" + zgood[1:], zgood[:4] + bytes([zgood[4] | 0x08]) + zgood[5:],
        zgood[:4] + bytes([zgood[4] | 0x01, 7]) + zgood[5:],
        bytes(np.random.default_rng(9).integers(0, 256, 96, dtype=np.uint8)), b""]
    z_in = ChunkBatch.from_chunks(zstreams, fzstd.max_compressed_chunk_size(CHUNK), device="cpu")

    def zstd_passes_against_plain(cb, out_cap, label, big=True):
        """Each pass on the card against its plain pass, on the plain
        passes' own inputs (one plain run, every intermediate kept), with
        row 19's lit_cap or with ``big=False`` row 18's; returns the plain
        passes' result."""
        lit_cap = zstd_decode.lit_cap_of(out_cap, big)
        label += "" if big else " (row 18's lit_cap)"
        d, sz = cb.data, cb.sizes
        fcount, bases, totals = plain_once(("zstd_chain",), zp.chain_plain, d, sz, out_cap,
                                           lit_cap)
        fk, bk, tk = zp.chain_kernel(d.to(dev), sz.to(dev), out_cap, lit_cap)
        against("zstd_chain", (fk, torch.cat([bk.reshape(-1).cpu(), torch.tensor(tk)])),
                (fcount, torch.cat([bases.reshape(-1), torch.tensor(totals)])),
                f"counts, bases and totals, {label}")
        nblk, nseq, nlit, nover, most = totals
        blk = plain_once(("zstd_chain",), zp.fill_plain, d, sz, out_cap, lit_cap, fcount, bases,
                         nblk)
        against("zstd_chain", (zp.fill_kernel(d.to(dev), sz.to(dev), out_cap, lit_cap,
                                              fcount.to(dev), bases.to(dev), nblk),),
                (blk,), f"{nblk} block records, {label}")
        ent = plain_once(("zstd_entropy",), zp.entropy_plain, d, blk, nlit, nseq)
        against("zstd_entropy", zp.entropy_kernel(d.to(dev), blk.to(dev), nlit, nseq), ent,
                f"{nlit} literals, {nseq} sequences, {label}")
        lits, seqs, bout, bsym, berr = ent
        scan = plain_once(("zstd_scan",), zp.scan_plain, fcount, bases, bout, bsym, berr, out_cap)
        against("zstd_scan", zp.scan_kernel(*[x.to(dev) for x in (fcount, bases, bout, bsym, berr)],
                                            out_cap), scan, label)
        bstart, bin_, fsize, fstat0 = scan
        res = plain_once(("zstd_resolve",), zp.resolve_plain, blk, seqs, bstart, bin_, fstat0)
        against("zstd_resolve", zp.resolve_kernel(*[x.to(dev) for x in (blk, seqs, bstart, bin_,
                                                                          fstat0)]), res, label)
        offs, fstat = res
        if nover:     # frames whose smallest output passes out_cap: the walk
            want = plain_once(("zstd_walk",), zp.settle_plain, d, sz, out_cap, lit_cap, fstat)
            against("zstd_walk", (zp.settle_kernel(d.to(dev), sz.to(dev), out_cap, lit_cap,
                                                     fstat.to(dev)),), (want,),
                    f"{nover} frames settled by the walk, {label}")
            fstat = want
        zero = plain_once(("zstd_zero",), zp.zero_plain, fstat, fsize, out_cap)
        got = zp.zero_kernel(fstat.to(dev), fsize.to(dev), out_cap)
        col = torch.arange(out_cap, device=dev)[None, :]   # the rows past each size
        against("zstd_zero", (torch.where(col >= got[1][:, None], got[0], 0),) + got[1:], zero,
                label)
        out = plain_once(("zstd_execute",), zp.execute_plain, d, blk, lits, seqs, offs, bstart,
                         bout, fstat, zero[0])
        for multi in sorted({most > 1, True}):   # the narrow shape where it applies, the wide
            against("zstd_execute", (zp.execute_kernel(*[x.to(dev) for x in (
                d, blk, lits, seqs, offs, bstart, bout, fstat, zero[0])], multi),), (out,),
                f"{label}, {'tickets, wide' if multi else 'narrow'} shape")
        return out, zero[1], zero[2]

    # Zstandard decode, both wrappers: libzstd levels 1/3/19 on every head
    # chunk, edge inputs, many literals (the two lit_caps part at out_cap
    # 1000), the corrupt frames of tests/test_pallas_zstd.py:94-105 and fuzz;
    # each pass against its plain pass, the whole (both wrappers) against the walk
    for cap, label in ((CHUNK, "64 KiB out_cap"), (1000, "out_cap too small")):
        for name, kernel_fn, plain_fn, big in (
                ("zstd_decode", zstd_decode.decompress_batch, zstd_decode.decompress_batch_plain,
                 False),
                ("zstd_decode_big", zstd_decode.decompress_batch_big,
                 zstd_decode.decompress_batch_big_plain, True)):
            walk = compare(name, kernel_fn, plain_fn, (z_in.data, z_in.sizes, cap),
                           f"{len(zstreams)} frames, {label}, against the walk")
            check(all(torch.equal(a, b) for a, b in zip(zstd_passes_against_plain(
                z_in, cap, f"{len(zstreams)} frames, {label}", big), walk)),
                  f"the plain passes differ from the walk ({label})")
    # then the 16 MiB wrapper at the main path's shape: each corpus's first
    # 16 MiB at libzstd levels 3 (against the walk), 1 and 19, and the port's
    # own frame (the multi-block encoder on the card)
    big_cap = fzstd.max_compressed_chunk_size(BIG_CHUNK)
    heads16 = [v[:BIG_CHUNK] for v in corpora.values()]
    z_big = ChunkBatch.from_chunks(list(pool.map(interop.zstd_compress, heads16)), big_cap,
                                   device="cpu")
    walk = compare("zstd_decode_big", zstd_decode.decompress_batch_big,
                   zstd_decode.decompress_batch_big_plain, (z_big.data, z_big.sizes, BIG_CHUNK),
                   "the first 16 MiB chunk of each corpus (libzstd level 3), 16 MiB out_cap, "
                   "against the walk")
    check(all(torch.equal(a, b) for a, b in zip(zstd_passes_against_plain(
        z_big, BIG_CHUNK, "each corpus's first 16 MiB, libzstd level 3"), walk)),
          "row 19's plain passes differ from the walk on the 16 MiB chunks")
    own16 = []
    for h in heads16:
        hcb = ChunkBatch.from_bytes(h, BIG_CHUNK, device=dev)
        own16 += fzstd.compress_batch(hcb.data, hcb.sizes)[:2]
    z_more = ChunkBatch.from_chunks(
        list(pool.map(lambda a: interop.zstd_compress(*a),
                      [(h, lv) for h in heads16 for lv in (1, 19)]))
        + [bytes(own16[k][0, :own16[k + 1][0]].cpu().numpy()) for k in (0, 2)], big_cap,
        device="cpu")
    want = zstd_passes_against_plain(z_more, BIG_CHUNK, "each corpus's first 16 MiB, libzstd "
                                     "levels 1 and 19 and the port's own frame")
    against("zstd_decode_big", zstd_decode.decompress_batch_big(
        z_more.data.to(dev), z_more.sizes.to(dev), BIG_CHUNK), want,
        "each corpus's first 16 MiB, libzstd levels 1 and 19 and the port's own frame, "
        "against the plain passes")
    check(bool((want[2] == 0).all()) and all(
        bytes(want[0][i, :want[1][i]].numpy()) == heads16[i // 2 if i < 4 else i - 4]
        for i in range(6)), "row 19 does not read the 16 MiB frames back to the corpora")

    # Deflate encode: the three modes at out_cap = bound and 1024, with and
    # without matches, and dyn_tables on the card against the CPU
    d_in = ChunkBatch.from_chunks(enc_rows + [head["mixed"][0]] * 6, CHUNK, device="cpu")
    d_in.sizes[len(enc_rows):] = torch.tensor((0, 1, 3, 4, 5, 20), dtype=torch.int32)
    dc_cpu = match.candidates2(d_in.data, d_in.sizes, window=deflate_encode.WINDOW)
    dc_gpu = match.candidates2(d_in.data.to(dev), d_in.sizes.to(dev),
                               window=deflate_encode.WINDOW)
    check(all(torch.equal(g.cpu(), c) for g, c in zip(dc_gpu, dc_cpu)),
          "candidates2 (32 KiB window) on the card differs from the CPU")
    dargs = (d_in.data, d_in.sizes, *dc_cpu)
    for cap, label in ((dcap, "out_cap = bound"), (1024, "out_cap too small")):
        compare("deflate_encode_fixed",
                lambda d, s, a, b, n, oc: deflate_encode.fixed_kernel(d, s, (a, b, n), oc),
                lambda d, s, a, b, n, oc: deflate_encode.fixed_plain(d, s, (a, b, n), oc),
                dargs + (cap,), f"{d_in.num_chunks} chunks, algo 0, {label}")
    for eo in (False, True):
        how = "entropy only (algo 2)" if eo else "matches (algo 1)"
        a_cpu = dargs if not eo else (d_in.data, d_in.sizes)

        def cands_of(rest):
            return None if eo else tuple(rest)

        llh, dh = compare("deflate_encode_hist",
                          lambda d, s, *c: deflate_encode.hist_kernel(d, s, cands_of(c)),
                          lambda d, s, *c: deflate_encode.hist_plain(d, s, cands_of(c)),
                          a_cpu, f"{d_in.num_chunks} chunks, {how}")
        tables = deflate_encode.dyn_tables(llh, dh)
        t_gpu = deflate_encode.dyn_tables(llh.to(dev), dh.to(dev))
        check(all(torch.equal(g.cpu(), c) for g, c in zip(t_gpu, tables)),
              f"dyn_tables on the card differs from the CPU ({how})")
        print(f"[kernel=plain] dyn_tables on the card == on the CPU ({how}); dynamic "
              f"headers in {int((tables[2] > 3).sum())} of {d_in.num_chunks} chunks")
        for cap, label in ((dcap, "out_cap = bound"), (1024, "out_cap too small")):
            compare("deflate_encode_emit",
                    lambda d, s, *r: deflate_encode.emit_kernel(d, s, cands_of(r[:-4]), *r[-4:]),
                    lambda d, s, *r: deflate_encode.emit_plain(d, s, cands_of(r[:-4]), *r[-4:]),
                    a_cpu + tables + (cap,), f"{d_in.num_chunks} chunks, {how}, {label}")

    # rows 11 and 12 on tests/gdeflate_walk_stress.py's chunks with
    # Deflate's 32 KiB candidates (back extensions to position 0 and to the
    # anchor, cand8 winning, the 258 cap, ends around mflimit, sizes 0-8,
    # 65535, 65536, a 64 KiB run, a random 64 KiB row) and mixed's chunks 850
    # and 1000 (the literal-heavy fifth), with matches and entropy-only; row
    # 12 at the bound and at an out_cap too small for most
    mixed_tail = [(f"mixed_{k}", corpora["mixed"][k * CHUNK:(k + 1) * CHUNK]) for k in (850, 1000)]
    dws_rows = gws.rows() + mixed_tail
    dws_names = [n for n, _ in dws_rows]
    dws = ChunkBatch.from_chunks([c for _, c in dws_rows], CHUNK, device="cpu")
    dws_c = gws.candidates(dws, dws_names, window=deflate_encode.WINDOW)
    dws_label = f"{dws.num_chunks} walk stress chunks and mixed 850, 1000"
    for eo in (False, True):
        wa = (dws.data, dws.sizes) + (() if eo else tuple(dws_c))
        wt = deflate_encode.dyn_tables(*compare(
            "deflate_encode_hist",
            lambda d, s, *c, eo=eo: deflate_encode.hist_kernel(d, s, None if eo else c),
            lambda d, s, *c, eo=eo: deflate_encode.hist_plain(d, s, None if eo else c),
            wa, f"{dws_label}, {'entropy only' if eo else 'matches'}"))
        for cap in (dcap, 1024):
            compare("deflate_encode_emit",
                    lambda d, s, *r, eo=eo: deflate_encode.emit_kernel(
                        d, s, None if eo else tuple(r[:-4]), *r[-4:]),
                    lambda d, s, *r, eo=eo: deflate_encode.emit_plain(
                        d, s, None if eo else tuple(r[:-4]), *r[-4:]),
                    wa + wt + (cap,), f"{dws_label}, {'entropy only' if eo else 'matches'}, "
                    f"out_cap {cap}")

    # Zstandard encode: the hist and full walks on the head chunks, the edge
    # inputs of tests/test_pallas_zstd.py:25-36,198-226 and its 64 KiB
    # sequence-heavy chunk, in exact entropy at out_cap = bound and 2048 and in
    # the speed rung; candidates2 (64 KiB window) and the tables on the card
    # against the CPU
    zrng = np.random.default_rng(5)
    seq_heavy = b"".join(b"abcd" + zrng.integers(0, 256, 2, dtype=np.uint8).tobytes()
                         for _ in range(12000))[:CHUNK]
    zbase = (np.arange(16, dtype=np.uint8) * 7 + 3).tobytes()
    zedge = [b"", b"x", bytes(zrng.integers(0, 256, 700, dtype=np.uint8)), b"\x00" * 3000,
             b"ab" * 1200, b"".join(zbase + bytes([i & 0xFF]) for i in range(1500)), seq_heavy]
    ze_in = ChunkBatch.from_chunks(enc_rows + zedge, CHUNK, device="cpu")
    zwin = zstd_encode.MAX_CAP
    zc_cpu = match.candidates2(ze_in.data, ze_in.sizes, window=zwin)
    zc_gpu = match.candidates2(ze_in.data.to(dev), ze_in.sizes.to(dev), window=zwin)
    check(all(torch.equal(g.cpu(), c) for g, c in zip(zc_gpu, zc_cpu)),
          "candidates2 (64 KiB window) on the card differs from the CPU")
    zargs = (ze_in.data, ze_in.sizes, *zc_cpu)
    zfreq, zsch = compare("zstd_encode_hist",
                          lambda d, s, a, b, n: zstd_encode.hist_kernel(d, s, (a, b, n)),
                          lambda d, s, a, b, n: zstd_encode.hist_plain(d, s, (a, b, n)),
                          zargs, f"{ze_in.num_chunks} chunks, exact entropy")
    whole = zstd_encode.whole_chunk_hist(ze_in.data, ze_in.sizes)
    seq_tabs = zstd_encode.seq_tables(zsch)
    for what, on_card, on_cpu in (
            ("seq_tables", zstd_encode.seq_tables(zsch.to(dev)), seq_tabs),
            ("huf_meta", zstd_encode.huf_meta(zfreq.to(dev)), zstd_encode.huf_meta(zfreq)),
            ("whole_chunk_hist", (zstd_encode.whole_chunk_hist(ze_in.data.to(dev),
                                                               ze_in.sizes.to(dev)),),
             (whole,))):
        check(all(torch.equal(g.cpu(), c) for g, c in zip(on_card, on_cpu)),
              f"zstd {what} on the card differs from the CPU")
    scm = seq_tabs[0][:, zstd_encode.O2_META + 3]
    print(f"[kernel=plain] zstd seq_tables, huf_meta and whole_chunk_hist on the card == on "
          f"the CPU; custom FSE tables in {int((scm != 0).sum())} of {ze_in.num_chunks} chunks")
    rungs = {"exact entropy": (zfreq, seq_tabs),
             "speed rung": (whole, zstd_encode.speed_tables(ze_in.num_chunks, "cpu"))}
    for rung, (freq, (fse_tab, nc)) in rungs.items():
        meta, tree = zstd_encode.huf_meta(freq)
        caps = (zcap, 2048) if rung == "exact entropy" else (zcap,)
        for cap in caps:
            compare("zstd_encode",
                    lambda d, s, a, b, n, *r: zstd_encode.full_kernel(d, s, (a, b, n), *r),
                    lambda d, s, a, b, n, *r: zstd_encode.full_plain(d, s, (a, b, n), *r),
                    zargs + (meta, tree, fse_tab, nc, cap),
                    f"{ze_in.num_chunks} chunks, {rung}, out_cap {cap}")

    # row 21 on tests/zstd_walk_stress.py's chunks (repeat-only keeps, the
    # initial offset 8, keeps through back extension alone, sequences
    # without literals, a 65,532-byte match, ends around mflimit, sizes 0-8,
    # 65535, 65536, a literal-only row) and mixed's chunks 850 and 1000, in
    # both rungs and at a small out_cap; then the same rows repeated past the
    # card's SM count, so that a CTA takes several chunks through one
    # scratch row (the plain frames repeated alike)
    zws_rows = zws.rows() + mixed_tail
    zs = ChunkBatch.from_chunks([c for _, c in zws_rows], CHUNK, device="cpu")
    zs_c = zws.candidates(zs, [n for n, _ in zws_rows])
    zf, zsc = zstd_encode.hist_plain(zs.data, zs.sizes, zs_c)
    zs_rungs = {"exact entropy": (zf, zstd_encode.seq_tables(zsc)),
                "speed rung": (zstd_encode.whole_chunk_hist(zs.data, zs.sizes),
                               zstd_encode.speed_tables(zs.num_chunks, "cpu"))}
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rep_idx = torch.arange(n_sm + zs.num_chunks + 1) % zs.num_chunks
    # row 20 on the same rows, as they are and repeated past the SM count
    zs_what = f"{zs.num_chunks} zstd walk stress chunks and mixed 850, 1000"
    against("zstd_encode_hist", zstd_encode.hist_kernel(zs.data.to(dev), zs.sizes.to(dev),
                                                        [x.to(dev) for x in zs_c]),
            (zf, zsc), zs_what)
    against("zstd_encode_hist",
            zstd_encode.hist_kernel(zs.data[rep_idx].to(dev), zs.sizes[rep_idx].to(dev),
                                    [x[rep_idx].to(dev) for x in zs_c]),
            (zf[rep_idx], zsc[rep_idx]), f"{zs_what}, repeated to {len(rep_idx)} past {n_sm} SMs")
    for rung, (freq, (fse_tab, nc)) in zs_rungs.items():
        meta, tree = zstd_encode.huf_meta(freq)
        for cap in ((zcap, 2048) if rung == "exact entropy" else (zcap,)):
            zin = (zs.data, zs.sizes, *zs_c, meta, tree, fse_tab, nc)
            want = compare("zstd_encode",
                           lambda d, s, a, b, n, *r: zstd_encode.full_kernel(d, s, (a, b, n), *r),
                           lambda d, s, a, b, n, *r: zstd_encode.full_plain(d, s, (a, b, n), *r),
                           zin + (cap,),
                           f"{zs.num_chunks} zstd walk stress chunks and mixed 850, 1000, {rung}, "
                           f"out_cap {cap}")
            got = zstd_encode.full_kernel(*[x[rep_idx].to(dev) for x in zin[:2]],
                                          [x[rep_idx].to(dev) for x in zin[2:5]],
                                          *[x[rep_idx].to(dev) for x in zin[5:]], cap)
            same = all(torch.equal(g.cpu(), w[rep_idx].cpu()) for g, w in zip(got, want))
            check(same, f"zstd_encode on {len(rep_idx)} repeated stress chunks ({rung}, out_cap "
                        f"{cap}) differs from its plain frames")
            print(f"[kernel=plain] zstd_encode: {len(rep_idx)} stress chunks repeated past "
                  f"{n_sm} SMs, {rung}, out_cap {cap}")

    lap("3 lz4, snappy, deflate, zstd")

    # GDeflate encode: the hist and fixed/emit kernels on the head chunks, the edge
    # rows of tests/test_pallas_gdeflate.py:22-32 and a 64 KiB row with
    # distances above 49152 (:63-72), with and without matches; dyn_tables_gd,
    # schedule_and_assemble and the whole encode of each algo (out_cap = bound
    # and 4096) on the card against the CPU
    def same_on_card(what: str, on_card, on_cpu) -> None:
        check(all(torch.equal(g.cpu(), c.cpu()) for g, c in zip(on_card, on_cpu)),
              f"{what} on the card differs from the CPU")
        print(f"[kernel=plain] {what} on the card == on the CPU")

    gdcap = fgdeflate.max_compressed_chunk_size(CHUNK)
    grng = np.random.default_rng(7)
    gseg = bytes(np.random.default_rng(3).integers(0, 256, 40_000, dtype=np.uint8))
    gedge = [b"hello gdeflate, hello gdeflate, hello gdeflate! " * 30,
             bytes(grng.integers(0, 4, 3000, dtype=np.uint8)),
             bytes(grng.integers(0, 256, 700, dtype=np.uint8)), b"\x00" * 3000, b"ab" * 1200,
             b"x", b""]
    g_in = ChunkBatch.from_chunks(enc_rows + gedge + [gseg + b"\x00" * 12_000 + gseg[:12_000]],
                                  CHUNK, device="cpu")
    gd, gs = g_in.data.to(dev), g_in.sizes.to(dev)
    gc_cpu = match.candidates2(g_in.data, g_in.sizes)
    same_on_card("candidates2 (GDeflate rows)", match.candidates2(gd, gs), gc_cpu)
    gargs = (g_in.data, g_in.sizes, *gc_cpu)
    # algo -> the plain walk's lanes and the tile header fields they are assembled with
    glanes = {0: (compare("gdeflate_encode",
                          lambda d, s, a, b, n: gdeflate_encode.fixed_kernel(d, s, (a, b, n)),
                          lambda d, s, a, b, n: gdeflate_encode.fixed_plain(d, s, (a, b, n)),
                          gargs, f"{g_in.num_chunks} chunks, mode fixed (algo 0)"),
                  gdeflate_encode.fixed_header(g_in.num_chunks, "cpu"))}
    for eo in (False, True):
        how = "entropy only (algo 2)" if eo else "matches (algo 1)"
        a_cpu = gargs if not eo else (g_in.data, g_in.sizes)

        def gcands(rest):
            return None if eo else tuple(rest)

        hist = compare("gdeflate_encode_hist",
                       lambda d, s, *c: gdeflate_encode.hist_kernel(d, s, gcands(c)),
                       lambda d, s, *c: gdeflate_encode.hist_plain(d, s, gcands(c)),
                       a_cpu, f"{g_in.num_chunks} chunks, {how}")
        gtab = gdeflate_encode.dyn_tables_gd(*hist)
        same_on_card(f"dyn_tables_gd ({how})",
                     gdeflate_encode.dyn_tables_gd(*(h.to(dev) for h in hist)), gtab)
        lanes = compare("gdeflate_encode",
                        lambda d, s, *r: gdeflate_encode.emit_kernel(d, s, gcands(r[:-1]), r[-1]),
                        lambda d, s, *r: gdeflate_encode.emit_plain(d, s, gcands(r[:-1]), r[-1]),
                        a_cpu + (gtab[0],), f"{g_in.num_chunks} chunks, mode emit, {how}")
        glanes[2 if eo else 1] = (lanes, (torch.where(gtab[3], 2, 1).to(torch.int32),
                                          gtab[1], gtab[2]))
    # row 16 on the walk stress chunks and mixed's chunks 850 and 1000 with
    # the 64 KiB candidates, with matches and entropy only
    gws_c = gws.candidates(dws, dws_names)
    for eo in (False, True):
        compare("gdeflate_encode_hist",
                lambda d, s, *c, eo=eo: gdeflate_encode.hist_kernel(d, s, None if eo else c),
                lambda d, s, *c, eo=eo: gdeflate_encode.hist_plain(d, s, None if eo else c),
                (dws.data, dws.sizes) + (() if eo else tuple(gws_c)),
                f"{dws_label}, {'entropy only' if eo else 'matches'}")
    # row 17 on tests/gdeflate_walk_stress.py's chunks: back extensions to
    # position 0 and to the anchor (thinned candidates), cand8 winning, the
    # 258 cap with and without back extension, matches ending around
    # mflimit, sizes 0-8, 65535 and 65536, a 64 KiB run, and with a table of
    # 15-bit codes a random 64 KiB row's lanes past 832 words
    ws_cb, ws_names = gws.batch()
    ws_cands = gws.candidates(ws_cb, ws_names)
    ws_args = (ws_cb.data, ws_cb.sizes, *ws_cands)
    ws_label = f"{ws_cb.num_chunks} walk stress chunks"
    compare("gdeflate_encode",
            lambda d, s, a, b, n: gdeflate_encode.fixed_kernel(d, s, (a, b, n)),
            lambda d, s, a, b, n: gdeflate_encode.fixed_plain(d, s, (a, b, n)),
            ws_args, f"{ws_label}, mode fixed")
    for how, wc, wtab in (
            ("matches", ws_cands, None), ("entropy only", None, None),
            ("15-bit codes", ws_cands, gws.long_code_table(ws_cb.num_chunks))):
        if wtab is None:
            wtab = gdeflate_encode.dyn_tables_gd(
                *gdeflate_encode.hist_plain(ws_cb.data, ws_cb.sizes, wc))[0]
        wa = (ws_cb.data, ws_cb.sizes) + (tuple(wc) if wc is not None else ()) + (wtab,)
        want = compare("gdeflate_encode",
                       lambda d, s, *r, wc=wc: gdeflate_encode.emit_kernel(
                           d, s, None if wc is None else tuple(r[:-1]), r[-1]),
                       lambda d, s, *r, wc=wc: gdeflate_encode.emit_plain(
                           d, s, None if wc is None else tuple(r[:-1]), r[-1]),
                       wa, f"{ws_label}, mode emit, {how}")
        if how == "15-bit codes":
            check(int(want[3][ws_names.index("random_64k"), 1]) == 1,
                  "the walk stress row past 832 words a lane did not overflow")
    # each plain walk ran once above: the plain encode of an algo is its
    # lanes through schedule_and_assemble, here at both out_caps
    g_tiles = []
    for algo in ALGOS:
        gopts = fgdeflate.GdeflateOpts(algo)
        lanes, ghead = glanes[algo]
        for cap in (gdcap, 4096):
            sched = (*lanes, g_in.data, g_in.sizes, cap, *ghead)
            want = gdeflate_encode.schedule_and_assemble(*sched)
            same_on_card(f"schedule_and_assemble (algo {algo}, out_cap {cap})",
                         gdeflate_encode.schedule_and_assemble(
                             *[x.to(dev) if torch.is_tensor(x) else x for x in sched]), want)
            same_on_card(f"GDeflate compress algo {algo}, out_cap {cap} "
                         f"({int((want[2] == 0).sum())} of {g_in.num_chunks} fit)",
                         gdeflate_encode.compress_algo(gd, gs, gopts, cap), want)
            if cap == gdcap:
                g_tiles += [want[0][i, :want[1][i]].numpy().tobytes()
                            for i in range(g_in.num_chunks)]

    lap("3 gdeflate encode")

    # GDeflate decode: the parse and the replay on those tiles, pyref tiles of
    # btype 0/1/2, truncated, bit-flipped, future-version and btype-3 tiles and
    # tests/golden/gdeflate.bin, at a 64 KiB and a too-small out_cap; then the
    # whole decode and tile_tables on the card against the CPU
    gblob = (HERE / "tests" / "golden" / "gdeflate.bin").read_bytes()
    ngold = int(np.frombuffer(gblob[:4], np.int32)[0])
    gold_sz = np.frombuffer(gblob[4:4 + 4 * ngold], np.int32)
    gold_off = 4 + 4 * ngold + np.concatenate([[0], np.cumsum(gold_sz)])
    gold = [gblob[gold_off[i]:gold_off[i + 1]] for i in range(ngold)]
    graw = (HERE / "tests" / "golden" / "input.bin").read_bytes()
    gk = len(graw) // 3
    gtile = g_tiles[g_in.num_chunks + PHASE3_CHUNKS]     # algo 1, the first mixed chunk
    g_dec = (g_tiles + [pyref.compress(r, btype=b) for r in gedge for b in (0, 1, 2)]
             + fuzz(gtile) + [gtile[:1] + b"\x02" + gtile[2:], b"\x03" + bytes(16)] + gold)
    gd_in = ChunkBatch.from_chunks(g_dec, gdcap, device="cpu")
    def fields(tables) -> list:
        return [x for t in tables for x in (t if isinstance(t, tuple) else (t,))]

    same_on_card("tile_tables", fields(fgdeflate.tile_tables(gd_in.data.to(dev))),
                 fields(fgdeflate.tile_tables(gd_in.data)))
    for cap, label in ((CHUNK, "64 KiB out_cap"), (1000, "out_cap too small")):
        what = f"{len(g_dec)} tiles, {label}"
        parse = compare("gdeflate_parse", gdeflate_vdecode.parse_kernel,
                        gdeflate_vdecode.parse_plain, (gd_in.data, gd_in.sizes, cap), what)
        n_eff = torch.minimum(parse[0][:, 1], torch.tensor(parse[1].shape[1],
                                                           dtype=torch.int32))
        replay = compare("gdeflate_exec", gdeflate_vdecode.exec_kernel,
                         gdeflate_vdecode.exec_plain, (parse[1], n_eff, cap), what)
        want = gdeflate_vdecode._compose(gd_in.data, gd_in.sizes, cap, parse[0], parse[2],
                                         parse[3], *replay)
        got = gdeflate_vdecode.decompress_batch(gd_in.data.to(dev), gd_in.sizes.to(dev), cap)
        st = np.bincount(want[2].numpy(), minlength=16)
        same_on_card(f"GDeflate decompress, {what} (ok/cannot/small {st[0]}/{st[12]}/{st[15]})",
                     got, want)
        if cap == CHUNK:
            g_ok = [want[0][i, :want[1][i]].numpy().tobytes() for i in range(len(g_dec))]
            check(g_ok[-ngold:] == [graw[:gk], graw[gk:2 * gk], graw[2 * gk:]]
                  and g_ok[:len(g_tiles)] == g_in.chunk_list() * len(ALGOS),
                  "GDeflate: the golden tiles or the port's tiles do not decode")
    # row 15, the serial decoder: the same tiles, and of tests/test_torch_variants.py
    # a tile whose row is whole but its size 3 short, and one of more tokens than bytes
    ntok = bytearray(gtile)
    ntok[2:6] = (1 << 24).to_bytes(4, "little")
    g15_in = ChunkBatch.from_chunks(g_dec + [gtile, bytes(ntok)], gdcap, device="cpu")
    g15_in.sizes[-2] -= 3
    for cap, label in ((CHUNK, "64 KiB out_cap"), (256, "out_cap 256")):
        want = compare("gdeflate_decode", gdeflate_decode.decompress_batch,
                       gdeflate_decode.decompress_batch_plain, (g15_in.data, g15_in.sizes, cap),
                       f"{g15_in.num_chunks} tiles, {label}")
        if cap == CHUNK:
            g_ok = [want[0][i, :want[1][i]].numpy().tobytes() for i in range(len(g_tiles))]
            check(g_ok == g_in.chunk_list() * len(ALGOS),
                  "GDeflate row 15: the port's tiles do not decode")

    lap("3 gdeflate decode")

    # ANS: the encode walk of rows 24-25 on the head chunks, the edge rows of
    # tests/test_pallas_ans.py, all 256 symbols with most rare and a cut size
    # (23 rows: a ragged wide block), and on 5 of them, at out_cap = bound
    # and 4096; then the decoders of rows 22-23 on those frames, corrupt
    # frames, rows cut below the header, out_cap 1000 and
    # tests/golden/ans.bin.  Each plain version runs once per input and is
    # held against both kernels.
    acap = fans.max_compressed_chunk_size(CHUNK)
    arng = np.random.default_rng(31)
    aedge = [b"", b"x", b"\x00" * 3000, bytes(arng.integers(0, 4, 5000, dtype=np.uint8)),
             bytes(arng.integers(0, 256, 3000, dtype=np.uint8)),
             bytes(range(256)) + b"a" * 20000, head["mixed"][0]]
    a_in = ChunkBatch.from_chunks(enc_rows + aedge, CHUNK, device="cpu")
    a_in.sizes[-1] = 1000
    a_five = ChunkBatch(a_in.data[-5:].clone(), a_in.sizes[-5:].clone())

    enc_names = ("ans_encode", "ans_encode_wide")
    walks = {"ans_encode": ans_encode.walk_kernel, "ans_encode_wide": ans_encode.walk_kernel_wide}
    comps = {"ans_encode": ans_encode.compress_batch,
             "ans_encode_wide": ans_encode.compress_batch_wide}
    a_frames = []
    for cb, label in ((a_in, f"{a_in.num_chunks} rows"), (a_five, "5 edge rows")):
        freq, cum = fans.tables_for(cb.data, cb.sizes)
        same_on_card(f"ANS tables_for ({label})",
                     fans.tables_for(cb.data.to(dev), cb.sizes.to(dev)), (freq, cum))
        walk = plain_once(enc_names, ans_encode.walk_plain, cb.data, cb.sizes, freq, cum)
        for name in enc_names:
            against(name, walks[name](cb.data.to(dev), cb.sizes.to(dev), freq.to(dev),
                                      cum.to(dev)),
                    walk, f"walk (words, emits, x_fin, wcount), {label}")
        for cap in (acap, 4096):
            want = fans.serialize_scan(cb.sizes, freq, walk[2], walk[3], walk[0], walk[1], cap)
            for name in enc_names:
                against(name, comps[name](cb.data.to(dev), cb.sizes.to(dev), cap), want,
                        f"frames, {label}, out_cap {cap} ({int((want[2] == 0).sum())} fit)")
            if cap == acap and cb is a_in:
                a_frames = [want[0][i, :want[1][i]].numpy().tobytes()
                            for i in range(cb.num_chunks)]
    agood = a_frames[PHASE3_CHUNKS]             # the first mixed chunk
    u32 = lambda v: int(v).to_bytes(4, "little")   # noqa: E731

    def patched(at: int, value: bytes, frame: bytes = agood) -> bytes:
        return frame[:at] + value + frame[at + len(value):]

    ablob = (HERE / "tests" / "golden" / "ans.bin").read_bytes()
    na = int(np.frombuffer(ablob[:4], np.int32)[0])
    aoff = 4 + 4 * na + np.concatenate([[0], np.cumsum(np.frombuffer(ablob[4:4 + 4 * na],
                                                                     np.int32))])
    agold = [ablob[aoff[i]:aoff[i + 1]] for i in range(na)]
    a_dec = (a_frames + fuzz(agood)
             + [patched(0, b"\x5a"), patched(1, b"\x03"), patched(12, bytes([agood[12] ^ 0x55])),
                patched(4, u32(CHUNK + 1)), patched(4, u32(0x80000010)),
                patched(8, u32(5), patched(4, u32(0)))[:fans.HEADER_BYTES + 10], agood]
             + agold)
    ad_in = ChunkBatch.from_chunks(a_dec, acap, device="cpu")
    ad_in.sizes[len(a_dec) - na - 1] -= 40      # a truncated size
    dec_names = ("ans_decode", "ans_decode_wide")
    decs = {"ans_decode": ans_decode.decompress_batch,
            "ans_decode_wide": ans_decode.decompress_batch_wide}
    for data, cap, label in ((ad_in.data, CHUNK, "64 KiB out_cap"),
                             (ad_in.data, 1000, "out_cap 1000"),
                             (ad_in.data[:, :1200].contiguous(), 1000,
                              "rows cut to 1200 bytes, out_cap 1000")):
        want = plain_once(dec_names, ans_decode.decompress_batch_plain, data, ad_in.sizes, cap)
        for name in dec_names:
            against(name, decs[name](data.to(dev), ad_in.sizes.to(dev), cap), want,
                    f"{len(a_dec)} frames, {label}")
        if cap == CHUNK:
            a_ok = [want[0][i, :want[1][i]].numpy().tobytes() for i in range(len(a_dec))]
            check(a_ok[:len(a_frames)] == a_in.chunk_list()
                  and a_ok[-na:] == [graw[:gk], graw[gk:2 * gk], graw[2 * gk:]],
                  "ANS: the port's frames or tests/golden/ans.bin do not decode")

    lap("3 ans")

    # Cascaded: row 26 on whole rows of the fast decoder's _stage1 outputs of
    # each configuration's head chunks, hand-made run streams at the main
    # path's cap_el = 65536 (nr 0/1/2, no runs, runs of 1, 127, 128, 129 and
    # cap_el) and corrupt ones (zero-length, negative and over-long runs,
    # counts outside the row, nr above 2, int32 run starts that wrap)
    def to_i32(x):
        return wrap_i32(x).to(torch.int32)

    def stage1_args(comp, comp_sizes):
        """The expansion's inputs for the fast decoder's rows, on the card."""
        s1 = cascaded_fast._stage1(comp, cascaded_fast.comp_words(comp, CHUNK), comp_sizes,
                                   CHUNK)
        return (to_i32(s1[0]), to_i32(s1[1]), s1[2], s1[3], s1[4]), s1

    for name, raw in cas_data.items():
        cb = ChunkBatch.from_bytes(raw[:PHASE3_CHUNKS * CHUNK], CHUNK, device=dev)
        opts = cas_opts[name]
        comp, csz, cst = cascaded_fast.compress_batch(
            cb.data, cb.sizes, opts, fcas.max_compressed_chunk_size(CHUNK, opts))
        check(bool((cst == Status.SUCCESS).all()), f"cascaded {name}: head chunks' statuses")
        args, _ = stage1_args(comp, csz)
        compare("cascaded_expand", cascaded_expand.expand_batch,
                cascaded_expand.expand_batch_plain, tuple(a.cpu() for a in args) + (CHUNK,),
                f"_stage1 of {PHASE3_CHUNKS} {name} chunks ({opts.type.name} "
                f"r{opts.num_rles} d{opts.num_deltas})")
    ce = CHUNK
    cas_hand = [((ce, 0, 0, 0), [], []), ((0, 0, 0, 1), [], []), ((ce, ce, 0, 1), [1] * ce, []),
                ((ce, 4, 0, 1), [127, 128, 129, ce - 384], []), ((ce, 1, 0, 1), [ce], []),
                ((ce, 4, 3, 2), [1000, 24, 1024, ce - 2048], [1, 2, 1]),
                ((ce, 8192, 3, 2), [8] * 8192, [4000, 4000, 192])]
    cas_corrupt = [((ce, 6, 0, 1), [0, 5, 0, 90000, 3, -4], []), ((0, -3, 0, 1), [4, 4], []),
                   ((ce, ce + 50, 7, 2), [2] * 50, [10, 0, 200000, 1, 1, -1, 3]),
                   ((ce, 2, 2, 7), [ce // 2] * 2, [1, 1]), ((ce, ce, 0, 1), [ce] * ce, [])]
    crng = np.random.default_rng(SEED)
    for rows, label in ((cas_hand, "hand-made run streams"), (cas_corrupt, "corrupt run streams")):
        B = len(rows)
        vals = [torch.from_numpy(crng.integers(-2**31, 2**31, (B, ce)).astype(np.int32))
                for _ in range(2)]
        runs = [torch.zeros((B, ce), dtype=torch.int32) for _ in range(2)]
        for b, (_, r1, r2) in enumerate(rows):
            runs[0][b, :len(r1)] = torch.tensor(r1, dtype=torch.int32)
            runs[1][b, :len(r2)] = torch.tensor(r2, dtype=torch.int32)
        sc = torch.tensor([r[0] for r in rows], dtype=torch.int32)
        compare("cascaded_expand", cascaded_expand.expand_batch,
                cascaded_expand.expand_batch_plain, (*vals, *runs, sc, ce), f"{B} {label}")

    lap("3 cascaded")

    # row 27, the lowering probes: each kernel on _probe.CHECK_CASES (the
    # reference's inputs, two more scalars each, out of range, negative or
    # overlapping, p7 also at s = 1, a second uint8 block for p8) against its
    # plain version on the host, whole outputs with their INT32_MIN fill; then
    # the entry point, python -m tpucomp_torch.ops.cuda._probe, which must exit 0
    pblocks = _probe.check_blocks()
    for pname, xk, v in _probe.check_calls():
        args = _probe.check_args(xk, v, pblocks)
        compare(f"probe_{pname}", lambda *a, f=_probe.PROBES[pname]: (f(*a),),
                lambda *a, f=_probe.PLAIN[pname]: (f(*a),), args,
                f"{xk}, scalar {v}")
    cli = subprocess.run([sys.executable, "-m", "tpucomp_torch.ops.cuda._probe"], cwd=HERE,
                         capture_output=True, text=True, timeout=300)
    for line in cli.stdout.splitlines():
        print(f"[probe] {line}")
    check(cli.returncode == 0, f"python -m tpucomp_torch.ops.cuda._probe exited "
                               f"{cli.returncode}: {cli.stderr[-2000:]}")
    lap("3 probes")

    # the multi-block encoder (torch ops, behind batched.compress("zstd") above
    # 64 KiB chunks) on the card against its run on the host, frame for frame:
    # 4 rows at 128 KiB (the single-block branch at its widest; one cut short,
    # one of 30 bytes) and each corpus's head 256 KiB as one row (two blocks)
    zx_in = {"4 x 128 KiB": ChunkBatch.from_chunks(
                 [corpora["mixed"][:1 << 17], corpora["mortgage"][:1 << 17],
                  corpora["mixed"][1 << 20:(1 << 20) + 100_000], b"abc" * 10],
                 1 << 17, device="cpu"),
             "256 KiB heads": ChunkBatch.from_chunks(
                 [raw[:1 << 18] for raw in corpora.values()], 1 << 18, device="cpu")}
    for label, cb in zx_in.items():
        got = fzstd.compress_batch(cb.data.to(dev), cb.sizes.to(dev))
        torch.cuda.synchronize()
        t = time.perf_counter()
        want = fzstd.compress_batch(cb.data, cb.sizes)
        host_s = time.perf_counter() - t
        same = all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
        print(f"[encoder] zstd multi-block encoder {label}: card == host {same}, "
              f"sizes {want[1].tolist()}, statuses {want[2].tolist()}, host run {host_s:.1f} s")
        check(same, f"the zstd multi-block encoder on the card differs from the host ({label})")
        check(bool((want[2] == Status.SUCCESS).all()) and all(
            interop.zstd_decompress(f, len(r)) == r
            for f, r in zip(ChunkBatch(*got[:2]).chunk_list(), cb.chunk_list())),
            f"zstd multi-block encoder ({label}): libzstd does not read every frame back")
    lap("3 zstd multi-block encoder")

    # ------------------------------------------------------------ 4 full width
    batches, staged = {}, {}
    for name, raw in corpora.items():
        batches[name] = ChunkBatch.from_bytes(raw, CHUNK, device=dev)
        chunks = [raw[i:i + CHUNK] for i in range(0, len(raw), CHUNK)]
        for fmt in out_caps:
            staged[name, fmt] = ChunkBatch.from_chunks(stage(fmt, chunks), out_caps[fmt],
                                                       device=dev)
        # zlib level 6, as bench.py:157-158 stages Deflate input
        staged[name, "deflate"] = ChunkBatch.from_chunks(
            list(pool.map(interop.deflate_compress, chunks)), dcap, device=dev)
        staged[name, "gzip"] = ChunkBatch.from_chunks(
            list(pool.map(interop.gzip_compress, chunks)), gcap, device=dev)
        # libzstd level 3 (its default), per 64 KiB chunk and per 16 MiB chunk
        staged[name, "zstd"] = ChunkBatch.from_chunks(
            list(pool.map(interop.zstd_compress, chunks)), zcap, device=dev)
        big_chunks = [raw[i:i + BIG_CHUNK] for i in range(0, len(raw), BIG_CHUNK)]
        staged[name, "zstd_big"] = ChunkBatch.from_chunks(
            list(pool.map(interop.zstd_compress, big_chunks)),
            fzstd.max_compressed_chunk_size(BIG_CHUNK), device=dev)
    cas_batches = {k: batches[k] if k in batches else ChunkBatch.from_bytes(v, CHUNK, device=dev)
                   for k, v in cas_data.items()}
    torch.cuda.synchronize()
    lap("4 staging")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    results, dresults, dstaged, zresults, zenc, gresults, aresults = {}, {}, {}, {}, {}, {}, {}
    for name, cb in batches.items():          # the main path, once
        for fmt in out_caps:
            comp, cst = batched.compress(fmt, cb)
            dec, dst = batched.decompress(fmt, comp, CHUNK)
            sdec, sdst = batched.decompress(fmt, staged[name, fmt], CHUNK)
            results[name, fmt] = (comp, cst, dec, dst, sdec, sdst)
        for algo in ALGOS:
            comp, cst = batched.compress("deflate", cb, fdeflate.DeflateOpts(algo))
            dec, dst = batched.decompress("deflate", comp, CHUNK)
            dresults[name, algo] = (comp, cst, dec, dst)
        dstaged[name] = (batched.decompress("deflate", staged[name, "deflate"], CHUNK)
                         + batched.decompress("gzip", staged[name, "gzip"], CHUNK))
        zresults[name] = (batched.decompress("zstd", staged[name, "zstd"], CHUNK)
                          + batched.decompress("zstd", staged[name, "zstd_big"], BIG_CHUNK))
        zcomp, zcst = batched.compress("zstd", cb)
        sout, ssz, sst = zstd_encode.compress_batch(cb.data, cb.sizes, zcap,
                                                    exact_entropy=False)
        zspeed = ChunkBatch(data=sout, sizes=ssz)
        zenc[name] = {"exact entropy": (zcomp, zcst) + batched.decompress("zstd", zcomp, CHUNK),
                      "speed rung": (zspeed, sst) + batched.decompress("zstd", zspeed, CHUNK)}
        for algo in ALGOS:
            gcomp, gcst = batched.compress("gdeflate", cb, fgdeflate.GdeflateOpts(algo))
            gresults[name, algo] = (gcomp, gcst) + batched.decompress("gdeflate", gcomp, CHUNK)
        # ANS through batched (rows 25 and 23), and the single-chunk wrappers
        # (rows 24 and 22, the device-side API blocks) on the same chunks
        acomp, acst = batched.compress("ans", cb)
        aresults[name] = ((acomp, acst) + batched.decompress("ans", acomp, CHUNK)
                          + ans_encode.compress_batch(cb.data, cb.sizes, acap)
                          + ans_decode.decompress_batch(acomp.data, acomp.sizes, CHUNK))
    torch.cuda.synchronize()
    lap("4 main path")
    cresults = {}
    for name, cb in cas_batches.items():      # Cascaded, three configurations (row 26)
        ccomp, ccst = batched.compress("cascaded", cb, cas_opts[name])
        cresults[name] = (ccomp, ccst) + batched.decompress("cascaded", ccomp, CHUNK)
    torch.cuda.synchronize()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"[full] launches in the main-path run: {launches}; peak device memory "
          f"{peak / 2**30:.2f} GiB")
    check(all(v > 0 for k, v in launches.items() if k not in OFF_MAIN),
          f"a kernel was not launched: {launches}")
    check(gdeflate_encode.fixed_kernel.launches > 0 and gdeflate_encode.emit_kernel.launches > 0,
          "the GDeflate walk was not launched in both of its emitting modes")
    lap("4 main path, cascaded")

    kernel_ms = {k: 0.0 for k in KERNELS}
    bound = {k: 0.0 for k in KERNELS}

    # the variants path: rows 3-5, 8 and 15, which no dispatch table reaches,
    # through their own entry points at the main path's width and counted on
    # their own: rows 3 and 4 (k 4) on the staged LZ4 streams, rows 5 and 8 on
    # each corpus, row 15 on the port's GDeflate tiles of algos 0-2
    reset_counts()
    vresults = {}
    for name, cb in batches.items():
        sl = staged[name, "lz4"]
        vresults[name] = {
            "single": lz4_decode.decompress_batch(sl.data, sl.sizes, CHUNK),
            "k": lz4_decodek.decompress_batch(sl.data, sl.sizes, CHUNK, k=4),
            "lz4": lz4_encode.compress_batch(cb.data, cb.sizes, out_caps["lz4"]),
            "snappy": snappy_encode.compress_batch(cb.data, cb.sizes, out_caps["snappy"]),
            **{algo: gdeflate_decode.decompress_batch(gresults[name, algo][0].data,
                                                      gresults[name, algo][0].sizes, CHUNK)
               for algo in ALGOS}}
    torch.cuda.synchronize()
    vlaunches = read_counts()
    print(f"[variants] launches in the variants-path run: {vlaunches}")
    check(all(vlaunches[k] > 0 for k in VARIANTS),
          f"a kernel of the variants path was not launched: {vlaunches}")
    launches.update({k: vlaunches[k] for k in VARIANTS})
    lap("4 variants path")

    # the settle path, counted on its own: a caller whose rows are too small
    # for every frame, through row 19's wrapper (whose lit_cap passes every
    # block), so the chain marks every frame and the walk settles it
    reset_counts()
    ztight = {name: zstd_decode.decompress_batch_big(staged[name, "zstd"].data,
                                                     staged[name, "zstd"].sizes, ZSTD_TIGHT)
              for name in batches}
    torch.cuda.synchronize()
    slaunches = read_counts()
    print(f"[settle] launches in the settle-path run: {slaunches}")
    check(slaunches["zstd_walk"] > 0 and slaunches["zstd_execute"] == 0,
          f"the settle path did not go through the walk alone: {slaunches}")
    launches["zstd_walk"] = slaunches["zstd_walk"]
    lc_tight = zstd_decode.lit_cap_of(ZSTD_TIGHT, big=True)
    for name, (tout, tsz, tst) in ztight.items():
        zs = staged[name, "zstd"]
        check(bool((tst == Status.ERROR_OUTPUT_BUFFER_TOO_SMALL).all()) and not tsz.any()
              and not tout.any(),
              f"{name} zstd into {ZSTD_TIGHT}-byte rows: not every frame too big, size 0")
        marks = zp.chain_kernel(zs.data, zs.sizes, ZSTD_TIGHT, lc_tight)[0][:, 3].to(torch.int32)
        check(bool((marks == zp.OVERFLOW).all()), f"{name}: the chain did not mark every frame")
        kernel_ms["zstd_walk"] += time_ms(torch, lambda: zp.settle_kernel(
            zs.data, zs.sizes, ZSTD_TIGHT, lc_tight, marks))
        bound["zstd_walk"] += bytes_bound_ms(int(zs.total_bytes) + 8 * zs.num_chunks,
                                             4 * zs.num_chunks)
    lap("4 settle path")

    # the wide Snappy path, counted on its own: the staged Snappy streams into
    # rows of 64 KiB + 1024 bytes, a shape row 6's parse does not take, so
    # its walk decodes them
    reset_counts()
    wide = {name: batched.decompress("snappy", staged[name, "snappy"], CHUNK + 1024)
            for name in batches}
    torch.cuda.synchronize()
    wlaunches = read_counts()
    print(f"[wide] launches in the wide-Snappy-path run: {wlaunches}")
    check(wlaunches["snappy_decode_walk"] > 0 and wlaunches["snappy_decode"] == 0,
          f"the wide Snappy path did not go through the walk alone: {wlaunches}")
    launches["snappy_decode_walk"] = wlaunches["snappy_decode_walk"]
    for name, (wdec, wst) in wide.items():
        cb = batches[name]
        check(bool((wst == Status.SUCCESS).all()) and torch.equal(wdec.sizes, cb.sizes)
              and torch.equal(wdec.data[:, :CHUNK], cb.data) and not wdec.data[:, CHUNK:].any(),
              f"{name} snappy into {CHUNK + 1024}-byte rows: not bit-exact")
    lap("4 wide snappy path")

    # rows 3 and 4 give row 1's bytes, sizes and statuses; the C libraries
    # (where they load) and rows 1 and 6 read every frame of rows 5 and 8;
    # row 15 gives rows 13-14's output on the port's tiles
    hash_readers = {"lz4": lambda f_r: interop.lz4_decompress(f_r[0], len(f_r[1])) == f_r[1],
                    "snappy": lambda f_r: interop.snappy_decompress(f_r[0]) == f_r[1]}
    for name, v in vresults.items():
        cb, sl = batches[name], staged[name, "lz4"]
        B, sizes, raw_bytes = cb.num_chunks, cb.sizes, int(cb.total_bytes)
        row1 = lz4_decode2.decompress_batch(sl.data, sl.sizes, CHUNK)
        check(bool((row1[2] == Status.SUCCESS).all()), f"{name}: row 1 on the staged streams")
        for key, label in (("single", "row 3"), ("k", "row 4 (k 4)")):
            check(all(torch.equal(a, b) for a, b in zip(v[key], row1)),
                  f"{name}: {label} differs from row 1 on the staged LZ4 streams")
        row = {"corpus": name, "format": "variants", "chunks": B, "raw_bytes": raw_bytes,
               "lz4_staged_by": "liblz4" if have["lz4"] else "port"}
        for fmt in ("lz4", "snappy"):
            out, osz, st = v[fmt]
            check(bool((st == Status.SUCCESS).all()), f"{name}: {fmt} hash encode statuses")
            frames = ChunkBatch(out, osz)
            dec, dst = batched.decompress(fmt, frames, CHUNK)
            check(bool((dst == Status.SUCCESS).all()) and torch.equal(dec.sizes, cb.sizes)
                  and torch.equal(dec.data, cb.data),
                  f"{name}: the dispatched {fmt} decoder does not read the hash encoder's "
                  f"frames bit-exactly")
            if have[fmt]:
                check(all(pool.map(hash_readers[fmt], zip(frames.chunk_list(),
                                                          cb.chunk_list()))),
                      f"{name}: lib{fmt} does not read the hash encoder's frames")
            row[f"{fmt}_read_by_lib{fmt}"] = have[fmt]
            row[f"{fmt}_hash_ratio"] = raw_bytes / int(osz.sum())
            row[f"{fmt}_v2_ratio"] = raw_bytes / int(results[name, fmt][0].total_bytes)
        for algo in ALGOS:
            _, _, gdec, gdst = gresults[name, algo]
            check(all(torch.equal(a, b) for a, b in zip(v[algo], (gdec.data, gdec.sizes, gdst))),
                  f"{name}: row 15 differs from rows 13-14 on the port's algo-{algo} tiles")
        gc1 = gresults[name, 1][0]
        t = {k: time_ms(torch, fn) for k, fn in (
            ("lz4_decode_ms", lambda: lz4_decode2.decompress_batch(sl.data, sl.sizes, CHUNK)),
            ("lz4_decode_single_ms", lambda: lz4_decode.decompress_batch(sl.data, sl.sizes,
                                                                         CHUNK)),
            *((f"lz4_decode_k{k}_ms",
               lambda k=k: lz4_decodek.decompress_batch(sl.data, sl.sizes, CHUNK, k=k))
              for k in (1, 3, 4, 32)),
            ("lz4_encode_hash_ms", lambda: lz4_encode.compress_batch(cb.data, sizes,
                                                                     out_caps["lz4"])),
            ("snappy_encode_hash_ms", lambda: snappy_encode.compress_batch(cb.data, sizes,
                                                                           out_caps["snappy"])),
            ("gdeflate_decode_ms", lambda: gdeflate_decode.decompress_batch(gc1.data, gc1.sizes,
                                                                            CHUNK)),
            ("gdeflate_vdecode_ms", lambda: gdeflate_vdecode.decompress_batch(gc1.data,
                                                                              gc1.sizes, CHUNK)))}
        kernel_ms["lz4_decode_single"] += t["lz4_decode_single_ms"]
        kernel_ms["lz4_decode_k"] += t["lz4_decode_k4_ms"]
        kernel_ms["lz4_encode_hash"] += t["lz4_encode_hash_ms"]
        kernel_ms["snappy_encode_hash"] += t["snappy_encode_hash_ms"]
        kernel_ms["gdeflate_decode"] += t["gdeflate_decode_ms"]
        dec_bound = bytes_bound_ms(int(sl.total_bytes) + 4 * B, B * CHUNK + 8 * B)
        bound["lz4_decode_single"] += dec_bound
        bound["lz4_decode_k"] += dec_bound
        for fmt in ("lz4", "snappy"):
            bound[f"{fmt}_encode_hash"] += bytes_bound_ms(raw_bytes + 4 * B,
                                                          B * out_caps[fmt] + 8 * B)
        bound["gdeflate_decode"] += bytes_bound_ms(int(gc1.total_bytes) + 4 * B,
                                                   B * CHUNK + 8 * B)
        row.update(t)
        print(f"[variants] {json.dumps(row)}")
    del vresults
    lap("4 checks and timings, variants")

    # the probes path: row 27 through its own entry points, _probe.main() and
    # main2() on the reference's inputs, counted on its own; then each probe
    # timed on those inputs (the first of each CHECK_CASES entry) beside the
    # one PyTorch call that computes the same function there (library_ms)
    reset_counts()
    check(_probe.main() and _probe.main2(), "a probe of _probe.main() / main2() failed")
    torch.cuda.synchronize()
    plaunches = read_counts()
    print(f"[probes] launches in the probes-path run: { {k: plaunches[k] for k in PROBES} }")
    check(all(plaunches[k] > 0 for k in PROBES),
          f"a kernel of the probes path was not launched: {plaunches}")
    launches.update({k: plaunches[k] for k in PROBES})
    lap("4 probes path")

    library_ms = {}
    for pname, (xk, scalars) in _probe.CHECK_CASES.items():
        v = None if scalars is None else scalars[0]
        args = _probe.check_args(xk, v, pblocks, dev)
        x, sv = args[0], (None if v is None else int(v))
        scratch = torch.full((16, 128), -2**31, dtype=torch.int32, device=dev)
        lib = {"p1": lambda: x[0, args[1]], "p3": lambda: x[0, args[1]],
               "p10": lambda: x[0, args[1]], "p11": lambda: x[0, args[1]],
               "p2": lambda: torch.roll(x, sv, 1),
               "p4": lambda: torch.add(x[sv:sv + 2], 1, out=scratch[sv:sv + 2]),
               "p5": lambda: scratch[0, sv:].copy_(x[0, sv:]),
               "p6": lambda: x[0, :sv].sum(),
               "p7": lambda: scratch[sv:sv + 2].copy_(scratch[0:2]),
               "p8": lambda: x.to(torch.int32) * 2,
               "p9": lambda: torch.arange(128, device=dev) * 3}[pname]
        kname = f"probe_{pname}"
        # host-bound calls of some 10-30 us: many calls, kernel and library in
        # turns (kernel, library, library, kernel), each the mean of its two
        pk = lambda: _probe.PROBES[pname](*args)  # noqa: E731
        turns = [time_ms(torch, fn, PROBE_ITERS, PROBE_ITERS // 10) for fn in (pk, lib, lib, pk)]
        kernel_ms[kname] = (turns[0] + turns[3]) / 2
        library_ms[kname] = (turns[1] + turns[2]) / 2
        card_plain = time_ms(torch, lambda: _probe.PLAIN[pname](*args))
        in_bytes, out_bytes = probe_bytes(pname, x, sv)
        bound[kname] = bytes_bound_ms(in_bytes, out_bytes)
        split = {f"{who}_{k}": v2 for who, fn in (("kernel", lambda: _probe.PROBES[pname](*args)),
                                                  ("library", lib))
                 for k, v2 in host_device_ms(torch, fn).items()}
        print(f"[probes] {json.dumps({'probe': pname, 'input': xk, 'scalar': v, 'kernel_ms': kernel_ms[kname], 'library_ms': library_ms[kname], 'plain_on_card_ms': card_plain, 'read_bytes': in_bytes, 'written_bytes': out_bytes, 'bound_ms': bound[kname], 'bound': 'launch (under 64 KiB moved)', **split})}")
    lap("4 timings, probes")

    # Zstandard compress at nvCOMP's largest chunk: each corpus as 4 chunks of
    # 16 MiB through batched.compress (the multi-block encoder, torch ops on
    # the card, no kernel of its own) and back through batched.decompress
    # (row 19), counted on its own
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    zbig = {}
    for name, raw in corpora.items():
        bcb = ChunkBatch.from_bytes(raw, BIG_CHUNK, device=dev)
        bcomp, bcst = batched.compress("zstd", bcb)
        zbig[name] = (bcb, bcomp, bcst) + batched.decompress("zstd", bcomp, BIG_CHUNK)
    torch.cuda.synchronize()
    zlaunches = read_counts()
    print(f"[zstd16] launches in the 16 MiB compress path: "
          f"{ {k: v for k, v in zlaunches.items() if v} }; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(zlaunches["zstd_decode_big"] > 0, "row 19 was not launched on the 16 MiB path")
    lap("4 zstd 16 MiB compress path")

    def stage_ms(cb) -> dict:
        """The stages of one multi-block compress of ``cb``, each timed alone
        (CUDA events) on the arguments it had in that call: the match finder
        (per slice of blocks), the Huffman literal sections (per slice), the
        repeat-offset scan and the three FSE state chains (one loop)."""
        where = {"find_matches_ms": (flz4, "_find_matches"),
                 "huf_literals_ms": (fzstd, "_huf_literals"),
                 "rep_scan_ms": (fzstd, "_rep_codes"), "fse_chains_ms": (fzstd, "_fse_chains")}
        orig = {k: getattr(mod, attr) for k, (mod, attr) in where.items()}
        seen = {k: [] for k in where}

        def recorder(k):
            def rec(*a, **kw):
                seen[k].append((a, kw))
                return orig[k](*a, **kw)
            return rec

        for k, (mod, attr) in where.items():
            setattr(mod, attr, recorder(k))
        try:
            batched.compress("zstd", cb)
        finally:
            for k, (mod, attr) in where.items():
                setattr(mod, attr, orig[k])
        return {k: sum(time_ms(torch, lambda a=a, kw=kw, f=orig[k]: f(*a, **kw), iters=1,
                               warmup=0) for a, kw in seen[k]) for k in where}

    for name, (bcb, bcomp, bcst, bdec, bdst) in zbig.items():
        raw_bytes = len(corpora[name])
        check(bool((bcst == Status.SUCCESS).all()),
              f"{name} zstd compress at 16 MiB chunks: statuses {bcst.tolist()}")
        check(all(pool.map(lambda f_r: interop.zstd_decompress(f_r[0], len(f_r[1])) == f_r[1],
                           zip(bcomp.chunk_list(), bcb.chunk_list()))),
              f"{name} zstd compress at 16 MiB chunks: libzstd does not read every frame back")
        check(bool((bdst == Status.SUCCESS).all()) and torch.equal(bdec.sizes, bcb.sizes)
              and torch.equal(bdec.data, bcb.data),
              f"{name} zstd compress at 16 MiB chunks: row 19 does not read every frame back")
        t_comp = time_ms(torch, lambda: batched.compress("zstd", bcb), iters=1, warmup=0)
        st = stage_ms(bcb)
        scans = st["rep_scan_ms"] + st["fse_chains_ms"]
        row = {"corpus": name, "format": "zstd", "path": "multi-block encoder (torch ops)",
               "chunk_bytes": BIG_CHUNK, "chunks": bcb.num_chunks,
               "ratio": raw_bytes / int(bcomp.sizes.sum()),
               "libzstd3_ratio": raw_bytes / int(staged[name, "zstd_big"].total_bytes),
               "compress_ms": t_comp, "compress_GBps": raw_bytes / t_comp / 1e6, **st,
               "scans_share_of_compress": scans / t_comp,
               "read_by": "libzstd and row 19, bit-exact"}
        print(f"[zstd16] {json.dumps(row)}")
    del zbig
    lap("4 checks and timings, zstd 16 MiB compress")

    readers = {"lz4": lambda f, r: interop.lz4_decompress(f, len(r)) == r,
               "snappy": lambda f, r: interop.snappy_decompress(f) == r}
    emitters = {"lz4": lz4_encode2.emit_kernel, "snappy": snappy_encode2.emit_kernel}
    row6 = {}    # corpus -> row 6's ms on the staged streams: the parse, the walk
    for (name, fmt), (comp, cst, dec, dst, sdec, sdst) in results.items():
        cb = batches[name]
        B = cb.num_chunks
        out_cap = out_caps[fmt]
        check(bool((cst == Status.SUCCESS).all()), f"{name} {fmt}: compress statuses")
        check(bool((dst == Status.SUCCESS).all()) and bool((sdst == Status.SUCCESS).all()),
              f"{name} {fmt}: decompress statuses")
        check(torch.equal(dec.sizes, cb.sizes) and torch.equal(dec.data, cb.data),
              f"{name} {fmt}: round trip through the port's frames is not bit-exact")
        check(torch.equal(sdec.sizes, cb.sizes) and torch.equal(sdec.data, cb.data),
              f"{name} {fmt}: decode of the staged streams is not bit-exact")
        if have[fmt]:
            check(all(readers[fmt](f, r) for f, r in zip(comp.chunk_list(), cb.chunk_list())),
                  f"{name}: the {fmt} C library does not read the port's frames back")
        raw_bytes = int(cb.total_bytes)
        comp_bytes = int(comp.total_bytes)
        sd = staged[name, fmt]
        staged_bytes = int(sd.total_bytes)

        sizes = cb.sizes
        cand = match.candidates2(cb.data, sizes)
        emit = emitters[fmt]
        t_cand = time_ms(torch, lambda: match.candidates2(cb.data, sizes))
        t_emit = time_ms(torch, lambda: emit(cb.data, sizes, *cand, out_cap))
        t_comp = time_ms(torch, lambda: batched.compress(fmt, cb))
        t_dec = time_ms(torch, lambda: decoders[fmt][0](sd.data, sd.sizes, CHUNK))
        if fmt == "snappy":   # row 6: the parse (the main path's) and the walk, same input
            t_walk = time_ms(torch, lambda: snappy_decode.decompress_batch_walk(
                sd.data, sd.sizes, CHUNK))
            kernel_ms["snappy_decode_walk"] += t_walk
            bound["snappy_decode_walk"] += bytes_bound_ms(staged_bytes + 4 * B,
                                                          B * CHUNK + 8 * B)
            row6[name] = {"parse_ms": t_dec, "walk_ms": t_walk}
        kernel_ms[f"{fmt}_decode"] += t_dec
        kernel_ms[f"{fmt}_encode"] += t_emit
        bound[f"{fmt}_decode"] += bytes_bound_ms(staged_bytes + 4 * B, B * CHUNK + 8 * B)
        bound[f"{fmt}_encode"] += bytes_bound_ms(raw_bytes + 4 * B, B * out_cap + 8 * B)
        row = {"corpus": name, "format": fmt, "chunks": B, "raw_bytes": raw_bytes,
               "ratio": raw_bytes / comp_bytes,
               "staged_ratio": raw_bytes / staged_bytes,
               "staged_by": ("liblz4" if fmt == "lz4" else "libsnappy") if have[fmt]
               else "port",
               "decompress_ms": t_dec, "decompress_GBps": raw_bytes / t_dec / 1e6,
               "compress_ms": t_comp, "compress_GBps": raw_bytes / t_comp / 1e6,
               "candidates2_ms": t_cand, "emit_kernel_ms": t_emit,
               "emit_kernel_GBps": raw_bytes / t_emit / 1e6}
        print(f"[full] {json.dumps(row)}")

    def zlib_reads(f_r) -> bool:
        return zlib.decompress(f_r[0], -15) == f_r[1]

    def libdeflate_reads(f_r) -> bool:
        return interop.libdeflate_decompress(f_r[0], len(f_r[1])) == f_r[1]

    win = deflate_encode.WINDOW
    row11 = {}   # corpus -> row 11's ms: hist in algos 1 and 2
    row12 = {}   # corpus -> row 12's ms: emit in algos 1 and 2
    for (name, algo), (comp, cst, dec, dst) in dresults.items():
        cb = batches[name]
        B, sizes = cb.num_chunks, cb.sizes
        check(bool((cst == Status.SUCCESS).all()) and bool((dst == Status.SUCCESS).all()),
              f"{name} deflate algo {algo}: statuses")
        check(torch.equal(dec.sizes, cb.sizes) and torch.equal(dec.data, cb.data),
              f"{name} deflate algo {algo}: round trip through the port's frames")
        pairs = list(zip(comp.chunk_list(), cb.chunk_list()))
        check(all(pool.map(zlib_reads, pairs)),
              f"{name} deflate algo {algo}: zlib does not read the port's frames back")
        if have["libdeflate"]:
            check(all(pool.map(libdeflate_reads, pairs)),
                  f"{name} deflate algo {algo}: libdeflate does not read the port's frames")
        raw_bytes, comp_bytes = int(cb.total_bytes), int(comp.total_bytes)
        opts = fdeflate.DeflateOpts(algo)
        t_comp = time_ms(torch, lambda: batched.compress("deflate", cb, opts))
        t_dec = time_ms(torch, lambda: deflate_decode.decompress_batch(comp.data, comp.sizes,
                                                                       CHUNK))
        row = {"corpus": name, "format": "deflate", "algo": algo, "chunks": B,
               "raw_bytes": raw_bytes, "ratio": raw_bytes / comp_bytes,
               "compress_ms": t_comp, "compress_GBps": raw_bytes / t_comp / 1e6,
               "decompress_ms": t_dec, "decompress_GBps": raw_bytes / t_dec / 1e6}
        cands = None
        if algo != 2:
            cands = match.candidates2(cb.data, sizes, window=win)
            row["candidates2_ms"] = time_ms(torch, lambda: match.candidates2(cb.data, sizes,
                                                                            window=win))
        io_bytes = raw_bytes + 4 * B
        if algo == 0:
            t = time_ms(torch, lambda: deflate_encode.fixed_kernel(cb.data, sizes, cands, dcap))
            row["fixed_kernel_ms"] = t
            kernel_ms["deflate_encode_fixed"] += t
            bound["deflate_encode_fixed"] += bytes_bound_ms(io_bytes, B * dcap + 8 * B)
        else:
            llh, dh = deflate_encode.hist_kernel(cb.data, sizes, cands)
            tables = deflate_encode.dyn_tables(llh, dh)
            t_hist = time_ms(torch, lambda: deflate_encode.hist_kernel(cb.data, sizes, cands))
            t_emit = time_ms(torch, lambda: deflate_encode.emit_kernel(cb.data, sizes, cands,
                                                                       *tables, dcap))
            row11.setdefault(name, {})[f"hist_algo{algo}_ms"] = t_hist
            row12.setdefault(name, {})[f"emit_algo{algo}_ms"] = t_emit
            row.update(hist_kernel_ms=t_hist,
                       dyn_tables_ms=time_ms(torch, lambda: deflate_encode.dyn_tables(llh, dh)),
                       emit_kernel_ms=t_emit,
                       dynamic_headers=int((tables[2] > 3).sum()))
            if algo == 1:       # the kernels line carries algo 1 (algo 2: the [full] rows)
                kernel_ms["deflate_encode_hist"] += t_hist
                kernel_ms["deflate_encode_emit"] += t_emit
                bound["deflate_encode_hist"] += bytes_bound_ms(io_bytes, B * 318 * 4)
                bound["deflate_encode_emit"] += bytes_bound_ms(io_bytes + B * 399 * 4,
                                                               B * dcap + 8 * B)
        print(f"[full] {json.dumps(row)}")
    for name, (sdec, sdst, gdec, gdst) in dstaged.items():
        cb = batches[name]
        B, raw_bytes = cb.num_chunks, int(cb.total_bytes)
        for fmt, d, st in (("deflate", sdec, sdst), ("gzip", gdec, gdst)):
            check(bool((st == Status.SUCCESS).all()) and torch.equal(d.sizes, cb.sizes)
                  and torch.equal(d.data, cb.data),
                  f"{name} {fmt}: decode of the zlib-staged streams is not bit-exact")
        sd, gd = staged[name, "deflate"], staged[name, "gzip"]
        t_dec = time_ms(torch, lambda: deflate_decode.decompress_batch(sd.data, sd.sizes, CHUNK))
        t_gz = time_ms(torch, lambda: batched.decompress("gzip", gd, CHUNK))
        kernel_ms["deflate_decode"] += t_dec
        bound["deflate_decode"] += bytes_bound_ms(int(sd.total_bytes) + 8 * B,
                                                  B * CHUNK + 8 * B)
        for fmt, sb, t in (("deflate", sd, t_dec), ("gzip", gd, t_gz)):
            row = {"corpus": name, "format": fmt, "staged_by": "zlib level 6", "chunks": B,
                   "staged_ratio": raw_bytes / int(sb.total_bytes), "decompress_ms": t,
                   "decompress_GBps": raw_bytes / t / 1e6}
            print(f"[full] {json.dumps(row)}")
    for name, (zdec, zst, bdec, bst) in zresults.items():
        cb = batches[name]
        raw_bytes = int(cb.total_bytes)
        bcb = ChunkBatch.from_bytes(corpora[name], BIG_CHUNK, device=dev)
        for label, d, st, want in (("64 KiB", zdec, zst, cb), ("16 MiB", bdec, bst, bcb)):
            check(bool((st == Status.SUCCESS).all()) and torch.equal(d.sizes, want.sizes)
                  and torch.equal(d.data, want.data),
                  f"{name} zstd {label} chunks: decode of the libzstd-staged frames is not "
                  f"bit-exact")
        zd, bd = staged[name, "zstd"], staged[name, "zstd_big"]
        t_dec = time_ms(torch, lambda: zstd_decode.decompress_batch(zd.data, zd.sizes, CHUNK))
        # row 18's fixed cost a call: the first 1 and 8 of those frames
        small = {n: time_ms(torch, lambda: zstd_decode.decompress_batch(
            zd.data[:n], zd.sizes[:n], CHUNK)) for n in (1, 8)}
        print(f"[full] {json.dumps({'corpus': name, 'kernel': 'zstd_decode', 'chunks_ms': small})}")
        t_big = time_ms(torch, lambda: zstd_decode.decompress_batch_big(bd.data, bd.sizes,
                                                                        BIG_CHUNK),
                        iters=BIG_ITERS, warmup=1)
        for kname, sb, chunk, t in (("zstd_decode", zd, CHUNK, t_dec),
                                    ("zstd_decode_big", bd, BIG_CHUNK, t_big)):
            B = sb.num_chunks
            kernel_ms[kname] += t
            bound[kname] += bytes_bound_ms(int(sb.total_bytes) + 4 * B, B * chunk + 8 * B)
            row = {"corpus": name, "format": "zstd", "kernel": kname, "chunk_bytes": chunk,
                   "chunks": B, "staged_by": "libzstd level 3",
                   "staged_ratio": raw_bytes / int(sb.total_bytes), "decompress_ms": t,
                   "decompress_GBps": raw_bytes / t / 1e6}
            print(f"[full] {json.dumps(row)}")
        # row 19's passes, each timed alone on the arguments it had in one more call
        B = bd.num_chunks
        lit_cap = zstd_decode.lit_cap_of(BIG_CHUNK, big=True)
        kp = {}
        zp.run(bd.data, bd.sizes, BIG_CHUNK, lit_cap, keep=kp)
        nblk, nseq, nlit, _, most = kp["totals"]
        blk = kp["blk"]
        pass_ms = {
            "zstd_chain": time_ms(torch, lambda: zp.fill_kernel(
                bd.data, bd.sizes, BIG_CHUNK, lit_cap,
                *zp.chain_kernel(bd.data, bd.sizes, BIG_CHUNK, lit_cap)[:2], nblk),
                iters=BIG_ITERS, warmup=1),
            "zstd_entropy": time_ms(torch, lambda: zp.entropy_kernel(bd.data, blk, nlit, nseq),
                                    iters=BIG_ITERS, warmup=1),
            "zstd_scan": time_ms(torch, lambda: zp.scan_kernel(
                kp["fcount"], kp["bases"], kp["bout"], kp["bsym"], kp["berr"], BIG_CHUNK),
                iters=BIG_ITERS, warmup=1),
            "zstd_resolve": time_ms(torch, lambda: zp.resolve_kernel(
                blk, kp["seqs"], kp["bstart"], kp["bin"], kp["fstat0"]), iters=BIG_ITERS,
                warmup=1),
            "zstd_zero": time_ms(torch, lambda: zp.zero_kernel(kp["fstat"], kp["fsize"],
                                                               BIG_CHUNK),
                                 iters=BIG_ITERS, warmup=1),
            "zstd_execute": time_ms(torch, lambda: zp.execute_kernel(
                bd.data, blk, kp["lits"], kp["seqs"], kp["offs"], kp["bstart"], kp["bout"],
                kp["fstat"], kp["out0"], most > 1), iters=BIG_ITERS, warmup=1)}
        # the bytes each pass must move on this data (inputs read once, outputs
        # written once): headers and records, the compressed blocks, literals,
        # sequences (20 B; resolve reads 12 B and writes 4 B of each), the
        # rows' zero tails and the output
        rec = blk.cpu()
        btype = rec[:, zp.F_TYPE] & 3
        comp_blocks = int(rec[btype == 2, zp.F_BSIZE].sum())
        raw_blocks = int(rec[btype == 0, zp.F_BSIZE].sum()) + int((btype == 1).sum())
        headers = (3 * nblk + int((rec[:, zp.F_SPOS] - rec[:, zp.F_POS])[btype == 2].sum())
                   + int((rec[:, zp.F_SQ] - rec[:, zp.F_LIT_END])[btype == 2].sum())
                   + int((rec[:, zp.F_NSEQ] > 0).sum()))
        out_bytes = int(kp["fsize"][kp["fstat"] == 0].sum())
        pass_bound = {
            "zstd_chain": bytes_bound_ms(headers + 4 * B + 24 * B, 32 * B + 128 * nblk),
            "zstd_entropy": bytes_bound_ms(comp_blocks + 128 * nblk, nlit + 20 * nseq + 24 * nblk),
            "zstd_scan": bytes_bound_ms(56 * B + 24 * nblk, 32 * nblk + 12 * B),
            "zstd_resolve": bytes_bound_ms(12 * nseq + 160 * nblk + 4 * B, 4 * nseq + 4 * B),
            "zstd_zero": bytes_bound_ms(12 * B, B * BIG_CHUNK - out_bytes + 8 * B),
            "zstd_execute": bytes_bound_ms(nlit + 20 * nseq + raw_blocks + 144 * nblk,
                                           out_bytes)}
        for k in ZSTD_PASSES:
            kernel_ms[k] += pass_ms[k]
            bound[k] += pass_bound[k]
        print(f"[full] {json.dumps({'corpus': name, 'format': 'zstd', 'kernel': 'zstd_decode_big', 'passes_ms': pass_ms, 'passes_bound_ms': pass_bound, 'blocks': nblk, 'sequences': nseq, 'literals': nlit})}")

    def libzstd_reads(f_r) -> bool:
        return interop.zstd_decompress(f_r[0], len(f_r[1])) == f_r[1]

    row21 = {}   # corpus -> row 21's ms, exact entropy (and the parse alone, the speed rung)
    row20 = {}   # corpus -> row 20's ms

    for name, rungs in zenc.items():
        cb = batches[name]
        B, sizes, raw_bytes = cb.num_chunks, cb.sizes, int(cb.total_bytes)
        for rung, (comp, cst, dec, dst) in rungs.items():
            check(bool((cst == Status.SUCCESS).all()) and bool((dst == Status.SUCCESS).all()),
                  f"{name} zstd compress ({rung}): statuses")
            check(torch.equal(dec.sizes, cb.sizes) and torch.equal(dec.data, cb.data),
                  f"{name} zstd compress ({rung}): round trip through row 18 is not bit-exact")
            check(all(pool.map(libzstd_reads, zip(comp.chunk_list(), cb.chunk_list()))),
                  f"{name} zstd compress ({rung}): libzstd does not read the port's frames back")
        cands = match.candidates2(cb.data, sizes, window=zwin)
        freq, sch = zstd_encode.hist_kernel(cb.data, sizes, cands)

        def tables():
            return zstd_encode.seq_tables(sch) + zstd_encode.huf_meta(freq)

        fse_tab, nc, meta, tree = tables()
        # row 21 in exact entropy (as compress_batch calls it) and in the speed rung
        t_full = time_ms(torch, lambda: zstd_encode.full_kernel(cb.data, sizes, cands, meta, tree,
                                                                fse_tab, nc, zcap))
        smeta, stree = zstd_encode.huf_meta(zstd_encode.whole_chunk_hist(cb.data, sizes))
        sfse, snc = zstd_encode.speed_tables(B, dev)
        row21[name] = {
            "full_ms": t_full,
            "speed_rung_ms": time_ms(torch, lambda: zstd_encode.full_kernel(
                cb.data, sizes, cands, smeta, stree, sfse, snc, zcap))}
        t_hist = time_ms(torch, lambda: zstd_encode.hist_kernel(cb.data, sizes, cands))
        row20[name] = t_hist
        nseq = int(sch[:, :36].sum())
        kernel_ms["zstd_encode_hist"] += t_hist
        kernel_ms["zstd_encode"] += t_full
        bound["zstd_encode_hist"] += bytes_bound_ms(raw_bytes + 4 * B, B * 377 * 4)
        # full reads the data, sizes, Huffman meta and tree rows, the ncount
        # bytes and, of fse_tab, the words at the sequences' states (3 a
        # sequence) and each chunk's 8 first-slot and meta words
        bound["zstd_encode"] += bytes_bound_ms(
            raw_bytes + 8 * B + B * (258 * 4 + 176) + int(fse_tab[:, zstd_encode.O2_META + 4].sum())
            + 4 * (3 * nseq + 8 * B), B * zcap + 8 * B)
        comp = rungs["exact entropy"][0]
        row = {"corpus": name, "format": "zstd", "chunks": B, "raw_bytes": raw_bytes,
               "sequences": nseq,
               "libzstd3_ratio": raw_bytes / int(staged[name, "zstd"].total_bytes)}
        for rung, (c, *_rest) in rungs.items():
            row[f"ratio ({rung})"] = raw_bytes / int(c.total_bytes)
        row.update(
            compress_ms=time_ms(torch, lambda: batched.compress("zstd", cb)),
            candidates2_ms=time_ms(torch, lambda: match.candidates2(cb.data, sizes, window=zwin)),
            hist_kernel_ms=t_hist, zstd_tables_ms=time_ms(torch, tables), full_kernel_ms=t_full,
            speed_compress_ms=time_ms(torch, lambda: zstd_encode.compress_batch(
                cb.data, sizes, zcap, exact_entropy=False)),
            speed_tables_ms=time_ms(torch, lambda: zstd_encode.huf_meta(
                zstd_encode.whole_chunk_hist(cb.data, sizes))),
            decompress_ms=time_ms(torch, lambda: zstd_decode.decompress_batch(
                comp.data, comp.sizes, CHUNK)))
        row["compress_GBps"] = raw_bytes / row["compress_ms"] / 1e6
        row["speed_compress_GBps"] = raw_bytes / row["speed_compress_ms"] / 1e6
        print(f"[full] {json.dumps(row)}")
    print(f"[row11] Deflate hist kernel ms a corpus of 1024 x 64 KiB (mean of {ITERS} calls): "
          f"{json.dumps(row11)}")
    print(f"[row12] Deflate emit kernel ms a corpus of 1024 x 64 KiB (mean of {ITERS} calls): "
          f"{json.dumps(row12)}")
    print(f"[row21] Zstandard full kernel ms a corpus of 1024 x 64 KiB (mean of {ITERS} calls; "
          f"exact entropy and the speed rung): {json.dumps(row21)}")
    print(f"[row20] Zstandard hist kernel ms a corpus of 1024 x 64 KiB (mean of {ITERS} calls): "
          f"{json.dumps(row20)}; {smi}")
    print(f"[row6] Snappy decode ms a corpus of 1024 x 64 KiB on the staged streams (mean of "
          f"{ITERS} calls; the parse, the main path's, and the walk): {json.dumps(row6)}; {smi}")
    lap("4 checks and timings, lz4 to zstd")
    row16 = {}   # corpus -> row 16's ms: hist in algos 1 and 2
    row17 = {}   # corpus -> row 17's ms: fixed (algo 0), emit (algos 1 and 2)
    for (name, algo), (comp, cst, dec, dst) in gresults.items():
        cb = batches[name]
        B, sizes, raw_bytes = cb.num_chunks, cb.sizes, int(cb.total_bytes)
        check(bool((cst == Status.SUCCESS).all()) and bool((dst == Status.SUCCESS).all()),
              f"{name} gdeflate algo {algo}: statuses")
        check(torch.equal(dec.sizes, cb.sizes) and torch.equal(dec.data, cb.data),
              f"{name} gdeflate algo {algo}: round trip through the port's tiles")
        tiles, raws = comp.chunk_list(), cb.chunk_list()
        pick = (0, B // 2, B - 1)
        check(all(pyref.decompress(tiles[i]) == raws[i] for i in pick),
              f"{name} gdeflate algo {algo}: tests/gdeflate_pyref.py does not read the tiles")
        opts = fgdeflate.GdeflateOpts(algo)
        cands = None if algo == 2 else match.candidates2(cb.data, sizes)
        parse = gdeflate_vdecode.parse_kernel(comp.data, comp.sizes, CHUNK)
        n_eff = torch.minimum(parse[0][:, 1], torch.tensor(parse[1].shape[1], dtype=torch.int32,
                                                           device=dev))
        t_parse = time_ms(torch, lambda: gdeflate_vdecode.parse_kernel(comp.data, comp.sizes,
                                                                       CHUNK))
        t_exec = time_ms(torch, lambda: gdeflate_vdecode.exec_kernel(parse[1], n_eff, CHUNK))
        gtimes = {"iters": GD_ITERS, "warmup": 1}
        row = {"corpus": name, "format": "gdeflate", "algo": algo, "chunks": B,
               "raw_bytes": raw_bytes, "ratio": raw_bytes / int(comp.total_bytes),
               "pyref_read": len(pick),
               "compress_ms": time_ms(torch, lambda: batched.compress("gdeflate", cb, opts),
                                      **gtimes),
               "decompress_ms": time_ms(torch, lambda: batched.decompress("gdeflate", comp,
                                                                           CHUNK)),
               "parse_kernel_ms": t_parse, "exec_kernel_ms": t_exec,
               "tokens": int(n_eff.sum())}
        if cands is not None:
            row["candidates2_ms"] = time_ms(torch, lambda: match.candidates2(cb.data, sizes),
                                            **gtimes)
        io_bytes = raw_bytes + 4 * B
        if algo == 0:
            lanes = gdeflate_encode.fixed_kernel(cb.data, sizes, cands)
            extra = gdeflate_encode.fixed_header(B, dev)
            row["fixed_kernel_ms"] = time_ms(
                torch, lambda: gdeflate_encode.fixed_kernel(cb.data, sizes, cands), **gtimes)
            row17.setdefault(name, {})["fixed_ms"] = row["fixed_kernel_ms"]
        else:
            llh, dh = gdeflate_encode.hist_kernel(cb.data, sizes, cands)
            tab, desc, hdr_b, use_dyn = gdeflate_encode.dyn_tables_gd(llh, dh)
            lanes = gdeflate_encode.emit_kernel(cb.data, sizes, cands, tab)
            extra = (torch.where(use_dyn, 2, 1).to(torch.int32), desc, hdr_b)
            t_hist = time_ms(torch, lambda: gdeflate_encode.hist_kernel(cb.data, sizes, cands),
                             **gtimes)
            t_emit = time_ms(torch, lambda: gdeflate_encode.emit_kernel(cb.data, sizes, cands,
                                                                        tab), **gtimes)
            row16.setdefault(name, {})[f"hist_algo{algo}_ms"] = t_hist
            row17.setdefault(name, {})[f"emit_algo{algo}_ms"] = t_emit
            row.update(hist_kernel_ms=t_hist, emit_kernel_ms=t_emit,
                       dyn_tables_gd_ms=time_ms(
                           torch, lambda: gdeflate_encode.dyn_tables_gd(llh, dh), **gtimes),
                       dynamic_tiles=int(use_dyn.sum()))
            if algo == 1:       # the kernels line carries algo 1 (algos 0, 2: the [full] rows)
                kernel_ms["gdeflate_encode_hist"] += t_hist
                kernel_ms["gdeflate_encode"] += t_emit
                bound["gdeflate_encode_hist"] += bytes_bound_ms(io_bytes, B * 320 * 4)
                bound["gdeflate_encode"] += bytes_bound_ms(
                    io_bytes + B * 320 * 4,
                    4 * B * (gdeflate_encode.WCAP * 32 + gdeflate_encode.NT_CAP // 2 + 36))
        row["schedule_and_assemble_ms"] = time_ms(
            torch, lambda: gdeflate_encode.schedule_and_assemble(*lanes, cb.data, sizes, gdcap,
                                                                 *extra), **gtimes)
        if algo == 1:
            kernel_ms["gdeflate_parse"] += t_parse
            kernel_ms["gdeflate_exec"] += t_exec
            bound["gdeflate_parse"] += bytes_bound_ms(
                int(comp.total_bytes) + 4 * B,
                4 * B * (gdeflate_vdecode.NTAB + parse[1].shape[1] + 2))
            bound["gdeflate_exec"] += bytes_bound_ms(4 * int(n_eff.sum()) + 4 * B,
                                                     B * CHUNK + 8 * B)
        row["compress_GBps"] = raw_bytes / row["compress_ms"] / 1e6
        row["decompress_GBps"] = raw_bytes / row["decompress_ms"] / 1e6
        print(f"[full] {json.dumps(row)}")
    print(f"[row16] GDeflate hist kernel ms a corpus of 1024 x 64 KiB "
          f"(mean of {GD_ITERS} calls): {json.dumps(row16)}")
    print(f"[row17] GDeflate fixed and emit kernel ms a corpus of 1024 x 64 KiB "
          f"(mean of {GD_ITERS} calls): {json.dumps(row17)}")
    print(f"[full] peak device memory of the main-path run: {peak} bytes")
    del results, staged, dresults, dstaged, zresults, zenc, gresults

    lap("4 checks and timings, gdeflate")
    for name, (comp, cst, dec, dst, sout, ssz, sst, sdec, sdsz, sdst) in aresults.items():
        cb = batches[name]
        B, sizes, raw_bytes = cb.num_chunks, cb.sizes, int(cb.total_bytes)
        check(bool((cst == Status.SUCCESS).all()) and bool((dst == Status.SUCCESS).all()),
              f"{name} ans: statuses")
        check(torch.equal(dec.sizes, cb.sizes) and torch.equal(dec.data, cb.data),
              f"{name} ans: round trip through the port's frames is not bit-exact")
        check(torch.equal(sout, comp.data) and torch.equal(ssz, comp.sizes)
              and torch.equal(sst, cst),
              f"{name} ans: row 24's frames differ from row 25's")
        check(torch.equal(sdec, dec.data) and torch.equal(sdsz, dec.sizes)
              and torch.equal(sdst, dst), f"{name} ans: row 22's output differs from row 23's")
        counts = np.stack([np.bincount(r, minlength=256)
                           for r in cb.data.cpu().numpy()]).astype(np.float64)
        p = counts / np.maximum(counts.sum(axis=1, keepdims=True), 1)
        h0_bytes = float(-(counts * np.log2(np.where(p > 0, p, 1))).sum() / 8)
        freq, cum = fans.tables_for(cb.data, sizes)
        walk = ans_encode.walk_kernel_wide(cb.data, sizes, freq, cum)
        comp_bytes = int(comp.total_bytes)
        t = {k: time_ms(torch, fn) for k, fn in (
            ("compress_ms", lambda: batched.compress("ans", cb)),
            ("tables_for_ms", lambda: fans.tables_for(cb.data, sizes)),
            ("walk_wide_ms", lambda: ans_encode.walk_kernel_wide(cb.data, sizes, freq, cum)),
            ("walk_ms", lambda: ans_encode.walk_kernel(cb.data, sizes, freq, cum)),
            ("serialize_scan_ms", lambda: fans.serialize_scan(sizes, freq, walk[2], walk[3],
                                                              walk[0], walk[1], acap)),
            ("decompress_ms", lambda: batched.decompress("ans", comp, CHUNK)),
            ("decode_wide_ms", lambda: ans_decode.decompress_batch_wide(comp.data, comp.sizes,
                                                                        CHUNK)),
            ("decode_ms", lambda: ans_decode.decompress_batch(comp.data, comp.sizes, CHUNK)))}
        kernel_ms["ans_encode"] += t["walk_ms"]
        kernel_ms["ans_encode_wide"] += t["walk_wide_ms"]
        kernel_ms["ans_decode"] += t["decode_ms"]
        kernel_ms["ans_decode_wide"] += t["decode_wide_ms"]
        for k in ("ans_encode", "ans_encode_wide"):
            bound[k] += bytes_bound_ms(raw_bytes + 4 * B, comp_bytes + 8 * B)
        for k in ("ans_decode", "ans_decode_wide"):
            bound[k] += bytes_bound_ms(comp_bytes + 4 * B, B * CHUNK + 8 * B)
        row = {"corpus": name, "format": "ans", "chunks": B, "raw_bytes": raw_bytes,
               "ratio": raw_bytes / comp_bytes, "order0_entropy_ratio": raw_bytes / h0_bytes,
               "stream_words": (comp_bytes - B * fans.HEADER_BYTES) // 2, **t,
               "compress_GBps": raw_bytes / t["compress_ms"] / 1e6,
               "decompress_GBps": raw_bytes / t["decompress_ms"] / 1e6}
        print(f"[full] {json.dumps(row)}")
    del aresults

    lap("4 checks and timings, ans")

    # Cascaded: round trips, the general program's frames (backend "xla") beside
    # the fast path's, the golden frames through both backends, and the times
    # of the fast path's stages, each timed alone
    gblob = (HERE / "tests" / "golden" / "cascaded.bin").read_bytes()
    ng = int(np.frombuffer(gblob[:4], np.int32)[0])
    goff = 4 + 4 * ng + np.concatenate([[0], np.cumsum(np.frombuffer(gblob[4:4 + 4 * ng],
                                                                     np.int32))])
    cgold = ChunkBatch.from_chunks([gblob[goff[i]:goff[i + 1]] for i in range(ng)], device=dev)
    for backend, want in (("xla", [0, 0, 0]), ("auto", [0, 12, 12])):
        gdec, gst = batched.decompress("cascaded", cgold, gk, backend=backend)
        gbytes = gdec.chunk_list()
        check(gst.tolist() == want and all(gbytes[i] == graw[i * gk:(i + 1) * gk]
                                           for i in range(ng) if want[i] == 0),
              f"cascaded golden frames, backend {backend}: statuses {gst.tolist()}, "
              f"the reference's {want}")
        print(f"[full] cascaded golden frames, backend {backend}: statuses {gst.tolist()} "
              f"(the reference's {want})")
    for name, (comp, cst, dec, dst) in cresults.items():
        cb, opts = cas_batches[name], cas_opts[name]
        B, sizes, raw_bytes = cb.num_chunks, cb.sizes, int(cb.total_bytes)
        check(bool((cst == Status.SUCCESS).all()) and bool((dst == Status.SUCCESS).all()),
              f"{name} cascaded: statuses")
        check(torch.equal(dec.sizes, cb.sizes) and torch.equal(dec.data, cb.data),
              f"{name} cascaded: round trip through the fast path is not bit-exact")
        xcomp, xcst = batched.compress("cascaded", cb, opts, backend="xla")
        same = int(((xcomp.data == comp.data).all(dim=1) & (xcomp.sizes == comp.sizes)).sum())
        check(bool((xcst == Status.SUCCESS).all()), f"{name} cascaded: xla compress statuses")
        check(name not in CAS_SAME_FRAMES or same == B,
              f"{name} cascaded: {same} of {B} fast-path frames equal the general program's")
        for fcomp, backend in ((xcomp, "auto"), (comp, "xla")):
            xdec, xdst = batched.decompress("cascaded", fcomp, CHUNK, backend=backend)
            check(bool((xdst == Status.SUCCESS).all()) and torch.equal(xdec.data, cb.data),
                  f"{name} cascaded: the decoder of backend {backend} does not read the "
                  f"other encoder's frames bit-exactly")
        args, s1 = stage1_args(comp.data, comp.sizes)
        elo, ehi = cascaded_expand.expand_batch(*args, CHUNK)
        e64 = (elo.to(torch.int64) & 0xFFFFFFFF, ehi.to(torch.int64) & 0xFFFFFFFF)
        times = {"iters": CAS_ITERS, "warmup": 1}
        t = {k: time_ms(torch, fn, **times) for k, fn in (
            ("compress_ms", lambda: batched.compress("cascaded", cb, opts)),
            ("decompress_ms", lambda: batched.decompress("cascaded", comp, CHUNK)),
            ("stage1_ms", lambda: stage1_args(comp.data, comp.sizes)),
            ("expand_ms", lambda: cascaded_expand.expand_batch(*args, CHUNK)),
            ("stage2_ms", lambda: cascaded_fast._stage2(*e64, s1[5], s1[4][:, 0], s1[6],
                                                        CHUNK)),
            ("xla_compress_ms", lambda: batched.compress("cascaded", cb, opts,
                                                         backend="xla")))}
        sc = s1[4].to(torch.int64)
        n1, n2, nr = sc[:, 1], sc[:, 2], sc[:, 3]
        # row 26 reads runs1[:n1], runs2[:n2] (4 B each), the values [:n2] (two
        # halves, 8 B) and the scalars (16 B), and writes 8 B an element of each
        # output row; the function needs no intermediate row, and the kernel's
        # scratch counts and indices are not counted
        ex_read = int((4 * n1 * (nr >= 1) + 4 * n2 * (nr >= 2) + 8 * n2 + 16).sum())
        ex_written = 8 * CHUNK * B
        kernel_ms["cascaded_expand"] += t["expand_ms"]
        bound["cascaded_expand"] += bytes_bound_ms(ex_read, ex_written)
        comp_bytes = int(comp.total_bytes)
        row = {"corpus": name, "format": "cascaded",
               "opts": f"{opts.type.name} r{opts.num_rles} d{opts.num_deltas} "
                       f"bp{int(opts.use_bp)}",
               "chunks": B, "raw_bytes": raw_bytes, "ratio": raw_bytes / comp_bytes,
               "xla_ratio": raw_bytes / int(xcomp.total_bytes),
               "frames_equal_to_xla": same, "runs1": int(n1.sum()), "runs2": int(n2.sum()),
               **t, "expand_read_bytes": ex_read, "expand_written_bytes": ex_written,
               "compress_GBps": raw_bytes / t["compress_ms"] / 1e6,
               "decompress_GBps": raw_bytes / t["decompress_ms"] / 1e6}
        print(f"[full] {json.dumps(row)}")
    del cresults

    lap("4 checks and timings, cascaded")

    # --------------------------------------------------------------- 5 manager
    verify = ChecksumPolicy.COMPUTE_AND_VERIFY
    bufs = {name: torch.frombuffer(bytearray(raw), dtype=torch.uint8).to(dev)
            for name, raw in corpora.items()}
    mgr_opts = {"lz4": None, "snappy": None, "deflate": fdeflate.DeflateOpts(algo=1),
                "zstd": None, "gdeflate": fgdeflate.GdeflateOpts(algo=1), "ans": None,
                "cascaded": None}

    def opts_of(fmt: str, name: str):
        """The Manager's options: Cascaded takes each corpus's configuration."""
        return cas_opts[name] if fmt == "cascaded" else mgr_opts[fmt]

    torch.cuda.synchronize()
    reset_counts()
    frames = {}
    for name, buf in bufs.items():            # the Manager path, once
        for fmt in mgr_opts:
            opts = opts_of(fmt, name)
            frame = Manager(fmt, CHUNK, opts, checksum_policy=verify).compress(buf)
            mgr = create_manager(frame)
            cfg = mgr.configure_decompression(frame)
            out = mgr.decompress(frame, cfg)
            frames[name, fmt] = (frame, mgr, cfg, out)
    torch.cuda.synchronize()
    mgr_launches = read_counts()
    print(f"[manager] launches in the Manager-path run: {mgr_launches}")
    # algo 1 runs the hist and emit walks, not the fixed ones; 64 KiB chunks take row 18;
    # ANS dispatches the wide wrappers (rows 23, 25)
    check(all(v > 0 for k, v in mgr_launches.items()
              if k not in ("deflate_encode_fixed", "zstd_decode_big", "ans_decode",
                           "ans_encode", *OFF_MAIN)),
          f"a kernel was not launched on the Manager path: {mgr_launches}")
    for (name, fmt), (frame, mgr, cfg, out) in frames.items():
        buf = bufs[name]
        check(mgr.format == fmt and cfg.get_status() == Status.SUCCESS
              and torch.equal(out, buf),
              f"manager {name} {fmt}: round trip is not bit-exact or not SUCCESS")
        host = frame.cpu().numpy()
        n = cfg.num_chunks
        csz = host[56:56 + 4 * n].view(np.uint32).astype(np.int64)
        end = 56 + 12 * n + int(((csz + 3) // 4 * 4)[:n // 2 + 1].sum())
        bad = frame.clone()
        bad[end - (-int(csz[n // 2]) % 4) - 1] ^= 0xFF   # last byte of a middle chunk
        bcfg = mgr.configure_decompression(bad)
        mgr.decompress(bad, bcfg)
        check(bcfg.get_status() == Status.ERROR_BAD_CHECKSUM,
              f"manager {name} {fmt}: a flipped payload byte gave {bcfg.get_status()!r}")
        check(fmt != "cascaded" or mgr.opts == opts_of(fmt, name),
              f"manager {name} {fmt}: create_manager read {mgr.opts!r} from the opts blob")
        plain_mgr = Manager(fmt, CHUNK, opts_of(fmt, name))
        stripped = without_crc_tables(host, n)
        check(stripped.tobytes() == plain_mgr.compress(buf).cpu().numpy().tobytes(),
              f"manager {name} {fmt}: the frame minus its CRC tables differs from "
              f"a NO_COMPUTE_NO_VERIFY manager's frame")
        pcfg = plain_mgr.configure_decompression(stripped)
        check(torch.equal(plain_mgr.decompress(stripped, pcfg), buf)
              and pcfg.get_status() == Status.SUCCESS,
              f"manager {name} {fmt}: the frame without CRC tables does not read back")

        m = Manager(fmt, CHUNK, opts_of(fmt, name), checksum_policy=verify)
        t_comp = time_ms(torch, lambda: m.compress(buf))
        t_dec = time_ms(torch, lambda: mgr.decompress(frame, cfg))
        cb = batches[name]
        t_crc = time_ms(torch, lambda: crc32.crc32_batch(cb.data, cb.sizes))
        raw_bytes = buf.numel()
        row = {"corpus": name, "format": fmt, "opts": repr(opts_of(fmt, name)),
               "policy": verify.name, "chunks": n,
               "raw_bytes": raw_bytes, "frame_bytes": frame.numel(),
               "frame_ratio": raw_bytes / frame.numel(),
               "compress_ms": t_comp, "compress_GBps": raw_bytes / t_comp / 1e6,
               "decompress_ms": t_dec, "decompress_GBps": raw_bytes / t_dec / 1e6,
               "crc32_ms": t_crc, "crc32_GBps": raw_bytes / t_crc / 1e6,
               "bad_checksum": bcfg.get_status().name}
        print(f"[manager] {json.dumps(row)}")

    lap("5 manager")

    # Manager("zstd", 16 MiB chunks): each 64 MiB buffer as 4 chunks through
    # the multi-block encoder, CRC32 computed and verified, counted on its own
    reset_counts()
    for name, buf in bufs.items():
        m16 = Manager("zstd", BIG_CHUNK, checksum_policy=verify)
        t = time.perf_counter()
        frame = m16.compress(buf)
        torch.cuda.synchronize()
        t_comp = time.perf_counter() - t
        mgr = create_manager(frame)
        cfg = mgr.configure_decompression(frame)
        t = time.perf_counter()
        out = mgr.decompress(frame, cfg)
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t
        check(mgr.format == "zstd" and cfg.num_chunks == 4 and cfg.get_status() == Status.SUCCESS
              and torch.equal(out, buf),
              f"manager {name} zstd at 16 MiB chunks: round trip is not bit-exact or not SUCCESS")
        row = {"corpus": name, "format": "zstd", "chunk_size": BIG_CHUNK,
               "policy": verify.name, "chunks": cfg.num_chunks, "raw_bytes": buf.numel(),
               "frame_ratio": buf.numel() / frame.numel(),
               "compress_s_host_clock": t_comp, "decompress_s_host_clock": t_dec}
        print(f"[manager16] {json.dumps(row)}")
    m16_launches = read_counts()
    check(m16_launches["zstd_decode_big"] > 0, "row 19 was not launched by the 16 MiB Manager")
    lap("5 manager, zstd 16 MiB chunks")
    print(f"[time] wall seconds by phase: {json.dumps(phase_s)}; "
          f"{sum(phase_s.values()):.1f} s in all")

    # -------------------------------------------------------------- 6 results
    kernels = []
    for name, (src, replaces) in KERNELS.items():
        kernels.append({"name": name, "route": "cuda",
                        "source": f"tpucomp_torch/ops/cuda/csrc/{src}",
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": max_err[name], "ms": kernel_ms[name],
                        "plain_ms": plain_ms[name], "bound_ms": bound[name],
                        "bound_by": "bytes", "library_ms": library_ms.get(name)})
    print("[kernels] ms, bound_ms: the two full-width corpora summed (deflate_decode on "
          "the zlib-staged streams, deflate_encode_hist/emit in algo 1, zstd_decode on "
          "1024 x 64 KiB and zstd_decode_big on 4 x 16 MiB libzstd-staged frames (both the "
          "passes as a whole; zstd_chain (count and fill) .. zstd_execute each pass of "
          "zstd_decode_big alone, bound by the bytes it must move on this data; zstd_walk "
          "the status-only frame walk on 1024 x 64 KiB frames marked by the chain for "
          "64-byte rows, launches from the settle path's own run), "
          "snappy_decode is row 6's parse and snappy_decode_walk its walk, both timed on the "
          "staged streams at out_cap 64 KiB (the walk's launches from the wide Snappy path's "
          "own run, rows of 64 KiB + 1024 bytes), "
          "zstd_encode_hist/zstd_encode in exact entropy, gdeflate_* in algo 1: "
          "gdeflate_encode is the emit mode (the parse; bound_ms leaves out its reads of "
          "cand and cand8, 8 B a position), gdeflate_parse/exec read the port's algo-1 "
          "tiles; ans_encode/_wide are the walk alone, bound by the raw bytes read and the "
          "frames written, ans_decode/_wide read the port's frames); launches: the batched "
          "main-path run (gdeflate_encode: modes fixed and emit; ans_encode and ans_decode "
          "through their own wrappers in that run); cascaded_expand: the three Cascaded "
          "configurations summed, on the fast decoder's _stage1 outputs of the port's "
          "frames, bound by runs1[:n1] and runs2[:n2] (4 B each), the values [:n2] (8 B) "
          "and the scalars read and 8 B an element of every row written; "
          "lz4_decode_single, lz4_decode_k (k 4), lz4_encode_hash, snappy_encode_hash and "
          "gdeflate_decode: the variants path (rows 3-4 on the staged LZ4 streams, row 15 "
          "on the port's algo-1 tiles), launches from its own run; plain_ms: the plain "
          "version on the "
          "phase-3 inputs (host; each ANS plain version ran once for both of its kernels, "
          "and row 1's for rows 1, 3 and 4, its time stands beside each); no PyTorch "
          "call computes LZ4, Snappy, Deflate, "
          "Zstandard, GDeflate, rANS or this two-pass RLE expansion; probe_p1-p11 (row 27): "
          "launches from the probes path (_probe.main/main2), ms and library_ms on the "
          "reference's inputs (200 calls each, in turns kernel, library, library, kernel), "
          "library_ms the one PyTorch call of the same function "
          "(x[0, idx], torch.roll, a slice add or copy_, x[0, :n].sum(), x.to(int32) * 2, "
          "arange(128) * 3), bound_ms their bytes (under 64 KiB each) over the memory rate: "
          "launch-bound")
    print(json.dumps({"kernels": kernels}))
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
