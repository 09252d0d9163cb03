#!/usr/bin/env python3
"""On-card smoke run of tpucomp_torch: batched LZ4 on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure ends the run with a non-zero
exit code and no result line:

1. device: name, count, and ``nvidia-smi``'s name and power limit;
2. build: both CUDA kernels from ``tpucomp_torch/ops/cuda/csrc`` (one ``nvcc``
   each, in parallel), with their ``-Xptxas -v`` register/shared-memory lines;
3. kernel vs plain: each kernel on the card against its plain version on a
   host copy of the same inputs (<= 8 chunks per corpus at the main path's
   64 KiB shape, edge streams, truncated and bit-flipped streams, an out_cap
   that is too small); exact equality of bytes, sizes and statuses;
4. full width: two 64 MiB corpora from seed 42 (``mortgage_like``,
   ``mixed_corpus``) cut into 1024 chunks of 64 KiB, one batch each, through
   ``batched.compress`` / ``batched.decompress`` (backend "auto"), with the
   launch counts of that run, bit-exact round trips, liblz4 reading the
   port's frames, and CUDA-event timings;
5. the ``kernels`` JSON line, ``nvidia-smi``'s line, and last
   ``{"ok": true, "device": {...}}``.

Exits non-zero without a CUDA device, and when the package beside this
script is missing.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
CHUNK = 1 << 16           # DEFAULT_CHUNK_SIZE: the reference's chunk size
CORPUS_BYTES = 64 << 20   # 1024 chunks per batch
SEED = 42
PHASE3_CHUNKS = 8
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
WARMUP, ITERS = 2, 10


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters=ITERS) -> float:
    """Mean milliseconds of ``fn()`` on the card, after warm-up (CUDA events)."""
    for _ in range(WARMUP):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bytes_bound_ms(read: int, written: int) -> float:
    return (read + written) / HBM_BYTES_PER_S * 1e3


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    import tpucomp_torch
    check(Path(tpucomp_torch.__file__).resolve().parent == HERE / "tpucomp_torch",
          f"tpucomp_torch was imported from {tpucomp_torch.__file__}, not from "
          f"the checkout beside this script")
    from tpucomp_torch import batched
    from tpucomp_torch.chunk import ChunkBatch
    from tpucomp_torch.constants import Status
    from tpucomp_torch.formats import lz4 as flz4
    from tpucomp_torch.interop import cpu as interop
    from tpucomp_torch.ops import match
    from tpucomp_torch.ops.cuda import _build, lz4_decode2, lz4_encode2
    from tpucomp_torch.utils import synth

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

    # ------------------------------------------------------------ corpora
    t0 = time.perf_counter()
    corpora = {"mortgage": synth.mortgage_like(CORPUS_BYTES, seed=SEED).tobytes(),
               "mixed": synth.mixed_corpus(CORPUS_BYTES, seed=SEED).tobytes()}
    have_lz4 = interop.available()["lz4"]
    print(f"[data] two corpora of {CORPUS_BYTES >> 20} MiB, seed {SEED}, "
          f"{time.perf_counter() - t0:.1f} s; liblz4 "
          f"{'loaded' if have_lz4 else 'did not load: the port encoder stages decode inputs'}")
    out_cap = flz4.max_compressed_chunk_size(CHUNK)

    def stage(chunks: list[bytes]) -> list[bytes]:
        """Compressed streams for the decoder: liblz4's, else the port's."""
        if have_lz4:
            return [interop.lz4_compress(c) for c in chunks]
        cb = ChunkBatch.from_chunks(chunks, CHUNK, device=dev)
        comp, st = batched.compress("lz4", cb)
        check(bool((st == Status.SUCCESS).all()), "staging with the port encoder")
        return comp.chunk_list()

    # ------------------------------------------------------- 3 kernel vs plain
    max_err = {"lz4_decode": 0, "lz4_encode": 0}
    plain_ms = {"lz4_decode": 0.0, "lz4_encode": 0.0}

    def compare(name, kernel_fn, plain_fn, args_cpu, label):
        got = kernel_fn(*[a.to(dev) if torch.is_tensor(a) else a for a in args_cpu])
        torch.cuda.synchronize()
        t = time.perf_counter()
        want = plain_fn(*args_cpu)
        plain_ms[name] += (time.perf_counter() - t) * 1e3
        err = max(int((g.cpu().to(torch.int64) - w.to(torch.int64)).abs().max())
                  if g.numel() else 0 for g, w in zip(got, want))
        max_err[name] = max(max_err[name], err)
        same = all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
        stats = np.bincount(want[2].numpy(), minlength=16)
        print(f"[kernel=plain] {name} {label}: B={args_cpu[0].shape[0]} "
              f"tolerance=exact equal={same} max_abs_err={err} statuses(ok/cannot/small)="
              f"{stats[0]}/{stats[12]}/{stats[15]}")
        check(same, f"{name} kernel differs from its plain version on {label}")

    head = {k: [v[i * CHUNK:(i + 1) * CHUNK] for i in range(PHASE3_CHUNKS)]
            for k, v in corpora.items()}
    rng = np.random.default_rng(SEED)
    edge_raw = [b"", b"x", b"\x00" * 3000, b"ab" * 1500, b"abcdefg" * 400,
                (b"0123456789abcdef" * 20)[:300] * 12, b"\x00" * CHUNK,
                bytes(rng.integers(0, 256, 5000, dtype=np.uint8))]
    good = stage([synth.mixed_corpus(2048, seed=33).tobytes()])[0]
    fuzz = [good[:max(1, c)] for c in (1, 2, len(good) // 4, len(good) // 2,
                                       len(good) - 2, len(good) - 1)]
    frng = np.random.default_rng(len(good))
    for _ in range(6):   # built as tests/test_pallas_fuzz.py builds them
        b = bytearray(good)
        b[frng.integers(0, len(good))] ^= 1 << frng.integers(0, 8)
        fuzz.append(bytes(b))
    handmade = [b"\x04abcd\x00\x00", b"\x04abcd\xff\xff\x04abcd",
                b"\x10a\x02\x00\x10b", b"\x10a\x01\x00\x10b",
                b"\x40abcd\x01\x00", b"\xff" * 64, b"\x10", b"\xf0\xff\xff\xff"]
    streams = (stage(head["mortgage"] + head["mixed"] + edge_raw) + [good] + fuzz
               + handmade)
    dec_in = ChunkBatch.from_chunks(streams, out_cap, device="cpu")
    for cap, label in ((CHUNK, "64 KiB out_cap"), (1000, "out_cap too small")):
        compare("lz4_decode", lz4_decode2.decompress_batch,
                lz4_decode2.decompress_batch_plain, (dec_in.data, dec_in.sizes, cap),
                f"{len(streams)} streams, {label}")

    enc_rows = head["mortgage"] + head["mixed"]
    enc_in = ChunkBatch.from_chunks(enc_rows + [head["mixed"][0]] * 5, CHUNK, device="cpu")
    enc_in.sizes[len(enc_rows):] = torch.tensor([0, 1, 12, 13, 17], dtype=torch.int32)
    cand_gpu = match.candidates2(enc_in.data.to(dev), enc_in.sizes.to(dev))
    cand_cpu = match.candidates2(enc_in.data, enc_in.sizes)
    check(all(torch.equal(g.cpu(), c) for g, c in zip(cand_gpu, cand_cpu)),
          "candidates2 on the card differs from the CPU")
    print("[kernel=plain] candidates2 on the card == on the CPU")
    for cap, label in ((out_cap, "out_cap = bound"), (4096, "out_cap too small")):
        compare("lz4_encode", lz4_encode2.compress_batch,
                lz4_encode2.compress_batch_plain, (enc_in.data, enc_in.sizes, cap),
                f"{enc_in.num_chunks} chunks, {label}")

    # ------------------------------------------------------------ 4 full width
    batches, staged = {}, {}
    for name, raw in corpora.items():
        batches[name] = ChunkBatch.from_bytes(raw, CHUNK, device=dev)
        chunks = [raw[i:i + CHUNK] for i in range(0, len(raw), CHUNK)]
        staged[name] = ChunkBatch.from_chunks(stage(chunks), out_cap, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lz4_decode2.decompress_batch.launches = 0
    lz4_encode2.emit_kernel.launches = 0
    results = {}
    for name, cb in batches.items():          # the main path, once
        comp, cst = batched.compress("lz4", cb)
        dec, dst = batched.decompress("lz4", comp, CHUNK)
        sdec, sdst = batched.decompress("lz4", staged[name], CHUNK)
        results[name] = (comp, cst, dec, dst, sdec, sdst)
    torch.cuda.synchronize()
    launches = {"lz4_decode": lz4_decode2.decompress_batch.launches,
                "lz4_encode": lz4_encode2.emit_kernel.launches}
    peak = torch.cuda.max_memory_allocated()
    print(f"[full] launches in the main-path run: {launches}; peak device memory "
          f"{peak / 2**30:.2f} GiB")
    check(all(v > 0 for v in launches.values()), f"a kernel was not launched: {launches}")

    kernel_ms = {"lz4_decode": 0.0, "lz4_encode": 0.0}
    bound = {"lz4_decode": 0.0, "lz4_encode": 0.0}
    for name, cb in batches.items():
        comp, cst, dec, dst, sdec, sdst = results[name]
        B = cb.num_chunks
        check(bool((cst == Status.SUCCESS).all()), f"{name}: compress statuses")
        check(bool((dst == Status.SUCCESS).all()) and bool((sdst == Status.SUCCESS).all()),
              f"{name}: decompress statuses")
        check(torch.equal(dec.sizes, cb.sizes) and torch.equal(dec.data, cb.data),
              f"{name}: round trip through the port's frames is not bit-exact")
        check(torch.equal(sdec.sizes, cb.sizes) and torch.equal(sdec.data, cb.data),
              f"{name}: decode of the staged streams is not bit-exact")
        raw_chunks = cb.chunk_list()
        if have_lz4:
            frames = comp.chunk_list()
            check(all(interop.lz4_decompress(f, len(r)) == r
                      for f, r in zip(frames, raw_chunks)),
                  f"{name}: liblz4 does not read the port's frames back")
        raw_bytes = int(cb.total_bytes)
        comp_bytes = int(comp.total_bytes)
        staged_bytes = int(staged[name].total_bytes)

        sizes = cb.sizes
        cand = match.candidates2(cb.data, sizes)
        t_cand = time_ms(torch, lambda: match.candidates2(cb.data, sizes))
        t_emit = time_ms(torch, lambda: lz4_encode2.emit_kernel(cb.data, sizes, *cand, out_cap))
        t_comp = time_ms(torch, lambda: batched.compress("lz4", cb))
        sd = staged[name]
        t_dec = time_ms(torch, lambda: lz4_decode2.decompress_batch(
            sd.data, sd.sizes, CHUNK))
        kernel_ms["lz4_decode"] += t_dec
        kernel_ms["lz4_encode"] += t_emit
        bound["lz4_decode"] += bytes_bound_ms(staged_bytes + 4 * B, B * CHUNK + 8 * B)
        bound["lz4_encode"] += bytes_bound_ms(raw_bytes + 4 * B, B * out_cap + 8 * B)
        row = {"corpus": name, "chunks": B, "raw_bytes": raw_bytes,
               "ratio": raw_bytes / comp_bytes,
               "staged_ratio": raw_bytes / staged_bytes,
               "staged_by": "liblz4" if have_lz4 else "port",
               "decompress_ms": t_dec, "decompress_GBps": raw_bytes / t_dec / 1e6,
               "compress_ms": t_comp, "compress_GBps": raw_bytes / t_comp / 1e6,
               "candidates2_ms": t_cand, "emit_kernel_ms": t_emit,
               "emit_kernel_GBps": raw_bytes / t_emit / 1e6}
        print(f"[full] {json.dumps(row)}")
    print(f"[full] peak device memory of the main-path run: {peak} bytes")

    kernels = [
        {"name": "lz4_decode", "route": "cuda",
         "source": "tpucomp_torch/ops/cuda/csrc/lz4_decode.cu",
         "replaces": "tpucomp/ops/pallas/lz4_decode2.py:34"},
        {"name": "lz4_encode", "route": "cuda",
         "source": "tpucomp_torch/ops/cuda/csrc/lz4_encode.cu",
         "replaces": "tpucomp/ops/pallas/lz4_encode2.py:50"},
    ]
    for k in kernels:
        n = k["name"]
        k.update(launches=launches[n], max_abs_err=max_err[n], ms=kernel_ms[n],
                 plain_ms=plain_ms[n], bound_ms=bound[n], bound_by="bytes",
                 library_ms=None)
    print("[kernels] ms, bound_ms: the two full-width corpora summed; plain_ms: "
          "the plain version on the phase-3 inputs (host); no PyTorch call computes LZ4")
    print(json.dumps({"kernels": kernels}))
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
