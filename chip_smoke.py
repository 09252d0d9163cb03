#!/usr/bin/env python3
"""On-card smoke run of tpucomp_torch: batched LZ4 and Snappy, and the
Manager frame path with CRC32 checksums, on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure ends the run with a non-zero
exit code and no result line:

1. device: name, count, and ``nvidia-smi``'s name and power limit;
2. build: the four CUDA kernels from ``tpucomp_torch/ops/cuda/csrc`` (one
   ``nvcc`` each, in parallel), with their ``-Xptxas -v`` register/shared-memory
   lines;
3. kernel vs plain: each kernel on the card against its plain version on a
   host copy of the same inputs (<= 8 chunks per corpus at the main path's
   64 KiB shape, edge and hand-made streams, truncated and bit-flipped
   streams, an out_cap that is too small); exact equality of bytes, sizes and
   statuses;
4. full width: two 64 MiB corpora from seed 42 (``mortgage_like``,
   ``mixed_corpus``) cut into 1024 chunks of 64 KiB, one batch each, through
   ``batched.compress`` / ``batched.decompress`` (backend "auto") for LZ4 and
   Snappy, with the launch counts of that run, bit-exact round trips, liblz4
   and libsnappy reading the port's frames, and CUDA-event timings;
5. manager: each corpus as one 64 MiB buffer through ``Manager(fmt, 65536,
   COMPUTE_AND_VERIFY)`` for LZ4 and Snappy, ``create_manager`` and
   ``decompress`` (bit-exact, ``SUCCESS``), a flipped payload byte
   (``ERROR_BAD_CHECKSUM``), the frame without its CRC tables through a
   ``NO_COMPUTE_NO_VERIFY`` manager, with its own launch counts and timings;
6. the ``kernels`` JSON line, ``nvidia-smi``'s line, and last
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
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "lz4_decode": ("lz4_decode.cu", "tpucomp/ops/pallas/lz4_decode2.py:34"),
    "lz4_encode": ("lz4_encode.cu", "tpucomp/ops/pallas/lz4_encode2.py:50"),
    "snappy_decode": ("snappy_decode.cu", "tpucomp/ops/pallas/snappy_decode.py:29"),
    "snappy_encode": ("snappy_encode.cu", "tpucomp/ops/pallas/snappy_encode2.py:33"),
}


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
    import tpucomp_torch
    check(Path(tpucomp_torch.__file__).resolve().parent == HERE / "tpucomp_torch",
          f"tpucomp_torch was imported from {tpucomp_torch.__file__}, not from "
          f"the checkout beside this script")
    from tpucomp_torch import batched
    from tpucomp_torch.chunk import ChunkBatch
    from tpucomp_torch.constants import Status
    from tpucomp_torch.formats import crc32
    from tpucomp_torch.formats import lz4 as flz4
    from tpucomp_torch.formats import snappy as fsnappy
    from tpucomp_torch.interop import cpu as interop
    from tpucomp_torch.manager import ChecksumPolicy, Manager, create_manager
    from tpucomp_torch.ops import match
    from tpucomp_torch.ops.cuda import (_build, lz4_decode2, lz4_encode2, snappy_decode,
                                        snappy_encode2)
    from tpucomp_torch.utils import synth

    counters = {"lz4_decode": lz4_decode2.decompress_batch,
                "lz4_encode": lz4_encode2.emit_kernel,
                "snappy_decode": snappy_decode.decompress_batch,
                "snappy_encode": snappy_encode2.emit_kernel}

    def reset_counts() -> None:
        for fn in counters.values():
            fn.launches = 0

    def read_counts() -> dict:
        return {k: fn.launches for k, fn in counters.items()}

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
    have = interop.available()
    print(f"[data] two corpora of {CORPUS_BYTES >> 20} MiB, seed {SEED}, "
          f"{time.perf_counter() - t0:.1f} s; liblz4 "
          f"{'loaded' if have['lz4'] else 'did not load: the port encoder stages decode inputs'}"
          f"; libsnappy "
          f"{'loaded' if have['snappy'] else 'did not load: the port encoder stages decode inputs'}")
    out_caps = {"lz4": flz4.max_compressed_chunk_size(CHUNK),
                "snappy": fsnappy.max_compressed_chunk_size(CHUNK)}
    oracle = {"lz4": interop.lz4_compress, "snappy": interop.snappy_compress}

    def stage(fmt: str, chunks: list[bytes]) -> list[bytes]:
        """Compressed streams for the decoder: the C library's, else the port's."""
        if have[fmt]:
            return [oracle[fmt](c) for c in chunks]
        cb = ChunkBatch.from_chunks(chunks, CHUNK, device=dev)
        comp, st = batched.compress(fmt, cb)
        check(bool((st == Status.SUCCESS).all()), f"staging with the port's {fmt} encoder")
        return comp.chunk_list()

    # ------------------------------------------------------- 3 kernel vs plain
    max_err = {k: 0 for k in KERNELS}
    plain_ms = {k: 0.0 for k in KERNELS}

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
        dec_in = ChunkBatch.from_chunks(streams, out_caps[fmt], device="cpu")
        for cap, label in ((CHUNK, "64 KiB out_cap"), (1000, "out_cap too small")):
            compare(f"{fmt}_decode", kernel_fn, plain_fn,
                    (dec_in.data, dec_in.sizes, cap), f"{len(streams)} streams, {label}")
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

    # ------------------------------------------------------------ 4 full width
    batches, staged = {}, {}
    for name, raw in corpora.items():
        batches[name] = ChunkBatch.from_bytes(raw, CHUNK, device=dev)
        chunks = [raw[i:i + CHUNK] for i in range(0, len(raw), CHUNK)]
        for fmt in out_caps:
            staged[name, fmt] = ChunkBatch.from_chunks(stage(fmt, chunks), out_caps[fmt],
                                                       device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    results = {}
    for name, cb in batches.items():          # the main path, once
        for fmt in out_caps:
            comp, cst = batched.compress(fmt, cb)
            dec, dst = batched.decompress(fmt, comp, CHUNK)
            sdec, sdst = batched.decompress(fmt, staged[name, fmt], CHUNK)
            results[name, fmt] = (comp, cst, dec, dst, sdec, sdst)
    torch.cuda.synchronize()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"[full] launches in the main-path run: {launches}; peak device memory "
          f"{peak / 2**30:.2f} GiB")
    check(all(v > 0 for v in launches.values()), f"a kernel was not launched: {launches}")

    kernel_ms = {k: 0.0 for k in KERNELS}
    bound = {k: 0.0 for k in KERNELS}
    readers = {"lz4": lambda f, r: interop.lz4_decompress(f, len(r)) == r,
               "snappy": lambda f, r: interop.snappy_decompress(f) == r}
    emitters = {"lz4": lz4_encode2.emit_kernel, "snappy": snappy_encode2.emit_kernel}
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
    print(f"[full] peak device memory of the main-path run: {peak} bytes")
    del results, staged

    # --------------------------------------------------------------- 5 manager
    verify = ChecksumPolicy.COMPUTE_AND_VERIFY
    bufs = {name: torch.frombuffer(bytearray(raw), dtype=torch.uint8).to(dev)
            for name, raw in corpora.items()}
    torch.cuda.synchronize()
    reset_counts()
    frames = {}
    for name, buf in bufs.items():            # the Manager path, once
        for fmt in out_caps:
            frame = Manager(fmt, CHUNK, checksum_policy=verify).compress(buf)
            mgr = create_manager(frame)
            cfg = mgr.configure_decompression(frame)
            out = mgr.decompress(frame, cfg)
            frames[name, fmt] = (frame, mgr, cfg, out)
    torch.cuda.synchronize()
    mgr_launches = read_counts()
    print(f"[manager] launches in the Manager-path run: {mgr_launches}")
    check(all(v > 0 for v in mgr_launches.values()),
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
        plain_mgr = Manager(fmt, CHUNK)
        stripped = without_crc_tables(host, n)
        check(stripped.tobytes() == plain_mgr.compress(buf).cpu().numpy().tobytes(),
              f"manager {name} {fmt}: the frame minus its CRC tables differs from "
              f"a NO_COMPUTE_NO_VERIFY manager's frame")
        pcfg = plain_mgr.configure_decompression(stripped)
        check(torch.equal(plain_mgr.decompress(stripped, pcfg), buf)
              and pcfg.get_status() == Status.SUCCESS,
              f"manager {name} {fmt}: the frame without CRC tables does not read back")

        m = Manager(fmt, CHUNK, checksum_policy=verify)
        t_comp = time_ms(torch, lambda: m.compress(buf))
        t_dec = time_ms(torch, lambda: mgr.decompress(frame, cfg))
        cb = batches[name]
        t_crc = time_ms(torch, lambda: crc32.crc32_batch(cb.data, cb.sizes))
        raw_bytes = buf.numel()
        row = {"corpus": name, "format": fmt, "policy": verify.name, "chunks": n,
               "raw_bytes": raw_bytes, "frame_bytes": frame.numel(),
               "frame_ratio": raw_bytes / frame.numel(),
               "compress_ms": t_comp, "compress_GBps": raw_bytes / t_comp / 1e6,
               "decompress_ms": t_dec, "decompress_GBps": raw_bytes / t_dec / 1e6,
               "crc32_ms": t_crc, "crc32_GBps": raw_bytes / t_crc / 1e6,
               "bad_checksum": bcfg.get_status().name}
        print(f"[manager] {json.dumps(row)}")

    # -------------------------------------------------------------- 6 results
    kernels = []
    for name, (src, replaces) in KERNELS.items():
        kernels.append({"name": name, "route": "cuda",
                        "source": f"tpucomp_torch/ops/cuda/csrc/{src}",
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": max_err[name], "ms": kernel_ms[name],
                        "plain_ms": plain_ms[name], "bound_ms": bound[name],
                        "bound_by": "bytes", "library_ms": None})
    print("[kernels] ms, bound_ms: the two full-width corpora summed; launches: the "
          "batched main-path run; plain_ms: the plain version on the phase-3 inputs "
          "(host); no PyTorch call computes LZ4 or Snappy")
    print(json.dumps({"kernels": kernels}))
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
