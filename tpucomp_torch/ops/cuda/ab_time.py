"""Time the parse kernels of two checkouts in turns, on one card.

    python -m tpucomp_torch.ops.cuda.ab_time PARENT CHANGE [--order PCCP]

``PARENT`` and ``CHANGE`` are the roots of two checkouts (for example one
unpacked by ``git archive`` into the ignored ``build/``).  Each letter of
``--order`` runs one process on that checkout's own package (its sources,
its build): it builds the kernels, makes the two 64 MiB corpora of
``chip_smoke.py`` (``mortgage_like`` and ``mixed_corpus``, seed 42) as 1024
chunks of 64 KiB, and times with CUDA events, in ``--rounds`` rounds of
``--iters`` calls after two warm-up calls, the Deflate and GDeflate ``hist``
kernels (algo 1 on ``candidates2``'s arrays, algo 2 with none), the two
``emit`` kernels of algo 1, the Zstandard ``hist`` kernel (row 20, on
``candidates2``'s arrays with the 64 KiB window) and the Snappy decoder (row
6, on the port's own Snappy frames of the corpus, ``out_cap`` 64 KiB).  It
prints one JSON line: the card's name and
power limit, the median, least and greatest ms of each kernel and corpus,
and a digest of each output.  The parent process prints those lines and a
summary, and exits 1 when two checkouts' outputs differ or a process fails.
Needs a CUDA card; a checkout's wrappers must take the arguments used here.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

CHUNK = 1 << 16
CORPUS_BYTES = 64 << 20
SEED = 42


def _one(tree: Path, rounds: int, iters: int) -> dict:
    """Time the kernels of the checkout at ``tree`` (this process imports its package)."""
    here = Path(__file__).resolve().parent    # on sys.path when run by its path: drop it
    sys.path[:] = [str(tree)] + [p for p in sys.path if Path(p or ".").resolve() != here]
    import torch
    import tpucomp_torch
    if Path(tpucomp_torch.__file__).resolve().parent != tree / "tpucomp_torch":
        raise SystemExit(f"ab_time: imported {tpucomp_torch.__file__}, not {tree}")
    from tpucomp_torch.chunk import ChunkBatch
    from tpucomp_torch.formats import deflate as fdeflate, snappy as fsnappy
    from tpucomp_torch.ops import match
    from tpucomp_torch.ops.cuda import _build, deflate_encode as de, gdeflate_encode as ge
    from tpucomp_torch.ops.cuda import snappy_decode, snappy_encode2, zstd_encode as ze
    from tpucomp_torch.utils import synth

    if not torch.cuda.is_available():
        raise SystemExit("ab_time: no CUDA device")
    _build.build_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    dcap = fdeflate.max_compressed_chunk_size(CHUNK)
    corpora = {"mortgage": synth.mortgage_like(CORPUS_BYTES, seed=SEED),
               "mixed": synth.mixed_corpus(CORPUS_BYTES, seed=SEED)}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def time_ms(fn) -> list[float]:
        for _ in range(2):
            fn()
        out = []
        for _ in range(rounds):
            torch.cuda.synchronize()
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(end) / iters)
        return out

    def digest(outs) -> str:
        h = hashlib.sha256()
        for t in outs:
            h.update(t.cpu().contiguous().numpy().tobytes())
        return h.hexdigest()[:16]

    times, digests = {}, {}
    for name, raw in corpora.items():
        cb = ChunkBatch.from_bytes(raw.tobytes(), CHUNK)
        d, s = cb.data, cb.sizes
        dc = match.candidates2(d, s, window=de.WINDOW)
        gc = match.candidates2(d, s)
        dtab = de.dyn_tables(*de.hist_kernel(d, s, dc))
        gtab = ge.dyn_tables_gd(*ge.hist_kernel(d, s, gc))[0]
        zc = match.candidates2(d, s, window=ze.MAX_CAP)
        comp, csz, _ = snappy_encode2.compress_batch(
            d, s, fsnappy.max_compressed_chunk_size(CHUNK))
        calls = {"deflate_hist_algo1": lambda: de.hist_kernel(d, s, dc),
                 "deflate_hist_algo2": lambda: de.hist_kernel(d, s, None),
                 "gdeflate_hist_algo1": lambda: ge.hist_kernel(d, s, gc),
                 "gdeflate_hist_algo2": lambda: ge.hist_kernel(d, s, None),
                 "deflate_emit_algo1": lambda: de.emit_kernel(d, s, dc, *dtab, dcap),
                 "gdeflate_emit_algo1": lambda: ge.emit_kernel(d, s, gc, gtab),
                 "zstd_hist": lambda: ze.hist_kernel(d, s, zc),
                 "snappy_decode": lambda: snappy_decode.decompress_batch(comp, csz, CHUNK)}
        for what, fn in calls.items():
            ms = time_ms(fn)
            times[f"{name} {what}"] = {"median": statistics.median(ms), "min": min(ms),
                                       "max": max(ms)}
            digests[f"{name} {what}"] = digest(fn())
    return {"tree": str(tree), "device": torch.cuda.get_device_name(0),
            "nvidia_smi": smi.strip(), "rounds": rounds, "iters": iters,
            "ms": times, "digest": digests}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("change", type=Path)
    ap.add_argument("--order", default="PCCP")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.one:
        print(json.dumps(_one(a.parent.resolve(), a.rounds, a.iters)))
        return 0
    trees = {"P": a.parent.resolve(), "C": a.change.resolve()}
    runs = []
    for letter in a.order:
        tree = trees[letter]
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), str(tree), str(tree),
                               "--one", "--rounds", str(a.rounds), "--iters", str(a.iters)],
                              cwd=tree, capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            print(f"ab_time: the {letter} process failed (exit {proc.returncode})", file=sys.stderr)
            return 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        res["as"] = letter
        print(json.dumps(res))
        runs.append(res)
    print(f"[ab] {runs[0]['device']}, {runs[0]['nvidia_smi']}; median ms of {a.rounds} rounds "
          f"of {a.iters} calls, in the order {a.order}:")
    for key in runs[0]["ms"]:
        print(f"[ab] {key}: " + " / ".join(f"{r['as']} {r['ms'][key]['median']:.3f}"
                                           for r in runs))
    same = all(r["digest"] == runs[0]["digest"] for r in runs)
    print(f"[ab] outputs equal across the runs: {same}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
