"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers) and is
compiled by ``nvcc`` for Hopper (``sm_90a``) into its own shared library under
``build/tpucomp_torch/<hash of the sources and flags>/`` at the root of the
checkout.  All sources build in parallel, one ``nvcc`` each; a library already
built for the same hash is reused.  A missing ``nvcc`` or a failed build
raises: there is no other way to the kernels.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
KERNELS = ("lz4_decode", "lz4_encode", "snappy_decode", "snappy_encode",
           "deflate_decode", "deflate_encode", "zstd_decode", "zstd_passes", "zstd_encode",
           "gdeflate_vdecode", "gdeflate_encode", "ans_decode", "ans_encode",
           "cascaded_expand", "hash_encode", "gdeflate_decode", "probe")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return CSRC.parents[3] / "build" / "tpucomp_torch" / h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin); "
                       "the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    return build_dir() / f"lib{name}.so"


def build_all() -> dict[str, float]:
    """Build every kernel library that is not built yet, all ``nvcc`` runs at
    once.  Returns the seconds each build took (0.0 for a library reused);
    the compiler's ``-Xptxas -v`` report lands in ``<name>.log`` beside it."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    todo = [n for n in KERNELS if not _lib_path(n).exists()]
    seconds = {n: 0.0 for n in KERNELS}
    if not todo:
        return seconds
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        (out_dir / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _lib_path(name))   # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return seconds


def ptxas_report(name: str) -> list[str]:
    """The register / shared-memory lines ``-Xptxas -v`` printed for ``name``."""
    log = build_dir() / f"{name}.log"
    if not log.exists():
        return []
    return [ln.strip() for ln in log.read_text().splitlines()
            if "registers" in ln or "bytes stack frame" in ln or "smem" in ln]


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library for kernel ``name`` (building it first if needed)."""
    if not _lib_path(name).exists():
        build_all()
    return ctypes.CDLL(str(_lib_path(name)))
