"""The lowering probes as Hopper kernels, with their plain versions.

Port of :mod:`tpucomp.ops.pallas._probe` (row 27 of ``PERF.md``'s table):
eleven tiny kernels, each testing one dynamic-indexing or memory-space form
(``csrc/probe.cu``; its header says how each TPU form maps to the card and
how the undefined cases are settled).  They lie on no data path and run from
their own entry point:

    python -m tpucomp_torch.ops.cuda._probe          # the kernels, on the card
    python -m tpucomp_torch.ops.cuda._probe --cpu    # the plain versions

which prints ``PROBE <name>: OK <first four values>`` for each, as the
reference's ``_run`` does, and unlike it exits non-zero if any probe fails.

Each ``pK`` takes tensors shaped as the reference's (``int32`` scalars as
``(1,)`` tensors) and launches its kernel for CUDA tensors; for CPU tensors
it runs ``pK_plain``, the same function in torch ops.  An output element the
probe does not write holds ``INT32_MIN``, the value the reference's
interpret mode gives it, so whole outputs compare exactly.
"""
from __future__ import annotations

import ctypes
import functools
import sys

import torch

from tpucomp_torch.ops.cuda import _build

UNWRITTEN = -2**31


def _index(i: int, n: int) -> int:
    """JAX's dynamic index: negative counts from the end, then clamped."""
    i = i + n if i < 0 else i
    return min(max(i, 0), n - 1)


def _start(s: int, length: int, n: int) -> int:
    """JAX's dynamic slice start: negative counts from the end, then clamped."""
    s = s + n if s < 0 else s
    return min(max(s, 0), n - length)


def _filled(shape, like: torch.Tensor) -> torch.Tensor:
    return torch.full(shape, UNWRITTEN, dtype=torch.int32, device=like.device)


def p1_plain(x, idx):
    """``o[0] = x[0, idx]``, x int32 (1, 512)."""
    return x[0, _index(int(idx[0]), 512)].reshape(1).clone()


def p2_plain(x, shift):
    """``x`` (8, 128) rotated along lanes by ``shift`` (``jnp.roll``'s direction)."""
    return torch.roll(x, int(shift[0]), 1)


def p3_plain(x, idx):
    """As :func:`p1_plain`, read from the row staged into shared memory."""
    return p1_plain(x, idx)


def p4_plain(x, r):
    """Rows ``[r, r + 2)`` of ``x`` (16, 128) plus one; other rows unwritten."""
    out = _filled((16, 128), x)
    s = _start(int(r[0]), 2, 16)
    out[s:s + 2] = x[s:s + 2] + 1
    return out


def p5_plain(x, off):
    """Row 0 of ``x`` (8, 128) where lane ``>= off`` -> (1, 128)."""
    out = _filled((1, 128), x)
    lanes = torch.arange(128, device=x.device) >= int(off[0])
    out[0, lanes] = x[0, lanes]
    return out


def p6_plain(x, n):
    """``sum(x[0, :n])`` of x (1, 512); reads past the row clamp to its end."""
    idx = torch.arange(max(int(n[0]), 0), device=x.device).clamp(max=511)
    return x[0, idx].sum(dtype=torch.int32).reshape(1)


def p7_plain(x, s):
    """``o = x``, then rows ``[0, 2)`` copied onto rows ``[s, s + 2)`` of o."""
    out = x.clone()
    st = _start(int(s[0]), 2, 16)
    out[st:st + 2] = x[0:2]
    return out


def p8_plain(x):
    """``int32(x) * 2`` of x uint8 (8, 128)."""
    return x.to(torch.int32) * 2


def p9_plain(x, n):
    """Lanes ``i < n`` of a (1, 128) scratch set to ``3 * i`` (writes past
    the row clamp to its last lane); the rest unwritten.  ``x`` is unused."""
    out = _filled((1, 128), x)
    for i in range(max(int(n[0]), 0)):
        out[0, min(i, 127)] = 3 * i
    return out


def p10_plain(x, idx):
    """``o[0] = x[0, idx]`` of x int32 (1, 16384), staged into 64 KiB."""
    return x[0, _index(int(idx[0]), 16384)].reshape(1).clone()


def p11_plain(x, idx):
    """As :func:`p10_plain`, with x as a scalar input block."""
    return p10_plain(x, idx)


# name -> (input shapes and types; output shape)
_SPECS = {
    "p1": (((1, 512), torch.int32), (1,)),
    "p2": (((8, 128), torch.int32), (8, 128)),
    "p3": (((1, 512), torch.int32), (1,)),
    "p4": (((16, 128), torch.int32), (16, 128)),
    "p5": (((8, 128), torch.int32), (1, 128)),
    "p6": (((1, 512), torch.int32), (1,)),
    "p7": (((16, 128), torch.int32), (16, 128)),
    "p8": (((8, 128), torch.uint8), (8, 128)),
    "p9": (((1, 512), torch.int32), (1, 128)),
    "p10": (((1, 16384), torch.int32), (1,)),
    "p11": (((1, 16384), torch.int32), (1,)),
}


@functools.cache
def _entry(name: str):
    """``tpucomp_probe_<name>`` with its argument and result types, resolved
    once a process."""
    fn = getattr(_build.load("probe"), f"tpucomp_probe_{name}")
    fn.argtypes = [ctypes.c_void_p] * (_N_POINTERS[name] + 1)
    fn.restype = ctypes.c_int
    return fn


# pointers each entry takes before the stream: x (not p9), the scalar (not p8), out
_N_POINTERS = {name: 3 for name in _SPECS} | {"p8": 2, "p9": 2}


def _launch(name: str, x: torch.Tensor, scalar: torch.Tensor | None) -> torch.Tensor:
    """Check the inputs, allocate the output (the kernel writes every element
    of it, ``INT32_MIN`` where the probe leaves one unwritten) and launch
    ``tpucomp_probe_<name>`` on the current stream: one launch a call."""
    (shape, dtype), out_shape = _SPECS[name]
    if x.dtype != dtype or x.shape != shape:
        raise ValueError(f"{name}: x must be {dtype}{list(shape)}, got {x.dtype}{list(x.shape)}")
    if not x.is_contiguous():
        x = x.contiguous()
    if x.data_ptr() % 16:            # cp.async moves 16-byte pieces
        x = x.clone()
    index = x.get_device()
    ptrs = () if name == "p9" else (x.data_ptr(),)   # p9 does not read x
    if scalar is not None:
        if scalar.dtype != torch.int32 or scalar.numel() != 1 or scalar.get_device() != index:
            raise ValueError(f"{name}: the scalar must be int32 (1,) on {x.device}")
        ptrs += (scalar.data_ptr(),)     # one element: contiguous whatever its strides
    out = torch.empty(out_shape, dtype=torch.int32, device=x.device)
    if index == torch.cuda.current_device():
        rc = _entry(name)(*ptrs, out.data_ptr(), torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            rc = _entry(name)(*ptrs, out.data_ptr(), torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"probe {name} kernel launch failed: cudaError {rc}")
    return out


def _wrapper(name: str, plain, has_scalar: bool = True):
    def run(x: torch.Tensor, *scalar: torch.Tensor) -> torch.Tensor:
        if not x.is_cuda:
            return plain(x, *scalar)
        out = _launch(name, x, scalar[0] if has_scalar else None)
        run.launches += 1
        return out
    run.__name__ = name
    run.__qualname__ = name
    run.__doc__ = (f"Probe {name[1:]} on the card (``csrc/probe.cu``), or "
                   f":func:`{name}_plain` for CPU tensors.")
    run.launches = 0
    return run


p1 = _wrapper("p1", p1_plain)
p2 = _wrapper("p2", p2_plain)
p3 = _wrapper("p3", p3_plain)
p4 = _wrapper("p4", p4_plain)
p5 = _wrapper("p5", p5_plain)
p6 = _wrapper("p6", p6_plain)
p7 = _wrapper("p7", p7_plain)
p8 = _wrapper("p8", p8_plain, has_scalar=False)
p9 = _wrapper("p9", p9_plain)
p10 = _wrapper("p10", p10_plain)
p11 = _wrapper("p11", p11_plain)
PROBES = {"p1": p1, "p2": p2, "p3": p3, "p4": p4, "p5": p5, "p6": p6, "p7": p7, "p8": p8,
          "p9": p9, "p10": p10, "p11": p11}
PLAIN = {"p1": p1_plain, "p2": p2_plain, "p3": p3_plain, "p4": p4_plain, "p5": p5_plain,
         "p6": p6_plain, "p7": p7_plain, "p8": p8_plain, "p9": p9_plain, "p10": p10_plain,
         "p11": p11_plain}


# The inputs every check of the kernels and plain versions runs on: the
# reference's (``_probe.py:198-216, 252-257``) plus two more scalars each
# (out of range, negative or overlapping; p7 also at s = 1, where the copy
# reads its source rows before writing them), and for p8 a second, random
# block.  name -> (input block, scalars); None: no scalar.
CHECK_CASES = {
    "p1": ("x1", (37, 600, -1)),
    "p2": ("x2d", (37, 200, -3)),
    "p3": ("x1", (37, 600, -1)),
    "p4": ("x16", (5, 15, -1)),
    "p5": ("x2d", (37, 0, 200)),
    "p6": ("x1", (100, 600, 0)),
    "p7": ("x16", (8, 1, 15, -1)),
    "p8": ("xu8", None),
    "p9": ("x1", (128, 5, 200)),
    "p10": ("xl", (12345, 20000, -1)),
    "p11": ("xl", (12345, 20000, -1)),
}


def check_blocks() -> dict:
    """The input blocks of :data:`CHECK_CASES`, CPU tensors."""
    rand = torch.randint(0, 256, (8, 128), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(27))
    return {"x2d": torch.arange(8 * 128, dtype=torch.int32).reshape(8, 128),
            "x16": torch.arange(16 * 128, dtype=torch.int32).reshape(16, 128),
            "x1": torch.arange(512, dtype=torch.int32).reshape(1, 512),
            "xu8": (torch.arange(8 * 128) % 251).to(torch.uint8).reshape(8, 128),
            "xu8r": rand,
            "xl": torch.arange(16384, dtype=torch.int32).reshape(1, 16384)}


def check_calls() -> list:
    """Every ``(name, block name, scalar or None)`` of :data:`CHECK_CASES`."""
    out = []
    for name, (xk, scalars) in CHECK_CASES.items():
        if scalars is None:
            out += [(name, xk, None), (name, "xu8r", None)]
        else:
            out += [(name, xk, v) for v in scalars]
    return out


def check_args(xk: str, v, blocks: dict, device="cpu") -> tuple:
    """The arguments of one call of :func:`check_calls` on ``device``."""
    x = blocks[xk].to(device)
    return (x,) if v is None else (x, torch.tensor([v], dtype=torch.int32, device=device))


def _run(name: str, fn, *args) -> bool:
    """Run one probe and print its line, as the reference's ``_run``."""
    try:
        out = fn(*args)
        if out.device.type == "cuda":
            torch.cuda.synchronize()
        print(f"PROBE {name}: OK {out.cpu().numpy().reshape(-1)[:4]}")
        return True
    except Exception as e:  # noqa: BLE001  (the message; the exit code reports it)
        msg = str(e).replace("\n", " | ")[:300]
        print(f"PROBE {name}: FAIL {type(e).__name__}: {msg}")
        return False


def _device() -> torch.device:
    if "--cpu" in sys.argv:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: run with --cpu for the plain versions")
    return torch.device("cuda", 0)


def main() -> bool:
    """Probes 1-9 on the reference's inputs (``_probe.py:198-216``)."""
    dev = _device()
    print("devices:", torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev)
    x2d = torch.arange(8 * 128, dtype=torch.int32, device=dev).reshape(8, 128)
    x16 = torch.arange(16 * 128, dtype=torch.int32, device=dev).reshape(16, 128)
    x1 = torch.arange(512, dtype=torch.int32, device=dev).reshape(1, 512)
    xu8 = (torch.arange(8 * 128, device=dev) % 251).to(torch.uint8).reshape(8, 128)

    def s(v):
        return torch.tensor([v], dtype=torch.int32, device=dev)

    i = s(37)
    return all([
        _run("1-dyn-lane-scalar-read-vmem", p1, x1, i),
        _run("2-dynamic-roll", p2, x2d, i),
        _run("3-dma-vmem-to-smem+dyn-read", p3, x1, i),
        _run("4-dyn-sublane-slice", p4, x16, s(5)),
        _run("5-masked-store", p5, x2d, i),
        _run("6-while-scalar-smem", p6, x1, s(100)),
        _run("7-same-buffer-dma", p7, x16, s(8)),
        _run("8-uint8-vmem", p8, xu8),
        _run("9-scalar-smem-write+dma-out", p9, x1, s(128)),
    ])


def main2() -> bool:
    """Probes 10-11 on the reference's inputs (``_probe.py:252-257``)."""
    dev = _device()
    xl = torch.arange(16384, dtype=torch.int32, device=dev).reshape(1, 16384)
    i = torch.tensor([12345], dtype=torch.int32, device=dev)
    return all([_run("10-large-smem-dma", p10, xl, i),
                _run("11-smem-input-block", p11, xl, i)])


if __name__ == "__main__":
    ok = main()
    ok = main2() and ok
    sys.exit(0 if ok else 1)
