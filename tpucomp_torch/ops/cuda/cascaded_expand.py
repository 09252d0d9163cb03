"""Cascaded RLE expansion (both passes of a chunk) as a Hopper kernel, with
its plain version.

Port of :mod:`tpucomp.ops.pallas.cascaded_expand` (``expand_batch`` /
``_kernel``, row 26 of ``PERF.md``'s table), behind the fast decoder of
:mod:`tpucomp_torch.ops.cascaded_fast`.  The kernel in
``csrc/cascaded_expand.cu`` (its header says what it replaces, what bounds
it and how it is built) computes the reference's vector form of the same
function, ``cascaded_fast._expand_chunk``, which is defined on every element
of the row; the TPU kernel agrees with it on ``[0, n)`` and leaves the rest
unspecified.  :func:`expand_batch_plain` is that form in torch ops.

Contract: ``vlo, vhi, runs1, runs2 int32[B, cap_el]`` (the values' 32-bit
halves and the two run streams) and ``scalars int32[B, 4]`` = (n, n1, n2,
nr) -> ``(out_lo, out_hi) int32[B, cap_el]``: the values expanded by
``runs2[:n2]`` then by ``runs1[:n1]`` when nr >= 2, by ``runs1[:n1]`` when
nr == 1, copied when nr <= 0.  Run lengths are clipped to ``[0, cap_el]``.
"""
from __future__ import annotations

import ctypes

import torch

from tpucomp_torch.chunk import wrap_i32
from tpucomp_torch.ops.cuda import _build


def _expand_pass(lo: torch.Tensor, hi: torch.Tensor, runs: torch.Tensor,
                 n_runs: torch.Tensor, cap_el: int):
    """Expand each row's ``(lo, hi)[:n_runs]`` by ``runs[:n_runs]``
    (``cascaded_fast.py:605-616``): run starts are an int32 exclusive sum
    (wrapping), scattered with JAX's index rules (a negative start counts
    from the end, one outside the row drops), and every element takes the
    value of the last run starting at or before it."""
    B = lo.shape[0]
    idx = torch.arange(cap_el, device=lo.device)[None, :]
    msk = idx < n_runs.to(torch.int64)[:, None]
    r = torch.where(msk, runs.to(torch.int64).clamp(0, cap_el), 0)
    starts = wrap_i32(torch.cumsum(r, dim=1) - r)
    starts = torch.where(starts < 0, starts + cap_el, starts)
    keep = msk & (starts >= 0) & (starts < cap_el)
    ind = torch.zeros((B, cap_el + 1), dtype=torch.int64, device=lo.device)
    ind.scatter_add_(1, torch.where(keep, starts, cap_el), torch.ones_like(starts))
    ridx = (torch.cumsum(ind[:, :cap_el], dim=1) - 1).clamp(0, cap_el - 1)
    return lo.gather(1, ridx), hi.gather(1, ridx)


def expand_batch_plain(vlo, vhi, runs1, runs2, scalars, cap_el: int):
    """Plain version of :func:`expand_batch` (``cascaded_fast._expand_chunk``),
    on the inputs' device."""
    n1, n2, nr = scalars[:, 1], scalars[:, 2], scalars[:, 3]
    use2, use1 = (nr >= 2)[:, None], (nr >= 1)[:, None]
    l2, h2 = _expand_pass(vlo, vhi, runs2, torch.where(nr >= 2, n2, 0), cap_el)
    lo, hi = torch.where(use2, l2, vlo), torch.where(use2, h2, vhi)
    l1, h1 = _expand_pass(lo, hi, runs1, torch.where(nr >= 1, n1, 0), cap_el)
    return torch.where(use1, l1, lo), torch.where(use1, h1, hi)


def expand_batch(vlo: torch.Tensor, vhi: torch.Tensor, runs1: torch.Tensor,
                 runs2: torch.Tensor, scalars: torch.Tensor, cap_el: int):
    """Row 26: ``csrc/cascaded_expand.cu``, one block per chunk, on the
    inputs' card and current stream.  Raises for tensors that are not on a
    CUDA device."""
    if vlo.device.type != "cuda":
        raise ValueError(f"the cascaded expand kernel needs CUDA tensors, got {vlo.device}")
    B = vlo.shape[0]
    dev = vlo.device
    arrays = []
    for name, x in (("vlo", vlo), ("vhi", vhi), ("runs1", runs1), ("runs2", runs2)):
        if x.dtype != torch.int32 or tuple(x.shape) != (B, cap_el) or x.device != dev:
            raise ValueError(f"{name} must be int32[{B}, {cap_el}] on {dev}, "
                             f"got {x.dtype}{list(x.shape)} on {x.device}")
        arrays.append(x.contiguous())
    if scalars.dtype != torch.int32 or tuple(scalars.shape) != (B, 4) or scalars.device != dev:
        raise ValueError(f"scalars must be int32[{B}, 4] on {dev}")
    scalars = scalars.contiguous()
    olo, ohi, sa, sb = (torch.empty((B, cap_el), dtype=torch.int32, device=dev)
                        for _ in range(4))
    fn = _build.load("cascaded_expand").tpucomp_cascaded_expand
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, i, i, p, p, p, p, p]
    fn.restype = i
    with torch.cuda.device(dev):
        rc = fn(*(a.data_ptr() for a in arrays), scalars.data_ptr(), B, cap_el,
                olo.data_ptr(), ohi.data_ptr(), sa.data_ptr(), sb.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"cascaded_expand kernel launch failed: cudaError {rc}")
    if B and cap_el:                         # the C side launches nothing otherwise
        expand_batch.launches += 1
    return olo, ohi


expand_batch.launches = 0
