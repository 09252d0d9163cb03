"""The lowering probes in the port against the JAX reference, on the CPU.

Each plain version ``pK_plain`` of :mod:`tpucomp_torch.ops.cuda._probe` is
held against ``tpucomp.ops.pallas._probe.pK`` in interpret mode on whole
outputs, the ``INT32_MIN`` the interpreter gives unwritten elements
included, on the module's ``CHECK_CASES``: the reference's inputs
(``_probe.py:198-216, 252-257``) plus two more scalar values each (out of
range, negative or overlapping; p7 also at ``s = 1``, where the copy reads
its source rows before writing them) and a second uint8 block for p8, the
inputs ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold the kernels
against.  Tolerance: exact equality (int32 values).

The reference calls run once, in the module fixture (some 25 interpret-mode
calls of about 0.5 s each here).
"""
import functools
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucomp.ops.pallas import _probe as ref

from tpucomp_torch.ops.cuda import _probe


@pytest.fixture(scope="module")
def reference():
    blocks = _probe.check_blocks()
    out = {}
    for name, xk, v in _probe.check_calls():
        fn = jax.jit(functools.partial(getattr(ref, name), interpret=True))
        args = [jnp.asarray(a.numpy()) for a in _probe.check_args(xk, v, blocks)]
        out[name, xk, v] = np.asarray(fn(*args))
    return out


@pytest.mark.parametrize("name", list(_probe.CHECK_CASES))
def test_plain_equals_interpret_mode(reference, name):
    blocks = _probe.check_blocks()
    for (n, xk, v), want in reference.items():
        if n != name:
            continue
        args = _probe.check_args(xk, v, blocks)
        got = _probe.PLAIN[name](*args)
        assert got.dtype == torch.int32 and tuple(got.shape) == want.shape, (name, xk, v)
        assert np.array_equal(got.numpy(), want), (name, xk, v, got, want)
        # the wrapper takes the plain version for CPU tensors, launching nothing
        assert torch.equal(_probe.PROBES[name](*args), got)
        assert _probe.PROBES[name].launches == 0


def test_unwritten_elements_read_int32_min(reference):
    """What the reference's interpreter gives the elements a probe does not
    write, which the kernels' wrappers fill in: p4's other rows, p5's lanes
    below ``off``, p9's lanes from ``n`` on."""
    low = -2**31
    assert (np.delete(reference["p4", "x16", 5], [5, 6], axis=0) == low).all()
    assert (reference["p5", "x2d", 37][0, :37] == low).all()
    assert (reference["p9", "x1", 5][0, 5:] == low).all()
    assert reference["p9", "x1", 200][0, 127] == 3 * 199      # writes past the row clamp
    assert list(reference["p7", "x16", 1][:4, 0]) == [0, 0, 128, 384]   # a snapshot copy
    assert reference["p1", "x1", 600][0] == 511


def test_module_imports_and_cli_without_a_card():
    """The module imports with no GPU; its entry point runs the plain versions
    with ``--cpu`` and exits 0, and refuses to run without a card otherwise."""
    run = [sys.executable, "-m", "tpucomp_torch.ops.cuda._probe"]
    cpu = subprocess.run(run + ["--cpu"], capture_output=True, text=True, timeout=120)
    assert cpu.returncode == 0, cpu.stdout + cpu.stderr
    lines = [ln for ln in cpu.stdout.splitlines() if ln.startswith("PROBE ")]
    assert len(lines) == 11 and all(": OK " in ln for ln in lines)
    assert "PROBE 2-dynamic-roll: OK [91 92 93 94]" in lines
    if not torch.cuda.is_available():
        card = subprocess.run(run, capture_output=True, text=True, timeout=120)
        assert card.returncode != 0 and "no CUDA device" in card.stderr
