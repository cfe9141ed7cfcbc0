"""The port's debug mode (``sfmx_torch.utils.debug``), mirroring
tests/test_debug.py: ``checked`` passes a clean function, catches a NaN at
the op that made it, and keeps a real solver entry point NaN-clean; plus
the process-wide trap of ``enable_debug`` and ``SFMX_DEBUG``."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sfmx_torch.utils.debug import SfmxNumericalError, checked, enable_debug


def test_checked_passes_clean_function():
    @checked
    def f(x):
        return torch.sqrt(x) + 1.0

    out = f(torch.tensor([1.0, 4.0]))
    np.testing.assert_allclose(out.numpy(), [2.0, 3.0])


def test_checked_catches_nan():
    @checked
    def f(x):
        return torch.sqrt(x)  # NaN for negative input

    with pytest.raises(SfmxNumericalError, match="sqrt"):
        f(torch.tensor([-1.0]))


def test_checked_solver_entrypoint_clean():
    """A real solver stays NaN-clean under the trap."""
    from sfmx_torch.solvers import triangulate

    X = torch.tensor([1.0, 0.5, 4.0])
    R1, t1 = torch.eye(3), torch.zeros(3)
    R2, t2 = torch.eye(3), torch.tensor([-1.0, 0.0, 0.0])
    x1 = (X / X[2])[:2][None]
    Xc2 = X + t2
    x2 = (Xc2 / Xc2[2])[:2][None]
    f = checked(lambda: triangulate.triangulate_two_view(R1, t1, R2, t2, x1, x2))
    Xt, ok = f()
    assert bool(ok[0])
    np.testing.assert_allclose(Xt[0].numpy(), X.numpy(), atol=1e-4)


def test_nan_inputs_are_not_blamed_on_later_ops():
    """An op that only carries a NaN it was given is not the culprit."""
    x = torch.tensor([float("nan"), 1.0])
    assert torch.isnan(checked(lambda: x * 2.0)()[0])


def test_enable_debug_traps_every_op():
    enable_debug(True)
    try:
        with pytest.raises(SfmxNumericalError, match="log"):
            torch.log(torch.tensor([-1.0]))
    finally:
        enable_debug(False)
    assert torch.isnan(torch.log(torch.tensor([-1.0])))[0]


def test_sfmx_debug_env_enables_the_trap_at_import():
    code = ("import torch, sfmx_torch.utils.debug as d\n"
            "try:\n    torch.log(torch.tensor([-1.0]))\nexcept d.SfmxNumericalError:\n"
            "    print('trapped')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=root, env={**os.environ, "SFMX_DEBUG": "1"}, timeout=120)
    assert out.stdout.strip() == "trapped", out.stderr
