"""Debug mode: NaN trapping (port of ``sfmx.utils.debug``).

The reference traps numerical faults with ``jax_debug_nans`` (a NaN made
inside a jitted computation raises at the op that made it) and wraps
functions with ``checkify`` (NaN, index and division checks).  The port has
one mechanism for both: a ``TorchDispatchMode`` that looks at the floating
outputs of every ATen op and raises :class:`SfmxNumericalError` naming the
first op that produced a NaN.

* ``SFMX_DEBUG=1`` in the environment (read at import of this module) or
  :func:`enable_debug` enters the mode for the whole process;
* :func:`checked` runs one function under it.

What the port checks: NaN in any floating (real or complex) output of an
ATen op on any device, inputs that were already NaN excepted (the op that
made the NaN is the one named).  What it does not: infinities (the
reference's ``float_checks`` flag NaN only), division by zero as such
(``x / 0`` gives inf, or NaN for 0/0, which is caught), and indices out of
range: torch raises on those itself for CPU tensors, and on a CUDA tensor a
device-side assert ends the process instead.  Kernel wrappers launched
through ``ctypes`` are not ATen ops, so their outputs are seen only when an
ATen op reads them.

The check reads each output back to the host, which synchronizes the card
after every op: for debugging only, never for measurement.
"""
from __future__ import annotations

import functools
import os

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


class SfmxNumericalError(RuntimeError):
    """A detected numerical fault (a NaN produced by an op)."""


def _has_nan(x) -> bool:
    return (isinstance(x, torch.Tensor) and (x.is_floating_point() or x.is_complex())
            and x.numel() > 0 and bool(torch.isnan(x).any()))


class NanTrap(TorchDispatchMode):
    """Raise SfmxNumericalError at the first op whose floating output holds
    a NaN that none of its inputs held."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs, _ = tree_flatten(out)
        if any(_has_nan(o) for o in outs):
            ins, _ = tree_flatten((args, kwargs))
            if not any(_has_nan(i) for i in ins):
                raise SfmxNumericalError(f"NaN produced by {func}")
        return out


_GLOBAL: NanTrap | None = None


def enable_debug(nans: bool = True) -> None:
    """Turn op-level NaN trapping on (or off) for every later computation."""
    global _GLOBAL
    if nans and _GLOBAL is None:
        _GLOBAL = NanTrap()
        _GLOBAL.__enter__()
    elif not nans and _GLOBAL is not None:
        _GLOBAL.__exit__(None, None, None)
        _GLOBAL = None


def debug_enabled() -> bool:
    return os.environ.get("SFMX_DEBUG", "") not in ("", "0", "false")


def checked(fn):
    """Run ``fn`` under the NaN trap; raises SfmxNumericalError at the first
    op that makes a NaN.  Calls outside the wrapper run unchecked."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with NanTrap():
            return fn(*args, **kwargs)

    return wrapper


if debug_enabled():  # pragma: no cover - env-dependent
    enable_debug()
