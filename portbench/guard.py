"""What the benchmark's process may not load: JAX and the JAX package."""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "sfmx")


def forbidden_loaded(modules=None) -> list[str]:
    """Top-level names of loaded modules that are forbidden, compared whole
    (``sfmx_torch`` is not ``sfmx``)."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(n for n in names if n in FORBIDDEN)
