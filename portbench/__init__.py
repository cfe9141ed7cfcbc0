"""portbench: the benchmark of the PyTorch and CUDA port (``sfmx_torch``).

``run.py`` is its command; ``BENCHMARK.json`` at the checkout's root names
its cells.  Nothing here imports ``jax`` or ``sfmx``.
"""
