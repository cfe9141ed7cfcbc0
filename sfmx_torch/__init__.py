"""sfmx_torch — the PyTorch/CUDA port of sfmx for NVIDIA Hopper (H100).

The package mirrors ``sfmx``'s sub-packages and module names so that each
counterpart is easy to find:

- ``sfmx_torch.core``     — SE(3)/SO(3), camera models, masking utilities
- ``sfmx_torch.kernels``  — extraction (AKAZE-analog, upright), matching
  helpers and the hand-written CUDA kernels K1-K4 with their plain
  PyTorch versions
- ``sfmx_torch.solvers``  — small linear algebra, PnP (DLT, P3P), batched RANSAC
- ``sfmx_torch.mapstore`` — the ``.npy``-column stores ``sfmx`` writes
- ``sfmx_torch.localize`` — VLAD retrieval, gather and streaming query
  localization, beacon fusion, sequential tracking
- ``sfmx_torch.serve``    — the micro-batching localization service + HTTP API
- ``sfmx_torch.cli``      — config tree, extraction dispatch, batch and
  sequential localize, map loading, serve

It imports ``torch`` and never ``jax`` or ``sfmx``.  Device placement is
explicit: every function works on the device of its inputs (or the
``device`` it is given), and a kernel wrapper runs its plain version only
for CPU tensors — for a CUDA tensor it launches the kernel or raises.
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry is precision-critical (the counterpart of sfmx's
# jax_default_matmul_precision="highest").  cuDNN's TF32 flag defaults to
# True and would run the Gaussian-blur convolutions in TF32.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
