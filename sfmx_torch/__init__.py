"""sfmx_torch — the PyTorch/CUDA port of sfmx for NVIDIA Hopper (H100).

The package mirrors ``sfmx``'s sub-packages and module names so that each
counterpart is easy to find:

- ``sfmx_torch.core``     — SE(3)/SO(3), camera models, masking utilities
- ``sfmx_torch.kernels``  — extraction (AKAZE-analog, upright or oriented;
  SIFT), matching helpers, the dense bundle-adjustment layout and the hand-written CUDA
  kernels K1-K10 with their plain PyTorch versions
- ``sfmx_torch.solvers``  — small linear algebra, PnP (DLT, P3P), batched
  RANSAC, epipolar geometry, triangulation, the Schur complement and LM
  bundle adjustment, similarity alignment
- ``sfmx_torch.recon``    — track building and incremental reconstruction
- ``sfmx_torch.mapstore`` — the ``.npy``-column stores ``sfmx`` reads and writes
- ``sfmx_torch.localize`` — VLAD retrieval, gather and streaming query
  localization, beacon fusion, sequential tracking
- ``sfmx_torch.serve``    — the micro-batching localization service + HTTP API
- ``sfmx_torch.cli``      — config tree, image ingest, extraction dispatch
  (eager and streaming), the map build, batch and sequential localize, map
  loading, serve, evaluation, PLY export and the argparse command line
  (``python -m sfmx_torch.cli.main``)
- ``sfmx_torch.utils``    — stage logging, debug mode (NaN trap)
- ``sfmx_torch.demo``     — the end-to-end demo (``python -m sfmx_torch.demo``)

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
