#!/usr/bin/env python3
"""Where K2 response_levels spends its device time: the kernel as it is
beside a variant built from the same source whose blocks only load their tile
with its halo and store its centre (no Scharr pass), and the whole kernel on
one level for each aperture.  The difference of the first two is what the
two passes cost; the variant alone is the kernel's load + store floor, to be
held against the byte bound.

    python3 chip_experiments/k2_passes.py

Needs a CUDA card and ``nvcc``; builds into ``sfmx_torch/_build``.  Device ms
by torch.profiler (10 calls) on a random (32, 5, 480, 640) stack, with the
card's name and power limit.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_experiments.compare_trees import device_ms  # noqa: E402

STORE_ONLY = '''  for (int ty = warp; ty < TH && ty0 + ty < H; ty += nwarps)
    for (int tx = lane; tx < TW && tx0 + tx < W; tx += 32)
      out[(size_t)ty * W + tx] = Lp[(ty + 2 * d) * LW + tx + 2 * d];
  (void)Gx; (void)Gy; (void)rows_in; (void)cols_in;
'''


def load_store_variant(src: str) -> str:
    """The source with the kernel's switch over the apertures (the two passes)
    replaced by a plain store of the loaded tile's centre."""
    a = src.index("  switch (d) {\n    case 1: response_passes<1>")
    b = src.index("  }\n}\n", a) + len("  }\n")
    return src[:a] + STORE_ONLY + src[b:]


def main() -> int:
    import torch

    import sfmx_torch  # noqa: F401
    from sfmx_torch.kernels import _build
    from sfmx_torch.kernels import scale_space as ss

    if not torch.cuda.is_available():
        raise RuntimeError("k2_passes needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    src = (_build.CSRC / "scale_space.cu").read_text()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = {}
    for name, text in (("whole kernel", src), ("load + store only", load_store_variant(src))):
        cu = _build.BUILD_DIR / f"k2_passes_{len(libs)}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the variant '{name}':\n{proc.stderr}")
        libs[name] = ctypes.CDLL(str(so))

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    cfg = (2, 3, 4, 5, 6)
    levels = torch.rand((32, 5, 480, 640), generator=g).to(dev)
    tile = (ss.RESP_TILE_H, ss.RESP_TILE_W, ss.RESP_THREADS)
    for rnd in range(2):
        for name, lib in libs.items():
            _build._LOADED[ss.LIB] = lib
            ms = device_ms(lambda: ss._response_fused(levels, cfg, *tile))
            print(f"[k2_passes] round {rnd} {name}: device {ms:.3f} ms at tile {tile[0]}x{tile[1]}, "
                  f"{tile[2]} threads; on {smi}", flush=True)
    _build._LOADED[ss.LIB] = libs["whole kernel"]
    one = levels[:, :1].contiguous()
    for d in (2, 3, 4, 5, 6):
        ms = device_ms(lambda: ss._response_fused(one, (d,), *tile))
        print(f"[k2_passes] whole kernel, one level of aperture {d}: device {ms:.3f} ms; on {smi}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
