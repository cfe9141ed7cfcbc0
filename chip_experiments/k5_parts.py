#!/usr/bin/env python3
"""Where K5 match_pairs_fused spends its device time, and what the other
design for the column's best row would cost: the kernel as it is beside
variants built from the same source.

The split: variants that fold every tile into a top-1 in both directions,
into a top-2 in both, or not at all (a thread keeps the maximum of three of
its scores, so the products, the pipeline and the column bias stay and the
fold goes).  The last is the pipeline's floor: the `wgmma` products of the
listed and the swapped pairs, their TMA ring and the per-pair bookkeeping;
the differences are what the folds cost.

Design (a), the column's best row in place of the swapped list: the listed
pairs alone (the swapped list is dropped from the grid), the row top-2 as
built, and per tile a column reduction over the block's 128 rows from the
accumulators (a thread's two rows, the 8 lanes that share a column by
shuffles, the 8 consumer warps through shared memory behind a named
barrier) published by one global ``atomicMax`` per column and block into a
key table that is cleared before each call.  Two versions bracket it:

* value only: the column's maximum score as an ordered 32-bit key, without
  the pass that finds the lowest row attaining it, so a lower bound on any
  exact (a);
* exact keys: (score, lowest row) as a 64-bit key through every round, the
  contract's tie rule, as the old kernel published it.

Neither applies the row image's mask (a constant select a row); their keys
are checked in raw mode (no masks) against the built kernel's j1 and the
column maxima of the bf16 similarity.

    python3 chip_experiments/k5_parts.py

Needs a CUDA card and ``nvcc``; builds into ``sfmx_torch/_build`` (every
variant at once, with ``-Xptxas -v``: the pair kernel's registers and
spills are printed).  Device ms of the pair kernel, its finish and the key
table's clear by torch.profiler (5 calls) at the exhaustive build's shape:
4,560 pairs of 96 images of 1,024 random unit descriptors (D = 128), with
every column valid and with ~10 % of them masked (every tile then carries
its column bias), with the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

FOLD = """  if (top2)
    fold_tile<true>(acc, r.tile * BN + 2 * t, st);
  else
    fold_tile<false>(acc, r.tile * BN + 2 * t, st);"""
KEEP_THREE = "  st.b1[0] = fmaxf(st.b1[0], acc[0] + acc[63]);\n  st.b1[1] = fmaxf(st.b1[1], acc[31]);"
RETIRE = "// The oldest tile's products are done"
ROW_BLOCKS = "  const int row_blocks = (K + BM - 1) / BM;\n  const long long blocks"
EXPORTS = 'extern "C" {\n'

# design (a): the column reduction of one tile, called after its row fold;
# `par` alternates per tile, so one barrier a tile guards the shared buffer
COLUMN = """__device__ KEY* g_colkey;        // (N, K) keys, cleared before each call
KEY* g_colkey_host = nullptr;

__device__ __forceinline__ unsigned ordered(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ void column_tile(const float (&acc)[BN / 2], int orow, int tile,
                                            int par, int row0, int K) {
  __shared__ KEY part[2][CONSUMERS * 4][BN];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  KEY m[BN / 4];
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const KEY x = MAKE(acc[4 * i + e], row0 + g), y = MAKE(acc[4 * i + 2 + e], row0 + g + 8);
      m[2 * i + e] = x > y ? x : y;
    }
  }
#pragma unroll
  for (int off = 4; off <= 16; off <<= 1)
#pragma unroll
    for (int k = 0; k < BN / 4; ++k) {
      const KEY o = __shfl_xor_sync(0xffffffffu, m[k], off);
      m[k] = o > m[k] ? o : m[k];
    }
  if (lane < 4) {
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      part[par][w][8 * i + 2 * t] = m[2 * i];
      part[par][w][8 * i + 2 * t + 1] = m[2 * i + 1];
    }
  }
  asm volatile("bar.sync 1, 256;\\n" ::: "memory");
  if (threadIdx.x < BN) {
    KEY v = part[par][0][threadIdx.x];
#pragma unroll
    for (int q = 1; q < CONSUMERS * 4; ++q) {
      const KEY o = part[par][q][threadIdx.x];
      v = o > v ? o : v;
    }
    const int col = tile * BN + threadIdx.x;
    if (col < K) atomicMax(g_colkey + (size_t)orow * K + col, v);
  }
}

"""
KEYS = {"value only": ("unsigned", "#define MAKE(v, r) ordered(v)\n"),
        "exact keys": ("unsigned long long",
                       "#define MAKE(v, r) ((static_cast<unsigned long long>(ordered(v)) << 32) "
                       "| (0xffffffffu - static_cast<unsigned>(r)))\n")}


def design_a(src: str, key: str) -> str:
    ctype, make = KEYS[key]
    src = src.replace(RETIRE, f"#define KEY {ctype}\n{make}{COLUMN}{RETIRE}")
    src = src.replace(FOLD, "  fold_tile<true>(acc, r.tile * BN + 2 * t, st);\n"
                            "  column_tile(acc, dir.out_row[first + r.pair], r.tile,\n"
                            "              (r.pair * ntiles + r.tile) & 1, row0, K);")
    src = src.replace(ROW_BLOCKS, "  if (g_colkey_host != nullptr)\n"
                                  "    cudaMemsetAsync(g_colkey_host, 0, (size_t)n_pairs0 * K * "
                                  "sizeof(KEY), static_cast<cudaStream_t>(stream));\n"
                                  "  n_groups1 = 0;     // design (a): no swapped list\n" + ROW_BLOCKS)
    return src.replace(EXPORTS, EXPORTS + "void k5_set_keys(void* p) {\n"
                       "  g_colkey_host = static_cast<KEY*>(p);\n"
                       "  cudaMemcpyToSymbol(g_colkey, &g_colkey_host, sizeof(KEY*));\n}\n\n")


def variants(src: str) -> dict[str, str]:
    for part in (FOLD, RETIRE, ROW_BLOCKS, EXPORTS):
        if src.count(part) != 1:
            raise RuntimeError("match_pairs.cu no longer holds the text this script replaces: "
                               + part.splitlines()[0])
    return {"as built (b: top-2 listed, top-1 swapped)": src,
            "top-1 both ways": src.replace(FOLD, "  fold_tile<false>(acc, r.tile * BN + 2 * t, st);"),
            "top-2 both ways": src.replace(FOLD, "  fold_tile<true>(acc, r.tile * BN + 2 * t, st);"),
            "no fold (pipeline floor)": src.replace(FOLD, KEEP_THREE),
            "(a) value only": design_a(src, "value only"),
            "(a) exact keys": design_a(src, "exact keys")}


def build(texts: dict[str, str]) -> dict[str, ctypes.CDLL]:
    """Every variant compiled at once, one nvcc each; the pair kernel's
    ptxas line printed."""
    from sfmx_torch.kernels import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(texts.items()):
        cu = _build.BUILD_DIR / f"k5_parts_{i}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        _out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the variant '{name}':\n{err}")
        lines = err.splitlines()
        at = next(i for i, ln in enumerate(lines) if "Compiling entry" in ln and "pairs_kernel" in ln)
        info = " ".join(ln.replace("ptxas info    :", "").strip() for ln in lines[at + 1:at + 4])
        print(f"[k5_parts] {name}: pairs_kernel {info}", flush=True)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def main() -> int:
    import numpy as np
    import torch

    import sfmx_torch  # noqa: F401
    from sfmx_torch.kernels import _build
    from sfmx_torch.kernels import pairs as mp
    from sfmx_torch.kernels.matching import _bf16_sim

    if not torch.cuda.is_available():
        raise RuntimeError("k5_parts needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    from chip_smoke import device_ms_per_run

    def ms_of(fn) -> float:
        _, by_name, _ = device_ms_per_run(fn, 5)
        ours = [t for k, t in by_name.items()
                if re.search("pairs_kernel|finish_kernel|Memset", k)]
        assert ours, f"no match_pairs.cu kernel in the trace: {sorted(by_name)}"
        return sum(ours)

    libs = build(variants((_build.CSRC / "match_pairs.cu").read_text()))
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    x = torch.randn((96, 1024, 128), generator=g)
    d = (x / torch.linalg.vector_norm(x, dim=2, keepdim=True)).to(dev)
    pairs = np.array([(a, b) for a in range(96) for b in range(a + 1, 96)], np.int32)
    N = len(pairs)

    def outs():
        return (torch.empty((N, 1024), dtype=torch.float32, device=dev),
                torch.empty((N, 1024), dtype=torch.int32, device=dev),
                torch.empty((N, 1024), dtype=torch.int32, device=dev))

    keys = {"(a) value only": torch.zeros((N, 1024), dtype=torch.int32, device=dev),
            "(a) exact keys": torch.zeros((N, 1024), dtype=torch.int64, device=dev)}
    for name, buf in keys.items():
        libs[name].k5_set_keys.argtypes = [ctypes.c_void_p]
        libs[name].k5_set_keys(buf.data_ptr())

    # design (a)'s keys in raw mode against the built kernel's j1 (the
    # swapped list) and the bf16 similarity's column maxima
    _build._LOADED[mp.LIB] = libs["as built (b: top-2 listed, top-1 swapped)"]
    ref = outs()
    mp.launch(d, None, pairs, out=ref, name="k5_parts")
    j1 = ref[2].long()
    colmax = torch.cat([_bf16_sim(d[pairs[i:i + 256, 0]], d[pairs[i:i + 256, 1]]).amax(dim=1)
                        for i in range(0, N, 256)])
    for name, buf in keys.items():
        _build._LOADED[mp.LIB] = libs[name]
        mp.launch(d, None, pairs, out=outs(), name="k5_parts")
        torch.cuda.synchronize()
        hi = (buf >> 32) & 0xFFFFFFFF if buf.dtype == torch.int64 else buf.long() & 0xFFFFFFFF
        u = torch.where(hi >= 2 ** 31, hi - 2 ** 31, ~hi & 0xFFFFFFFF)
        val = torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(torch.int32).view(torch.float32)
        err = float((val - colmax).abs().max())
        line = f"[k5_parts] {name} raw mode: column max within {err:.2e} of the bf16 similarity's"
        if buf.dtype == torch.int64:
            row = 0xFFFFFFFF - (buf & 0xFFFFFFFF)
            line += f"; best row != the built j1 at {int((row != j1).sum())} of {j1.numel()} columns"
        print(line, flush=True)

    flop = 2.0 * N * 1024 * 1024 * 128       # one direction's products
    out = (torch.empty((N, 1024), dtype=torch.float32, device=dev),
           torch.empty((N, 1024), dtype=torch.int32, device=dev),
           torch.empty((N, 1024), dtype=torch.bool, device=dev))
    for masked in (False, True):
        m = (torch.rand((96, 1024), generator=g) >= (0.1 if masked else 0.0)).to(dev)
        for rnd in range(2):
            for name, lib in libs.items():
                _build._LOADED[mp.LIB] = lib
                ms = ms_of(lambda: mp.launch(d, m, pairs, out=out, ratio=0.85, name="k5_parts"))
                both = not name.startswith("(a)")
                print(f"[k5_parts] round {rnd} {'~10 % masked' if masked else 'all valid'} {name}: "
                      f"device {ms:.3f} ms ({(2 if both else 1) * flop / ms / 1e9:.1f} TFLOP/s of "
                      f"products, {'both directions' if both else 'the listed pairs'}) for "
                      f"{N} pairs; on {smi}", flush=True)
    _build._LOADED.pop(mp.LIB, None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
