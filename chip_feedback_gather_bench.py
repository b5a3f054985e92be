#!/usr/bin/env python3
"""Time K3's scatter-back backward (``wisp_tpu_torch/csrc/compaction.cu``
``wisp_scatter_back_bwd_many``) in variants of its design, and K5 with its cell lookup
(``csrc/scatter_max.cu``) beside the earlier kernel keyed by ready ids, on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_feedback_gather_bench.py``. It builds the
variants below with the kernel library's ``nvcc`` and flags into
``wisp_tpu_torch/csrc/_build/feedback_gather_bench/`` (a library of their own) and the
earlier designs (``csrc/baselines/scatter_back_bwd_v1.cu``, ``scatter_max_v1.cu``). The
gather of colour [P, 3] and flat density [P] cotangents at K sorted slots:

- "lanes" (the library's: 4 lanes a slot, lane j moves column j of the concatenated rows,
  so a warp's loads and stores each cover 8 consecutive slots' rows);
- "lanes, fixed" (the same with colour and density fixed in the source: lane j < 3 colour
  column j, lane 3 the density, no table);
- "slot" (the redesign's first build: one thread a slot loads its index, then every row
  into registers, then stores them);
- "staged" (one thread a slot as "slot", the block's colour rows written through shared
  memory as 768 consecutive floats);
- "v1 kernels" (the earlier design's two launches, colour, then density as [P, 1], without
  the select backward's fill and copy that fed it on the path).

K5: ``scatter_max_points`` into a held grid (its kernel alone) beside the earlier kernel
given ready ids (``cell_ids`` computed once, outside the timing) into a held grid.

The shapes, seeded: flagship train step 25 (4,096 rays x 512 steps, ~125,000 kept slots)
and a seg segment (2,048 rays x 128 steps, ~27,660 kept), the slots made by the library's
``compact`` from a march-like mask (``chip_compaction_bench.march_mask``), so that they are
sorted step-major as on the path. Each result is held to the plain version bit for bit,
then timed (``chip_smoke.timed``: device ms by torch.profiler, CUDA-event ms), the variants
in turns, two rounds. It prints one JSON line of the build's registers, one a shape and
round, then the card's name and power limit. It fails without a card. Nothing in the
package calls it.
"""

from __future__ import annotations

import ctypes
import functools
import json
import subprocess
import sys

sys.path.insert(0, ".")        # the checkout this is run from

import torch

import chip_smoke as cs
from chip_compaction_bench import march_mask
from wisp_tpu_torch import kernels
from wisp_tpu_torch.ops.compaction import (compact, scatter_back_bwd_many,
                                           scatter_back_bwd_many_plain)
from wisp_tpu_torch.ops.density_grid import cell_ids, scatter_max_points, scatter_max_plain

VARIANTS = r'''
#include "common.cuh"

namespace {

__global__ void gather_lanes_kernel(const float* __restrict__ gc, const float* __restrict__ gd,
                                    const long long* __restrict__ idx, long long K,
                                    long long P, float* __restrict__ oc,
                                    float* __restrict__ od) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long k = t >> 2;
  const int j = (int)(t & 3);
  if (k >= K) return;
  const long long q = idx[k];
  const bool live = q >= 0 && q < P;
  if (j < 3) {
    oc[k * 3 + j] = live ? gc[q * 3 + j] : 0.0f;
  } else {
    od[k] = live ? gd[q] : 0.0f;
  }
}

__global__ void gather_slot_kernel(const float* __restrict__ gc, const float* __restrict__ gd,
                                   const long long* __restrict__ idx, long long K,
                                   long long P, float* __restrict__ oc,
                                   float* __restrict__ od) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const long long q = idx[k];
  const bool live = q >= 0 && q < P;
  const float c0 = live ? gc[q * 3] : 0.0f, c1 = live ? gc[q * 3 + 1] : 0.0f;
  const float c2 = live ? gc[q * 3 + 2] : 0.0f, d = live ? gd[q] : 0.0f;
  oc[k * 3] = c0;
  oc[k * 3 + 1] = c1;
  oc[k * 3 + 2] = c2;
  od[k] = d;
}

__global__ void gather_staged_kernel(const float* __restrict__ gc,
                                     const float* __restrict__ gd,
                                     const long long* __restrict__ idx, long long K,
                                     long long P, float* __restrict__ oc,
                                     float* __restrict__ od) {
  __shared__ float rows[256 * 3];
  const long long k0 = (long long)blockIdx.x * 256;
  const long long k = k0 + threadIdx.x;
  float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, d = 0.0f;
  if (k < K) {
    const long long q = idx[k];
    if (q >= 0 && q < P) {
      c0 = gc[q * 3];
      c1 = gc[q * 3 + 1];
      c2 = gc[q * 3 + 2];
      d = gd[q];
    }
    od[k] = d;
  }
  rows[threadIdx.x * 3] = c0;
  rows[threadIdx.x * 3 + 1] = c1;
  rows[threadIdx.x * 3 + 2] = c2;
  __syncthreads();
  const long long n = (K - k0 < 256 ? K - k0 : 256) * 3;
  for (int i = threadIdx.x; i < n; i += 256) oc[k0 * 3 + i] = rows[i];
}

}  // namespace

WISP_EXPORT int bench_gather(int variant, const float* gc, const float* gd,
                             const long long* idx, long long K, long long P, float* oc,
                             float* od, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (K > 0) {
    if (variant == 0)
      gather_lanes_kernel<<<wisp::ceil_div(4 * K, 256), 256, 0, st>>>(gc, gd, idx, K, P, oc,
                                                                       od);
    else if (variant == 1)
      gather_slot_kernel<<<wisp::ceil_div(K, 256), 256, 0, st>>>(gc, gd, idx, K, P, oc, od);
    else
      gather_staged_kernel<<<wisp::ceil_div(K, 256), 256, 0, st>>>(gc, gd, idx, K, P, oc, od);
  }
  return (int)cudaGetLastError();
}
'''


def build() -> tuple:
    """The variants' library and the two earlier designs' (loaded), and the variants'
    ptxas lines."""
    out_dir = kernels.BUILD_ROOT / "feedback_gather_bench"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "variants.cu"
    src.write_text(VARIANTS)
    lib_path = out_dir / "libvariants.so"
    run = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
                          "-I", str(kernels.CSRC), str(src), "-o", str(lib_path)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    cs.require(run.returncode == 0, f"nvcc failed for the variants:\n{run.stdout}")
    ptxas = [ln.strip() for ln in run.stdout.splitlines() if "registers" in ln]
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib = ctypes.CDLL(str(lib_path))
    lib.bench_gather.argtypes = [I, P, P, P, L, L, P, P, P]
    bwd_v1 = cs.finish_baseline_build(
        cs.start_baseline_build(cs.SCATTER_BACK_BWD_V1_SRC, "libwisp_scatter_back_bwd_v1.so"),
        cs.SCATTER_BACK_BWD_V1_SRC)
    bwd_v1.wisp_scatter_back_bwd_v1.argtypes = [P, P, L, I, L, P, P]
    max_v1 = cs.finish_baseline_build(
        cs.start_baseline_build(cs.SCATTER_MAX_V1_SRC, "libwisp_scatter_max_v1.so"),
        cs.SCATTER_MAX_V1_SRC)
    max_v1.wisp_scatter_max_v1.argtypes = [P, P, L, L, P, P]
    return lib, bwd_v1, max_v1, ptxas


def stream() -> int:
    return torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())


def shape(gen, dev, r, s, share):
    """Slots of a march-like [r, s] mask compacted step-major (budget r*s/4, as the
    flagship's compaction 0.25), cotangents, points and densities of the kept slots."""
    mask = march_mask(gen, r, s, share, dev)
    samples = (torch.rand((r, s, 3), generator=gen) * 2.0 - 1.0).to(dev)
    dirs = torch.randn((r, 3), generator=gen).to(dev)
    budget = -(-r * s // 4 // 128) * 128
    idx, cflat, _, count = compact(mask, samples, dirs, budget)
    k = min(int(count), budget)
    p = r * s
    grads = [torch.randn((p, 3), generator=gen).to(dev),
             torch.randn((p,), generator=gen).to(dev)]
    dens = (torch.relu(torch.randn((k,), generator=gen)) * 4.0).to(dev)
    return {"rays": r, "steps": s, "slots": k, "idx": idx, "grads": grads,
            "points": cflat[:k], "density": dens}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_feedback_gather_bench: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    kernels.build()
    lib, bwd_v1, max_v1, ptxas = build()
    print(json.dumps({"ptxas": ptxas}), flush=True)
    gen = torch.Generator().manual_seed(18)
    shapes = {"flagship step 25": shape(gen, dev, 4096, 512, 0.0707),
              "seg segment": shape(gen, dev, 2048, 128, 0.13)}
    for rnd in range(2):
        for name, sh in shapes.items():
            idx, grads, k = sh["idx"], sh["grads"], sh["slots"]
            p = grads[0].shape[0]
            want = scatter_back_bwd_many_plain(grads, idx, k)
            gd1 = grads[1].reshape(p, 1).contiguous()
            oc = torch.empty((k, 3), device=dev)
            od = torch.empty((k,), device=dev)
            od1 = torch.empty((k, 1), device=dev)

            def variant(v):
                status = lib.bench_gather(v, grads[0].data_ptr(), grads[1].data_ptr(),
                                          idx.data_ptr(), k, p, oc.data_ptr(), od.data_ptr(),
                                          stream())
                cs.require(status == 0, f"bench_gather {v} failed ({status})")
                return [oc, od]

            def v1():
                for g, o, c in ((grads[0], oc, 3), (gd1, od1, 1)):
                    status = bwd_v1.wisp_scatter_back_bwd_v1(g.data_ptr(), idx.data_ptr(), k,
                                                             c, p, o.data_ptr(), stream())
                    cs.require(status == 0, f"wisp_scatter_back_bwd_v1 failed ({status})")
                return [oc, od1]

            calls = {"lanes": functools.partial(scatter_back_bwd_many, grads, idx, k),
                     "lanes, fixed": functools.partial(variant, 0),
                     "slot": functools.partial(variant, 1),
                     "staged": functools.partial(variant, 2), "v1 kernels": v1}
            row = {"shape": name, "round": rnd, "slots": k, "total": p}
            for label, call in calls.items():
                got = call()
                cs.require(all(a.reshape(-1).equal(b.reshape(-1)) for a, b in zip(got, want)),
                           f"{name}: gather variant {label} differs from the plain version")
                row[f"gather {label}"] = cs.timed(call)

            level, size = 7, 8 ** 7
            pts, dens = sh["points"], sh["density"]
            ids = cell_ids(pts, level)
            held = torch.zeros((size,), device=dev)
            held_v1 = torch.zeros((size,), device=dev)
            want_grid = scatter_max_plain(ids, dens, size)

            def k5_v1():
                status = max_v1.wisp_scatter_max_v1(ids.data_ptr(), dens.data_ptr(), k, size,
                                                    held_v1.data_ptr(), stream())
                cs.require(status == 0, f"wisp_scatter_max_v1 failed ({status})")
                return held_v1

            k5 = functools.partial(scatter_max_points, pts, dens, level, held)
            cs.require(torch.equal(k5(), want_grid) and torch.equal(k5_v1(), want_grid),
                       f"{name}: K5 differs from the plain version")
            row["k5 lookup inside, held grid"] = cs.timed(k5)
            row["k5 v1 kernel on ready ids, held grid"] = cs.timed(k5_v1)
            print(json.dumps(row), flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except cs.SmokeFailure as e:
        print(f"chip_feedback_gather_bench: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
