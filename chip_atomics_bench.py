#!/usr/bin/env python3
"""Measure what a float atomic add costs on one NVIDIA GPU: the yardstick of the backward
kernels' designs (K1's and K15's, which end in atomics).

Run from the root of a checkout: ``python3 chip_atomics_bench.py``. It builds the CUDA
program below with the kernel library's ``nvcc`` and flags into
``wisp_tpu_torch/csrc/_build/bench/`` and prints one JSON line a case, then the card's
name and power limit. Each case times 10 launches with CUDA events after one warm-up
(1,056 blocks of 256 threads, 32 adds a thread):

- global adds at random addresses of a 2, 8 or 32 MB table: one float a lane, one float4
  a lane, and five lanes on the five floats of a random 20-byte row (K15's layout at
  F = 5);
- global adds on 128, 1,024 or 8,192 hot addresses (the serialisation of adds to one
  address);
- shared-memory adds at random floats of a 32 KB table, float and int;
- a cooperative kernel that zeroes 10 MB, syncs the grid and adds, beside a 10 MB
  ``cudaMemsetAsync`` (the cost of folding a zero fill into a kernel).

It fails without a card. Nothing in the package calls it.
"""

from __future__ import annotations

import json
import subprocess
import sys

SOURCE = r'''
#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <stdio.h>
namespace cg = cooperative_groups;

__device__ __forceinline__ unsigned mix(unsigned x) {
  x ^= x >> 16; x *= 0x7feb352dU; x ^= x >> 15; x *= 0x846ca68bU; x ^= x >> 16; return x;
}
__global__ void g_scalar(float* t, unsigned mask, int k) {
  unsigned id = blockIdx.x * blockDim.x + threadIdx.x;
  for (int i = 0; i < k; ++i) atomicAdd(t + (mix(id * 131 + i) & mask), 1.0f);
}
__global__ void g_vec4(float* t, unsigned mask, int k) {
  unsigned id = blockIdx.x * blockDim.x + threadIdx.x;
  for (int i = 0; i < k; ++i)
    atomicAdd(reinterpret_cast<float4*>(t) + (mix(id * 131 + i) & (mask >> 2)),
              make_float4(1.0f, 1.0f, 1.0f, 1.0f));
}
__global__ void g_rows5(float* t, unsigned rows, int k) {
  unsigned id = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned pt = id / 5, f = id % 5;
  for (int i = 0; i < k; ++i) atomicAdd(t + (mix(pt * 131 + i) % rows) * 5 + f, 1.0f);
}
__global__ void g_hot(float* t, unsigned hot, int k) {
  unsigned id = blockIdx.x * blockDim.x + threadIdx.x;
  for (int i = 0; i < k; ++i) atomicAdd(t + (mix(id * 131 + i) % hot) * 8, 1.0f);
}
__global__ void s_float(float* out, int k) {
  __shared__ float s[8192];
  for (int i = threadIdx.x; i < 8192; i += blockDim.x) s[i] = 0.0f;
  __syncthreads();
  unsigned id = blockIdx.x * blockDim.x + threadIdx.x;
  for (int i = 0; i < k; ++i) atomicAdd(s + (mix(id * 131 + i) & 8191), 1.0f);
  __syncthreads();
  if (threadIdx.x == 0) out[blockIdx.x] = s[0];
}
__global__ void s_int(int* out, int k) {
  __shared__ int s[8192];
  for (int i = threadIdx.x; i < 8192; i += blockDim.x) s[i] = 0;
  __syncthreads();
  unsigned id = blockIdx.x * blockDim.x + threadIdx.x;
  for (int i = 0; i < k; ++i) atomicAdd(s + (mix(id * 131 + i) & 8191), 1);
  __syncthreads();
  if (threadIdx.x == 0) out[blockIdx.x] = s[0];
}
__global__ void coop(float* t, long long n, int* flag) {
  cg::grid_group g = cg::this_grid();
  for (long long i = g.thread_rank(); i < n; i += g.size()) t[i] = 0.0f;
  g.sync();
  if (g.thread_rank() < (unsigned long long)n) atomicAdd(t + (g.thread_rank() * 7) % n, 1.0f);
  if (g.thread_rank() == 0) *flag = 1;
}

template <typename F>
float time_ms(F launch, int reps = 10) {
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  launch();
  cudaDeviceSynchronize();
  cudaEventRecord(a);
  for (int r = 0; r < reps; ++r) launch();
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  return ms / reps;
}

int main() {
  float* t;
  int* it;
  int* flag;
  if (cudaMalloc(&t, 64 << 20) != cudaSuccess || cudaMalloc(&it, 1 << 20) != cudaSuccess
      || cudaMalloc(&flag, 4) != cudaSuccess) return 1;
  const int blocks = 132 * 8, threads = 256, k = 32;
  const double n = (double)blocks * threads * k;
  for (unsigned mb : {2u, 8u, 32u}) {
    const unsigned mask = (mb << 20) / 4 - 1;
    float ms = time_ms([&] { g_scalar<<<blocks, threads>>>(t, mask, k); });
    printf("{\"case\": \"global float, random\", \"table_MB\": %u, \"adds\": %.0f, \"ms\": %.5f, "
           "\"G_ops_per_s\": %.1f}\n", mb, n, ms, n / ms / 1e6);
    ms = time_ms([&] { g_vec4<<<blocks, threads>>>(t, mask, k); });
    printf("{\"case\": \"global float4, random\", \"table_MB\": %u, \"ops\": %.0f, \"ms\": %.5f, "
           "\"G_ops_per_s\": %.1f, \"G_floats_per_s\": %.1f}\n", mb, n, ms, n / ms / 1e6,
           4 * n / ms / 1e6);
    const unsigned rows = (mb << 20) / 20;
    ms = time_ms([&] { g_rows5<<<blocks, threads>>>(t, rows, k); });
    printf("{\"case\": \"global float, 5 lanes a random 20-byte row\", \"table_MB\": %u, "
           "\"adds\": %.0f, \"ms\": %.5f, \"G_floats_per_s\": %.1f}\n", mb, n, ms, n / ms / 1e6);
  }
  for (unsigned hot : {128u, 1024u, 8192u}) {
    const float ms = time_ms([&] { g_hot<<<blocks, threads>>>(t, hot, k); });
    printf("{\"case\": \"global float, hot addresses\", \"addresses\": %u, \"adds\": %.0f, "
           "\"ms\": %.5f, \"G_ops_per_s\": %.1f}\n", hot, n, ms, n / ms / 1e6);
  }
  float ms = time_ms([&] { s_float<<<blocks, threads>>>(t, k); });
  printf("{\"case\": \"shared float, random in 32 KB\", \"adds\": %.0f, \"ms\": %.5f, "
         "\"G_ops_per_s\": %.1f}\n", n, ms, n / ms / 1e6);
  ms = time_ms([&] { s_int<<<blocks, threads>>>(it, k); });
  printf("{\"case\": \"shared int, random in 32 KB\", \"adds\": %.0f, \"ms\": %.5f, "
         "\"G_ops_per_s\": %.1f}\n", n, ms, n / ms / 1e6);
  int per_sm = 0, sms = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, coop, 1024, 0);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  long long nz = (10 << 20) / 4;
  void* args[] = {&t, &nz, &flag};
  const cudaError_t e = cudaLaunchCooperativeKernel((void*)coop, per_sm * sms, 1024, args, 0, 0);
  cudaDeviceSynchronize();
  ms = time_ms([&] { cudaLaunchCooperativeKernel((void*)coop, per_sm * sms, 1024, args, 0, 0); });
  printf("{\"case\": \"cooperative: zero 10 MB, grid sync, adds\", \"launch\": \"%s\", "
         "\"blocks\": %d, \"ms\": %.5f}\n", cudaGetErrorString(e), per_sm * sms, ms);
  ms = time_ms([&] { cudaMemsetAsync(t, 0, 10 << 20); });
  printf("{\"case\": \"cudaMemsetAsync 10 MB\", \"ms\": %.5f}\n", ms);
  const cudaError_t last = cudaGetLastError();
  return last == cudaSuccess && e == cudaSuccess ? 0 : 1;
}
'''


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_atomics_bench: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ".")
    from wisp_tpu_torch import kernels
    out = kernels.BUILD_ROOT / "bench"
    out.mkdir(parents=True, exist_ok=True)
    src, exe = out / "atomics.cu", out / "atomics"
    src.write_text(SOURCE)
    flags = [f for f in kernels.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    build = subprocess.run([kernels._nvcc(), *flags, str(src), "-o", str(exe)],
                           capture_output=True, text=True)
    if build.returncode != 0:
        print(build.stdout + build.stderr, file=sys.stderr)
        return 1
    run = subprocess.run([str(exe)], capture_output=True, text=True, timeout=300)
    for line in run.stdout.splitlines():
        json.loads(line)
        print(line, flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed")
    if run.returncode != 0:
        print(run.stderr, file=sys.stderr)
    return run.returncode


if __name__ == "__main__":
    sys.exit(main())
