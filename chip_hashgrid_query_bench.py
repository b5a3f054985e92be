#!/usr/bin/env python3
"""Time K14 (``hashgrid_query``, ``wisp_tpu_torch/csrc/hashgrid.cu``) in variants of its
design beside its earlier design and the card's write rate, on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_hashgrid_query_bench.py``. It builds the
kernel library, the earlier design (``csrc/baselines/hashgrid_query_v1.cu``) and each
variant below, an edited copy of ``csrc/hashgrid.cu`` built with the library's ``nvcc``
flags into a library of its own under ``wisp_tpu_torch/csrc/_build/hashgrid_query_bench/``
(entry points of one name do not clash across ``ctypes.CDLL``s):

- "redesign" (the library's: 32 points a block, one a lane, a warp a LOD, the rows read
  with an L2 evict-last policy and staged in a swizzled shared tile, 16-byte streaming
  stores);
- "__ldg loads" (the table's rows read with ``__ldg``, no cache policy);
- "write-back stores" (the tile written with plain stores in place of ``st.global.cs``);
- "no swizzle" (the tile's chunks in order: a warp's tile writes conflict 8 ways);
- "16 KB tile" (LOD groups of at most 16 KB of staging a block: two groups at 16 LODs);
- "unstaged" (each lane writes its (point, LOD)'s rows straight out, 16-byte streaming
  stores, no tile);
- "TMA store" (the tile unswizzled, written by one thread with ``cp.async.bulk`` a point's
  run, evict-first);
- "pair-major" (a thread a (point, LOD), the LOD fastest across lanes, its rows stored
  straight out: F = 2, 3D only);
- two probes, not held to the library's output: "no gathers" (each row's value made from
  its index, no table read) and "no output stores" (the tile read back and summed, no
  output written).

The shape is the uniform phase's of ``chip_smoke.py``: the flagship codebook (16 LODs from
res 16 to 512, bitwidth 19, F = 2; seeded, std 0.5) at the kept samples of render chunk
``CHUNK_INDEX`` of the 512x512 frame, marched 'uniform' (512 steps, stride 2) through a
dense level-7 octree and compacted step-major with a budget of every sample; and the first
65,536 of them. The library's output is held to the plain version exactly at both shapes,
the earlier design's and each variant's to the library's bit for bit; then each is timed
(``chip_smoke.timed``: device ms by torch.profiler, CUDA-event ms) in turns, two rounds,
beside ``index_select`` of the precomputed rows and ``zero_`` of a buffer of the output's
size (the card's write rate). A probe takes the library's and the earlier design's event time
before and after a profiler session and both with a synchronize after every call, with the
SM and memory clocks and the power drawn. It prints one JSON
line of the builds' registers, one a shape and round, the probe, then the card's name and
power limit. It fails without a card. Nothing in the package calls it.
"""

from __future__ import annotations

import ctypes
import functools
import json
import subprocess
import sys

sys.path.insert(0, ".")        # the checkout this is run from

import numpy as np
import torch

import chip_smoke as cs
from wisp_tpu_torch import kernels
from wisp_tpu_torch.accelstructs.octree_as import raymarch_uniform
from wisp_tpu_torch.core.camera import Camera
from wisp_tpu_torch.models.grids.hash_grid import HashGrid
from wisp_tpu_torch.ops import grid as grid_ops
from wisp_tpu_torch.ops.compaction import compact
from wisp_tpu_torch.ops.raygen.raygen import generate_pinhole_rays

TMA_OUT = r'''  const int points = min(kQueryPoints, N - p0);
  const int run = (l1 - l0) * pair4;
  if (threadIdx.x == 0) {
    unsigned long long policy;
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
    for (int p = 0; p < points; ++p) {
      float* o = out + ((size_t)(p0 + p) * q.n_lods + l0) * (C * F);
      const unsigned s = (unsigned)__cvta_generic_to_shared(query_tile + p * q.run_stride);
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], "
                   "%2, %3;" :: "l"(o), "r"(s), "r"(run * 16), "l"(policy) : "memory");
    }
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}
'''

COPY_OUT = '''  const int points = min(kQueryPoints, N - p0);
  const int run = (l1 - l0) * pair4;
  for (int p = warp; p < points; p += warps) {
    float4* o = reinterpret_cast<float4*>(out + ((size_t)(p0 + p) * q.n_lods + l0) * (C * F));
    const float4* s = query_tile + p * q.run_stride;
    for (int j = lane; j < run; j += 32) __stcs(o + j, s[query_swizzle(j, p)]);
  }
}
'''

SWIZZLE = "__device__ __forceinline__ int query_swizzle(int j, int p) { return j ^ (p & 7); }"
NO_SWIZZLE = "__device__ __forceinline__ int query_swizzle(int j, int p) { return j; }"
TILE_WRITE = "          mine[query_swizzle(j0 + j, lane)] = x;"
SYNC = "  if (!staged) return;\n  __syncthreads();"
SMEM = "  const size_t smem = (size_t)kQueryPoints * q.run_stride * 16;"

LDG = [('  asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;" : "=f"(v) : "l"(p), '
        '"l"(policy));', "  v = __ldg(p);"),
       ('  asm("ld.global.nc.L2::cache_hint.v2.f32 {%0, %1}, [%2], %3;"\n'
        '      : "=f"(v.x), "=f"(v.y) : "l"(p), "l"(policy));', "  v = __ldg(p);"),
       ('  asm("ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"\n'
        '      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p), "l"(policy));',
        "  v = __ldg(p);")]
STORE = "    for (int j = lane; j < run; j += 32) __stcs(o + j, s[query_swizzle(j, p)]);"

# (label, held to the library's output, [(text in csrc/hashgrid.cu, its replacement), ...]);
# the probes that are not held take out the gathers or the output's stores
VARIANTS = [
    ("__ldg loads", True, LDG),
    ("write-back stores", True, [
        (STORE, "    for (int j = lane; j < run; j += 32) o[j] = s[query_swizzle(j, p)];")]),
    ("no swizzle", True, [(SWIZZLE, NO_SWIZZLE)]),
    ("16 KB tile", True, [("constexpr int kQueryStageBytes = 49152;",
                           "constexpr int kQueryStageBytes = 16384;")]),
    ("unstaged", True, [
        (TILE_WRITE, "          __stcs(reinterpret_cast<float4*>(out + ((size_t)n * q.n_lods "
                     "+ l) * (C * FT)) + j, x);"),
        (SYNC, "  return;"), (SMEM, "  const size_t smem = 0;")]),
    ("TMA store", True, [(SWIZZLE, NO_SWIZZLE),
                         (SYNC, "  if (!staged) return;\n  asm volatile(\"fence.proxy.async."
                                "shared::cta;\" ::: \"memory\");\n  __syncthreads();"),
                         (COPY_OUT, TMA_OUT)]),
    ("probe: no gathers", False, [
        ("        for (int k = 0; k < C; ++k) query_row<FT>(table, row[k], in[k], policy, v[k]);",
         "        for (int k = 0; k < C; ++k)\n"
         "          for (int f = 0; f < FT; ++f) v[k][f] = __uint_as_float(row[k] + f);")]),
    ("probe: no output stores", False, [
        (STORE, "    float acc = 0.0f;\n"
                "    for (int j = lane; j < run; j += 32) acc += s[query_swizzle(j, p)].x;\n"
                "    if (acc == 1234.5f) o[lane] = make_float4(acc, acc, acc, acc);")]),
]

PAIR_MAJOR = r'''
#include "common.cuh"

namespace {

struct PairTable {
  int n_lods;
  int res[32];
  float hi[32];
  unsigned begin[32];
  unsigned rows[32];
  int dense[32];
  unsigned hash_mask;
};

// a thread a (point, LOD), LOD fastest; F = 2, 3D; its 8 rows stored as 4 16-byte
// streaming stores
__global__ void __launch_bounds__(256) pair_major_kernel(const float* __restrict__ coords,
                                                         const float* __restrict__ table,
                                                         int N, const __grid_constant__
                                                         PairTable q, float* __restrict__ out) {
  const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (unsigned)N * q.n_lods) return;
  const unsigned n = t / q.n_lods;
  const int l = (int)(t - n * q.n_lods);
  const unsigned primes[3] = {1u, 2654435761u, 805459861u};
  const bool dense = q.dense[l];
  const unsigned res = (unsigned)q.res[l];
  unsigned lo[3], up[3], stride = 1u;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float u = (coords[(size_t)n * 3 + d] + 1.0f) / 2.0f;
    const float x = fminf(fmaxf(u * (float)q.res[l], 0.0f), q.hi[l]);
    const unsigned c0 = (unsigned)(int)floorf(x);
    const unsigned m = dense ? stride : primes[d];
    lo[d] = c0 * m;
    up[d] = (c0 + 1u) * m;
    stride *= res;
  }
  float v[8][2];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    unsigned idx = 0u;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const unsigned term = (k >> (2 - d)) & 1 ? up[d] : lo[d];
      idx = d == 0 ? term : (dense ? idx + term : idx ^ term);
    }
    if (!dense) idx &= q.hash_mask;
    if (idx < q.rows[l]) {
      const float2 r = __ldg(reinterpret_cast<const float2*>(table) + q.begin[l] + idx);
      v[k][0] = r.x;
      v[k][1] = r.y;
    } else {
      v[k][0] = v[k][1] = __int_as_float(0x7fc00000);
    }
  }
  float4* o = reinterpret_cast<float4*>(out + (size_t)t * 16);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    __stcs(o + j, make_float4(v[2 * j][0], v[2 * j][1], v[2 * j + 1][0], v[2 * j + 1][1]));
}

}  // namespace

WISP_EXPORT int bench_pair_major(const float* coords, const float* table, long long N,
                                 int n_lods, const int* res, const float* hi,
                                 const long long* begin, const long long* rows,
                                 const int* dense, unsigned codebook_size, float* out,
                                 void* stream) {
  PairTable q;
  q.n_lods = n_lods;
  q.hash_mask = codebook_size - 1u;
  for (int l = 0; l < n_lods; ++l) {
    q.res[l] = res[l];
    q.hi[l] = hi[l];
    q.begin[l] = (unsigned)begin[l];
    q.rows[l] = (unsigned)rows[l];
    q.dense[l] = dense[l];
  }
  const long long total = N * n_lods;
  if (total > 0)
    pair_major_kernel<<<wisp::ceil_div(total, 256), 256, 0, (cudaStream_t)stream>>>(
        coords, table, (int)N, q, out);
  return (int)cudaGetLastError();
}
'''


def start_builds() -> list:
    """nvcc on each variant's source, all started together: [(label, library, process)]."""
    out_dir = kernels.BUILD_ROOT / "hashgrid_query_bench"
    out_dir.mkdir(parents=True, exist_ok=True)
    base = (kernels.CSRC / "hashgrid.cu").read_text()
    sources = []
    for i, (label, _, edits) in enumerate(VARIANTS):
        text = base
        for old, new in edits:
            cs.require(text.count(old) == 1, f"variant {label}: its edit no longer matches "
                                             f"csrc/hashgrid.cu: {old[:60]!r}")
            text = text.replace(old, new)
        sources.append((label, out_dir / f"variant{i}.cu", text))
    sources.append(("pair-major", out_dir / "pair_major.cu", PAIR_MAJOR))
    started = []
    for label, src, text in sources:
        src.write_text(text)
        lib = src.with_suffix(".so")
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-I",
               str(kernels.CSRC), str(src), "-o", str(lib)]
        started.append((label, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                     stderr=subprocess.STDOUT, text=True)))
    return started


def kernel_ptxas(lines, names) -> list:
    """ptxas's lines on each kernel whose name holds one of ``names``: its entry, its
    stack and spills, its registers."""
    out = []
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln and any(k in ln for k in names):
            out.append(" | ".join(x.strip() for x in lines[i:i + 4]))
    return out


def finish_builds(started) -> tuple:
    """({label: loaded library}, {label: ptxas lines of the query kernels})."""
    P, I, L, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint32
    libs, ptxas = {}, {}
    for label, lib_path, proc in started:
        log, _ = proc.communicate()
        cs.require(proc.returncode == 0, f"nvcc failed for variant {label}:\n{log}")
        lines = log.splitlines()
        ptxas[label] = kernel_ptxas(lines, ("query_kernel", "pair_major"))
        lib = ctypes.CDLL(str(lib_path))
        if label == "pair-major":
            lib.bench_pair_major.argtypes = [P, P, L, I, P, P, P, P, P, U, P, P]
        else:
            lib.wisp_hashgrid_query.argtypes = [P, P, L, I, I, I, P, P, P, P, P, U, P, P]
        libs[label] = lib
    return libs, ptxas


def chunk_samples(dev) -> torch.Tensor:
    """The kept samples of render chunk ``CHUNK_INDEX`` of the 512x512 frame, marched
    'uniform' (512 steps, stride 2) through a dense level-7 octree, compacted step-major."""
    cam = Camera.from_args(eye=cs.EYE, at=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0), width=cs.RES,
                           height=cs.RES, fov=np.radians(30.0), near=0.0, far=10.0)
    rays = generate_pinhole_rays(cam, device=dev)
    n_chunk = 16384
    sl = slice(cs.CHUNK_INDEX * n_chunk, (cs.CHUNK_INDEX + 1) * n_chunk)
    o, d = rays.origins[sl].contiguous(), rays.dirs[sl].contiguous()
    mr = raymarch_uniform(o, d, rays.dist_min, rays.dist_max, 512, 2, None, 7)
    _, cflat, _, count = compact(mr.mask, mr.samples, d, n_chunk * 512)
    return cflat[:int(count)].contiguous()


def stream() -> int:
    return torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())


def smi_clocks() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,"
                          "temperature.gpu", "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip()


HELD = {label: held for label, held, _ in VARIANTS}


def order_probe(fn, iters: int = 20) -> dict:
    """Where a device time above the event time comes from: events over back-to-back calls
    before and after a profiler session, that session's device time, and both again with a
    synchronize after every call (no launch can then start before the last one ends)."""
    from torch.profiler import ProfilerActivity, profile

    def synced_events():
        total = 0.0
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            total += start.elapsed_time(end)
        return total / iters

    def synced_device():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
                torch.cuda.synchronize()
        _, recorded = cs.device_kernels(prof, None)
        return sum(k["ms"] for k in recorded) / iters if recorded else None

    return {"events_before": cs.cuda_ms(fn, iters), "device": cs.timed(fn, iters)[0],
            "events_after": cs.cuda_ms(fn, iters), "device_synced": synced_device(),
            "events_synced": synced_events()}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_hashgrid_query_bench: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    started = start_builds()
    v1_started = cs.start_baseline_build(cs.HASHGRID_QUERY_V1_SRC,
                                         "libwisp_hashgrid_query_v1.so")
    kernels.build(verbose=True)
    lib_log = str(kernels.BUILD_INFO.get("log", "")).splitlines()
    libs, ptxas = finish_builds(started)
    ptxas["redesign"] = kernel_ptxas(lib_log, ("hashgrid_query_kernel",))
    v1 = cs.HashGridQueryV1(v1_started)
    print(json.dumps({"ptxas": ptxas}), flush=True)

    g = torch.Generator(device="cpu").manual_seed(14)
    grid = HashGrid.from_geometric(feature_dim=2, num_lods=16, codebook_bitwidth=19,
                                   min_grid_res=16, max_grid_res=512, feature_std=0.5,
                                   generator=g, device=dev)
    table = grid.codebook.feats.detach()
    args = (grid.codebook.resolutions, 19, 15, table, grid.codebook.begin_idxes,
            grid.codebook.num_feats)
    chunk = chunk_samples(dev)
    shapes = {"chunk": chunk, "first 65,536": chunk[:65536].contiguous()}
    probe = {}
    for rnd in range(2):
        for name, coords in shapes.items():
            n, dim, f_dim, n_lods, size, arrays = grid_ops.query_args(coords, *args)
            ptrs = [a.ctypes.data for a in arrays]
            out = torch.empty((n, n_lods, 8, f_dim), device=dev)

            def variant(label):
                if label == "pair-major":
                    status = libs[label].bench_pair_major(
                        coords.data_ptr(), table.data_ptr(), n, n_lods, *ptrs, size,
                        out.data_ptr(), stream())
                else:
                    status = libs[label].wisp_hashgrid_query(
                        coords.data_ptr(), table.data_ptr(), n, dim, f_dim, n_lods, *ptrs,
                        size, out.data_ptr(), stream())
                cs.require(status == 0, f"variant {label} failed ({status})")
                return out

            def library():
                return grid_ops.hashgrid_query(coords, *args)

            ref = library()
            if rnd == 0:
                cs.require(cs.query_equal(ref, grid_ops.hashgrid_query_plain(coords, *args)),
                           f"{name}: hashgrid_query differs from the plain version")
            calls = {"redesign": library, "v1": functools.partial(v1.query, coords, *args)}
            calls.update({label: functools.partial(variant, label) for label in libs})
            row = {"shape": name, "round": rnd, "points": n}
            bits = ref.view(torch.int32)
            for label, call in calls.items():
                cs.require(not HELD.get(label, True)
                           or torch.equal(call().view(torch.int32), bits),
                           f"{name}: variant {label} differs from the library's output")
                row[label] = cs.timed(call)
            del ref, bits
            rows = torch.randint(0, table.shape[0], (n * n_lods * 8,), device=dev)
            row["index_select (random rows)"] = cs.timed(
                lambda: torch.index_select(table, 0, rows))
            row["zero_ of the output"] = cs.timed(out.zero_)
            row["output_bytes"] = out.numel() * 4
            print(json.dumps(row), flush=True)
            if name == "chunk" and rnd == 1:
                probe = {"clocks_before": smi_clocks(),
                         "redesign": order_probe(library), "v1": order_probe(calls["v1"]),
                         "clocks_after": smi_clocks()}
            del out
    print(json.dumps({"probe": probe}), flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except cs.SmokeFailure as e:
        print(f"chip_hashgrid_query_bench: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
