#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (wisp_tpu_torch) on one NVIDIA GPU and check it.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one card and fails
(exit code 1, no result line) without one, or outside a checkout. What it does:

1. prints the card (``nvidia-smi`` name and power limit) and the torch / CUDA versions;
2. builds the hand-written kernels from ``wisp_tpu_torch/csrc`` and prints the build time
   (the full nvcc/ptxas log is kept beside the library, ``csrc/_build/<hash>/build.log``);
3. main path: renders one 512x512 ``OfflineRenderer.render_lookat`` frame of the flagship
   hash-grid NeRF at full width (app/nerf/configs/nerf_hash_lego_proxy.yaml: blas level 7,
   16 LODs at bitwidth 19 over 16..512, hidden 64, 512 steps at march stride 2, compaction
   0.25, 16,384-ray chunks) on an octree carved to ~4% occupancy. Weights are random from a
   seed; the hash table has std 0.5 (a trained field's scale) rather than the training init
   of 1e-9, so that every check sees non-trivial features. Kernel launch counts are set
   to 0 just before this frame and read just after it: each kernel must have run;
4. checks the frame (shapes, finite values, alpha in [0, 1]) and one chunk of it against
   the same chunk traced with the plain PyTorch versions on the card;
5. at the main path's shapes (one chunk of the frame), holds each kernel against its plain
   version and times kernel, plain version and, for the compaction, ``torch.nonzero``
   after warm-up: ``ms`` is device time a call (``timed``: the kernels' own time under
   torch.profiler), with the CUDA-event time of back-to-back calls beside it as
   ``event_ms``;
6. training path: builds the flagship-width trainer (the same config, AMP, AdamW with the
   scheduler, adaptive rays and compaction, sample-fed pruning) on a ``make_dense`` level-7
   octree and a 4-view 512x512 lego-proxy dataset (the config has 100 views: a cut of
   depth), sets the launch counts to 0, runs 20 ``MultiviewTrainer.iterate()`` steps, the
   trainer's prune, and 5 more steps, reads the counts (every kernel must have run), and
   requires finite losses that fall from steps 1-5 to steps 16-20;
7. profiles step 20 and, after the counts are read, holds each training kernel (K1, K3
   and K4 backward, K5, and the jittered march) against its plain version at the shapes
   of step 25 and times it;
8. SDF path: builds the NGLOD pipeline of app/nglod/configs/nglod_octree.yaml at full
   width on main_nglod.py's procedural icosphere (octree level 7; OctreeGrid 16 features
   x 6 LODs, 'sum'; NeuralSDF hidden 128; PackedSDFTracer 32 steps, step 0.8) with the
   sphere decoder of ``interop.sphere_sdf_decoder``, renders a warm-up frame, sets the
   counts to 0, renders one 512x512 frame and reads the counts (the query, interpolation,
   free-space field, walk and step kernels must all have run); checks the frame (shapes,
   finite, unit normals, alpha = hit, and the sphere's geometry), one chunk against the
   plain versions, then holds each SDF kernel against its plain version at that chunk's
   shapes, times it, profiles a frame on the card and one frame's host side (cProfile);
9. prints the ``kernels`` JSON line (every kernel: launches from the render frame for the
   forward kernels, from the training run for the training kernels and from the SDF frame
   for the SDF kernels), the main-path, ``train_path`` and ``sdf_path`` JSON lines, the
   nvidia-smi line and, last, ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import time
from contextlib import contextmanager
from unittest import mock

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
RES = 512
EYE = (0.0, 0.6, -3.0)
CHUNK_INDEX = 7                # a chunk through the middle of the frame
OCCUPANCY = 0.04
RENDER_KERNELS = ("raymarch_ray", "compact", "scatter_back", "hashgrid_fwd", "integrate_fwd")
TRAIN_KERNELS = RENDER_KERNELS + ("hashgrid_bwd", "scatter_back_bwd", "integrate_bwd",
                                  "scatter_max")


class SmokeFailure(Exception):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def carved_occupancy(level: int, frac: float, seed: int):
    """Union of seeded random balls in [-0.7, 0.7]^3 until ``frac`` of the cells are
    occupied; flat index (x*res + y)*res + z of the cell centres."""
    import numpy as np
    res = 2 ** level
    centres = (np.arange(res, dtype=np.float32) + 0.5) / (res / 2) - 1.0
    x, y, z = np.meshgrid(centres, centres, centres, indexing="ij")
    occ = np.zeros((res, res, res), bool)
    rng = np.random.default_rng(seed)
    while occ.mean() < frac:
        c = rng.uniform(-0.7, 0.7, size=3)
        r = rng.uniform(0.08, 0.2)
        occ |= (x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2 < r * r
    return occ.reshape(-1)


def flagship_pipeline(device):
    import torch
    from wisp_tpu_torch.accelstructs.octree_as import OctreeAS
    from wisp_tpu_torch.models.grids.hash_grid import HashGrid
    from wisp_tpu_torch.models.nefs.nerf import NeuralRadianceField
    from wisp_tpu_torch.models.pipeline import Pipeline
    from wisp_tpu_torch.tracers.packed_rf_tracer import PackedRFTracer
    gen = torch.Generator().manual_seed(0)
    occ = torch.from_numpy(carved_occupancy(7, OCCUPANCY, seed=0)).to(device)
    blas = OctreeAS.make_dense(7, device=device).update_occupancy(occ)
    grid = HashGrid.from_geometric(blas=blas, feature_dim=2, num_lods=16,
                                   multiscale_type="cat", feature_std=0.5, feature_bias=0.0,
                                   codebook_bitwidth=19, min_grid_res=16, max_grid_res=512,
                                   dense_lod_matmul="bf16", generator=gen, device=device)
    nef = NeuralRadianceField(grid=grid, pos_embedder="none", view_embedder="positional",
                              pos_multires=10, view_multires=4, position_input=False,
                              activation_type="relu", layer_type="linear", hidden_dim=64,
                              num_layers=1, bias=True, generator=gen, device=device)
    tracer = PackedRFTracer(raymarch_type="ray", num_steps=512, step_size=1.0,
                            bg_color=(1.0, 1.0, 1.0), compaction=0.25, early_stop=0.0,
                            lod_spacing_scale=1.0, march_stride=2)
    return Pipeline(nef=nef, tracer=tracer), float(occ.float().mean())


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timed(fn, iters: int = 20, warmup: int = 3):
    """(device ms, event ms) of one call of ``fn``. The device time is the kernels' own
    device time under torch.profiler over ``iters`` calls, divided by ``iters``: the card's
    work alone. The event time brackets back-to-back calls with CUDA events; for a short
    kernel it measures the wrapper's host time instead."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    event_ms = cuda_ms(fn, iters, warmup)
    for _ in range(3):       # a profiling session now and then records no kernel at all
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        busy_ms, _ = device_kernels(prof, 0)
        if busy_ms > 0.0:
            return busy_ms / iters, event_ms
    raise SmokeFailure("three profiling sessions saw no device time")


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_row(name, source, replaces, err, tol, ms, plain_ms, nbytes, ops, library_ms=None):
    """One entry of the ``kernels`` line; ``ms``, ``plain_ms`` and ``library_ms`` are
    ``timed`` pairs (device ms, event ms)."""
    bms, by = bound(nbytes, ops)
    require(err <= tol, f"{name}: max_abs_err {err} above its tolerance {tol}")
    lib = library_ms if library_ms is not None else (None, None)
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "max_abs_err": err, "tol": tol, "ms": ms[0], "plain_ms": plain_ms[0],
            "bound_ms": bms, "bound_by": by, "library_ms": lib[0], "event_ms": ms[1],
            "plain_event_ms": plain_ms[1], "library_event_ms": lib[1], "bytes": nbytes,
            "ops": ops}


@contextmanager
def plain_versions():
    """Route the tracer's kernel calls to the plain PyTorch versions (on the card)."""
    from wisp_tpu_torch.accelstructs import octree_as
    from wisp_tpu_torch.ops import compaction, grid, integration
    from wisp_tpu_torch.tracers import packed_rf_tracer
    with mock.patch.object(octree_as, "raymarch_ray", octree_as.raymarch_ray_plain), \
            mock.patch.object(grid, "hashgrid", grid.hashgrid_plain), \
            mock.patch.object(packed_rf_tracer, "compact", compaction.compact_plain), \
            mock.patch.object(packed_rf_tracer, "scatter_back",
                              compaction.scatter_back_plain), \
            mock.patch.object(packed_rf_tracer, "integrate", integration.integrate_plain):
        yield


def hash_rows_touched(coords, grid, n_lods: int) -> int:
    """Distinct table rows that the hash-grid lookups of ``coords`` read."""
    import torch
    from wisp_tpu_torch.ops.grid import corner_offsets, hash_index
    offsets = torch.as_tensor(corner_offsets(3), device=coords.device)
    rows = []
    for i in range(n_lods):
        res = grid.resolutions[i]
        x = torch.clamp((coords + 1.0) * (res / 2.0), 0.0, res - 1 - 1e-5)
        corners = torch.floor(x).to(torch.int64)[:, None, :] + offsets[None]
        idx = hash_index(corners, res, grid.codebook_size).reshape(-1)
        rows.append(torch.unique(idx) + grid.codebook.begin_idxes[i])
    return int(sum(r.numel() for r in rows))


def field_cells_touched(samples, stride: int, level: int) -> int:
    """Distinct cells of the occupancy field that the march's strided tests read (the
    strided samples inside the box)."""
    import torch
    from wisp_tpu_torch.ops.spc.core import quantize_points
    c = samples[:, ::stride].reshape(-1, 3)
    c = c[((c >= -1.0) & (c < 1.0)).all(-1)]
    q = quantize_points(c, level)
    res = 2 ** level
    return int(torch.unique((q[:, 0] * res + q[:, 1]) * res + q[:, 2]).numel())


def kernel_phase(pipeline, rays):
    """Each kernel against its plain version and timed, at the shapes one chunk of the
    main path gives it."""
    import torch
    from wisp_tpu_torch.accelstructs.octree_as import raymarch_ray, raymarch_ray_plain
    from wisp_tpu_torch.ops import grid as grid_ops
    from wisp_tpu_torch.ops.compaction import (compact, compact_plain, compaction_budget,
                                               scatter_back, scatter_back_plain)
    from wisp_tpu_torch.ops.integration import integrate, integrate_plain
    nef, tracer = pipeline.nef, pipeline.tracer
    grid, blas = nef.grid, nef.grid.blas
    o, d = rays.origins, rays.dirs
    r, s, stride = o.shape[0], tracer.num_steps, tracer.march_stride
    field, level = blas.cell_density, blas.max_level
    rows = []

    def row(name, source, replaces, err, tol, ms, plain_ms, nbytes, ops, library_ms=None):
        rows.append(kernel_row(name, source, replaces, err, tol, ms, plain_ms, nbytes, ops,
                               library_ms))

    # K2 march
    mr = raymarch_ray(o, d, rays.dist_min, rays.dist_max, s, stride, field, level)
    mp = raymarch_ray_plain(o, d, rays.dist_min, rays.dist_max, s, stride, field, level)
    require(torch.equal(mr.mask, mp.mask), "raymarch_ray: mask differs from the plain version")
    err = max(float((mr.samples - mp.samples).abs().max()),
              float((mr.depth_samples - mp.depth_samples).abs().max()),
              float((mr.cell_density - mp.cell_density).abs().max()),
              float((mr.deltas - mp.deltas).abs().max()))
    nc = -(-s // stride)
    row("raymarch_ray", "wisp_tpu_torch/csrc/raymarch.cu",
        "wisp_tpu/accelstructs/octree_as.py:492", err, 1e-6,
        timed(lambda: raymarch_ray(o, d, rays.dist_min, rays.dist_max, s, stride, field,
                                     level)),
        timed(lambda: raymarch_ray_plain(o, d, rays.dist_min, rays.dist_max, s, stride,
                                           field, level), iters=5),
        nbytes=r * 24 + field_cells_touched(mp.samples, stride, level) * 4
        + r * s * (12 + 4 + 1 + 4) + r * 4,
        ops=r * s * 12 + r * nc * 2 * 9)

    # K3 compaction
    budget = compaction_budget(r, s, tracer.compaction)
    mask, samples = mr.mask, mr.samples
    got = compact(mask, samples, d, budget)
    want = compact_plain(mask, samples, d, budget)
    require(torch.equal(got[3], want[3]), "compact: valid count differs")
    valid = int(got[3])
    kept = min(valid, budget)
    # only the first `kept` slots are defined (and read by the tracer)
    err = max(float((a[:kept].double() - b[:kept].double()).abs().max()) if kept else 0.0
              for a, b in zip(got[:3], want[:3]))
    row("compact", "wisp_tpu_torch/csrc/compaction.cu",
        "wisp_tpu/ops/compaction.py:23", err, 0.0,
        timed(lambda: compact(mask, samples, d, budget)),
        timed(lambda: compact_plain(mask, samples, d, budget), iters=5),
        nbytes=r * s + r * 12 + kept * (12 + 8 + 24) + 8, ops=0.0,
        library_ms=timed(lambda: torch.nonzero(mask.T)))
    idx, cflat, cray_d = got[0], got[1][:kept], got[2][:kept]

    # K1 hash grid forward, at the main path's LODs (max_compute_lod and the 'cat' quirk)
    mcl = tracer.max_compute_lod(grid, "ray", s, tracer.lod_spacing_scale)
    n_lods = min(grid.num_lods, grid.num_lods - 1, mcl + 1)
    table = grid.codebook.feats.detach()
    args = (grid.codebook.resolutions, grid.codebook_bitwidth, n_lods - 1, table,
            grid.codebook.begin_idxes, grid.codebook.num_feats)
    hk = grid_ops.hashgrid(cflat, *args, out_lods=grid.num_lods)
    hp = grid_ops.hashgrid_plain(cflat, *args, out_lods=grid.num_lods)
    f_dim = grid.feature_dim
    row("hashgrid_fwd", "wisp_tpu_torch/csrc/hashgrid.cu", "wisp_tpu/ops/grid.py:335",
        float((hk - hp).abs().max()), 1e-5,
        timed(lambda: grid_ops.hashgrid(cflat, *args, out_lods=grid.num_lods)),
        timed(lambda: grid_ops.hashgrid_plain(cflat, *args, out_lods=grid.num_lods),
                iters=3),
        nbytes=kept * 12 + hash_rows_touched(cflat, grid, n_lods) * f_dim * 4
        + kept * grid.num_lods * f_dim * 4,
        ops=kept * n_lods * (9 + 8 * (2 + 2 * f_dim)))

    # K3 scatter-back of the field's colours
    with torch.no_grad():
        out = nef(channels=["rgb", "density"], coords=cflat, ray_d=cray_d,
                  lod_idx=grid.num_lods - 1, max_compute_lod=mcl)
    v = out["rgb"].contiguous()
    sk = scatter_back(v, idx, r * s)
    sp = scatter_back_plain(v, idx, r * s)
    row("scatter_back", "wisp_tpu_torch/csrc/compaction.cu",
        "wisp_tpu/tracers/packed_rf_tracer.py:210", float((sk - sp).abs().max()), 0.0,
        timed(lambda: scatter_back(v, idx, r * s)),
        timed(lambda: scatter_back_plain(v, idx, r * s)),
        nbytes=kept * (12 + 8) + r * s * 12, ops=0.0)

    # K4 integration
    density = scatter_back(out["density"].contiguous(), idx, r * s).reshape(r, s)
    color = sk.reshape(r, s, 3)
    depths = mr.depth_samples
    ik = integrate(density, mr.deltas, depths, mask, color, tracer.bg_color)
    ip = integrate_plain(density, mr.deltas, depths, mask, color, tracer.bg_color)
    require(torch.equal(ik["hit"], ip["hit"]), "integrate_fwd: hit differs")
    err = max(float((ik[k] - ip[k]).abs().max()) for k in ("rgb", "alpha", "depth"))
    row("integrate_fwd", "wisp_tpu_torch/csrc/integrate.cu",
        "wisp_tpu/tracers/packed_rf_tracer.py:258", err, 1e-4,
        timed(lambda: integrate(density, mr.deltas, depths, mask, color, tracer.bg_color)),
        timed(lambda: integrate_plain(density, mr.deltas, depths, mask, color,
                                        tracer.bg_color)),
        nbytes=r * s * (4 + 4 + 1 + 12) + r * 4 + r * (12 + 4 + 4 + 1), ops=r * s * 16)
    return rows, {"chunk_rays": r, "valid": valid, "budget": budget, "kept": kept}


def profile_frame(renderer, pipeline, top: int = 12) -> dict:
    """One frame under torch.profiler: device time by kernel name and the share of the
    frame's wall time in which some kernel ran (an upper bound: kernels on one stream do
    not overlap, so their sum is the busy time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        renderer.render_lookat(pipeline, f=EYE)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, top_kernels = device_kernels(prof, top)
    return {"profile_frame_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms > 0 else None,
            "top_device_kernels": top_kernels}


def device_kernels(prof, top: int):
    """(device busy ms, the ``top`` kernels by device time) of a profile: the sum of the
    kernels' own device time (kernels on one stream do not overlap), leaving out
    annotated ranges such as ``Optimizer.step``, whose device time is their kernels'."""
    kernels_ = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us and getattr(ev, "device_type", None) is not None \
                and "CUDA" in str(ev.device_type) \
                and not getattr(ev, "is_user_annotation", False):
            kernels_.append((ev.key, dev_us / 1e3, ev.count))
    kernels_.sort(key=lambda k: -k[1])
    return (sum(k[1] for k in kernels_),
            [{"name": n[:80], "ms": ms, "count": c} for n, ms, c in kernels_[:top]])


TRAIN_VIEWS = 4                # the flagship config has 100 views at 512x512
TRAIN_STEPS_BEFORE_PRUNE = 20
TRAIN_STEPS_AFTER_PRUNE = 5


def flagship_trainer(device):
    """The trainer of app/nerf/configs/nerf_hash_lego_proxy.yaml at full width."""
    import torch
    from wisp_tpu_torch.accelstructs.octree_as import OctreeAS
    from wisp_tpu_torch.datasets.random_view_dataset import RandomViewDataset
    from wisp_tpu_torch.datasets.transforms.ray_sampler import SampleRays
    from wisp_tpu_torch.models.grids.hash_grid import HashGrid
    from wisp_tpu_torch.models.nefs.nerf import NeuralRadianceField
    from wisp_tpu_torch.models.pipeline import Pipeline
    from wisp_tpu_torch.tracers.packed_rf_tracer import PackedRFTracer
    from wisp_tpu_torch.trainers.base_trainer import ConfigAdamW
    from wisp_tpu_torch.trainers.multiview_trainer import (ConfigMultiviewTrainer,
                                                           MultiviewTrainer)
    dataset = RandomViewDataset(num_views=TRAIN_VIEWS, height=RES, width=RES,
                                scene="lego_proxy", transform=SampleRays(4096), device=device)
    gen = torch.Generator().manual_seed(1)
    grid = HashGrid.from_geometric(blas=OctreeAS.make_dense(7, device=device), feature_dim=2,
                                   num_lods=16, multiscale_type="cat", feature_std=1e-9,
                                   feature_bias=0.0, codebook_bitwidth=19, min_grid_res=16,
                                   max_grid_res=512, dense_lod_matmul="bf16", generator=gen,
                                   device=device)
    nef = NeuralRadianceField(grid=grid, pos_embedder="none", view_embedder="positional",
                              pos_multires=10, view_multires=4, position_input=False,
                              activation_type="relu", layer_type="linear", hidden_dim=64,
                              num_layers=1, bias=True, prune_density_decay=0.95,
                              prune_min_density=2.956033378250884, generator=gen,
                              device=device)
    tracer = PackedRFTracer(raymarch_type="ray", num_steps=512, step_size=1.0,
                            bg_color=(1.0, 1.0, 1.0), compaction=0.25, early_stop=0.0,
                            lod_spacing_scale=1.0, march_stride=2)
    cfg = ConfigMultiviewTrainer(
        optimizer=ConfigAdamW(lr=1e-3, eps=1e-16, weight_decay=1e-6),
        exp_name="nerf-hash-lego-proxy", max_epochs=100, valid_every=-1, enable_amp=True,
        grid_lr_weight=500.0, scheduler=True, prune_every=100, adaptive_compaction=True,
        rgb_lambda=1.0, rgb_loss_type="huber", rgb_loss_denom="rays")
    return MultiviewTrainer(cfg, Pipeline(nef=nef, tracer=tracer), dataset, device=device)


def train_kernel_phase(trainer, num_rays: int, compaction: float):
    """Each training kernel against its plain version and timed, at the shapes of one step
    (``num_rays`` rays of the first view, drawn here without the trainer's sampler, the
    step's compaction budget and the trainer's field as it stands)."""
    import torch
    from wisp_tpu_torch.accelstructs.octree_as import raymarch_ray, raymarch_ray_plain
    from wisp_tpu_torch.ops import grid as grid_ops
    from wisp_tpu_torch.ops.compaction import (compact, compaction_budget, scatter_back,
                                               scatter_back_bwd, scatter_back_bwd_plain)
    from wisp_tpu_torch.ops.density_grid import cell_ids, scatter_max, scatter_max_plain
    from wisp_tpu_torch.ops.integration import integrate_bwd, integrate_bwd_plain
    pipeline = trainer.pipeline
    nef, tracer = pipeline.nef, pipeline.tracer
    grid, blas = nef.grid, nef.grid.blas
    view = trainer.train_dataset.data["rays"][0]
    g = torch.Generator(device=view.origins.device).manual_seed(7)
    pick = torch.randint(0, view.origins.shape[0], (num_rays,), generator=g,
                         device=view.origins.device)
    o, d = view.origins[pick].contiguous(), view.dirs[pick].contiguous()
    r, s, stride = o.shape[0], tracer.num_steps, tracer.march_stride
    field = None if blas.dense else blas.cell_density
    level = blas.max_level
    jitter = torch.rand((r, s), generator=g, device=o.device)
    rows = []

    def row(name, source, replaces, err, tol, ms, plain_ms, nbytes, ops, library_ms=None):
        rows.append(kernel_row(name, source, replaces, err, tol, ms, plain_ms, nbytes, ops,
                               library_ms))

    # the jittered march (K2 with u): exact against the plain version
    lo, hi = view.dist_min, view.dist_max
    mr = raymarch_ray(o, d, lo, hi, s, stride, field, level, jitter)
    mp = raymarch_ray_plain(o, d, lo, hi, s, stride, field, level, jitter)
    require(torch.equal(mr.mask, mp.mask) and torch.equal(mr.samples, mp.samples)
            and torch.equal(mr.depth_samples, mp.depth_samples),
            "raymarch_ray with jitter differs from the plain version")
    budget = compaction_budget(r, s, compaction)
    idx, cflat, cray_d, count = compact(mr.mask, mr.samples, d, budget)
    valid = int(count)
    kept = min(valid, budget)
    coords, dirs = cflat[:kept], cray_d[:kept]
    mcl = tracer.max_compute_lod(grid, "ray", s, tracer.lod_spacing_scale)
    n_lods = min(grid.num_lods - 1, mcl + 1)
    f_dim = grid.feature_dim
    with torch.no_grad():
        out = nef(channels=["rgb", "density"], coords=coords, ray_d=dirs,
                  lod_idx=grid.num_lods - 1, max_compute_lod=mcl)

    # K1 backward on a seeded cotangent of the step's features
    args = (grid.codebook.resolutions, grid.codebook_bitwidth, n_lods - 1,
            grid.codebook.total_feats, grid.codebook.begin_idxes, grid.codebook.num_feats)
    g_feat = torch.randn((kept, grid.num_lods * f_dim), generator=g, device=o.device)
    hk = grid_ops.hashgrid_bwd(coords, g_feat, *args, out_lods=grid.num_lods)
    hp = grid_ops.hashgrid_bwd_plain(coords, g_feat, *args, out_lods=grid.num_lods)
    scale = max(1.0, float(hp.abs().max()))
    row("hashgrid_bwd", "wisp_tpu_torch/csrc/hashgrid.cu", "wisp_tpu/ops/grid.py:55",
        float((hk - hp).abs().max()), 1e-5 * scale,
        timed(lambda: grid_ops.hashgrid_bwd(coords, g_feat, *args,
                                              out_lods=grid.num_lods)),
        timed(lambda: grid_ops.hashgrid_bwd_plain(coords, g_feat, *args,
                                                    out_lods=grid.num_lods), iters=3),
        nbytes=kept * 12 + kept * n_lods * f_dim * 4
        + hash_rows_touched(coords, grid, n_lods) * f_dim * 4,
        ops=kept * n_lods * (9 + 8 * (2 + 2 * f_dim)))

    # scatter-back backward of the colour channel (the gather)
    g_col = torch.randn((r * s, 3), generator=g, device=o.device)
    bk = scatter_back_bwd(g_col, idx, kept)
    bp = scatter_back_bwd_plain(g_col, idx, kept)
    sel = idx[:kept]
    row("scatter_back_bwd", "wisp_tpu_torch/csrc/compaction.cu",
        "wisp_tpu/tracers/packed_rf_tracer.py:214",
        float((bk - bp).abs().max()) if kept else 0.0, 0.0,
        timed(lambda: scatter_back_bwd(g_col, idx, kept)),
        timed(lambda: scatter_back_bwd_plain(g_col, idx, kept)),
        nbytes=kept * (8 + 12 + 12), ops=0.0,
        library_ms=timed(lambda: g_col.index_select(0, sel)))

    # K4 backward, with the step's densities and colours and a cotangent of rgb only
    density = scatter_back(out["density"].float().contiguous(), idx, r * s).reshape(r, s)
    color = scatter_back(out["rgb"].float().contiguous(), idx, r * s).reshape(r, s, 3)
    g_rgb = torch.randn((r, 3), generator=g, device=o.device) / r
    bg = tracer.bg_color
    ik = integrate_bwd(density, mr.deltas, mr.depth_samples, mr.mask, color, bg, g_rgb)
    ip = integrate_bwd_plain(density, mr.deltas, mr.depth_samples, mr.mask, color, bg, g_rgb)
    scale = max(float(ip[0].abs().max()), float(ip[1].abs().max()), 1e-30)
    err = max(float((ik[0] - ip[0]).abs().max()), float((ik[1] - ip[1]).abs().max()))
    row("integrate_bwd", "wisp_tpu_torch/csrc/integrate.cu",
        "wisp_tpu/tracers/packed_rf_tracer.py:258", err, 1e-5 * scale,
        timed(lambda: integrate_bwd(density, mr.deltas, mr.depth_samples, mr.mask, color,
                                      bg, g_rgb)),
        timed(lambda: integrate_bwd_plain(density, mr.deltas, mr.depth_samples, mr.mask,
                                            color, bg, g_rgb)),
        nbytes=r * s * (4 + 1 + 12) + r * (4 + 12) + r * s * (4 + 12),
        ops=r * s * 40)

    # K5 on the step's cells and densities
    ids = cell_ids(coords, level)
    dens = out["density"][:, 0].float().contiguous()
    size = 8 ** level
    mk = scatter_max(ids, dens, size)
    mp_ = scatter_max_plain(ids, dens, size)
    lib_grid = torch.zeros((size,), dtype=torch.float32, device=o.device)
    row("scatter_max", "wisp_tpu_torch/csrc/scatter_max.cu",
        "wisp_tpu/tracers/packed_rf_tracer.py:255",
        0.0 if torch.equal(mk, mp_) else float((mk - mp_).abs().max()), 0.0,
        timed(lambda: scatter_max(ids, dens, size)),
        timed(lambda: scatter_max_plain(ids, dens, size)),
        nbytes=kept * (8 + 4) + size * 4, ops=0.0,
        library_ms=timed(lambda: lib_grid.scatter_reduce_(0, ids, dens, "amax")))
    return rows, {"rays": r, "valid": valid, "budget": budget, "kept": kept,
                  "trained_lods": n_lods}


def profile_step(trainer, top: int = 12) -> dict:
    """One training step under torch.profiler: device time by kernel and the idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.iterate()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, top_kernels = device_kernels(prof, top)
    return {"profile_step_ms": wall_ms, "step_device_busy_ms": busy_ms,
            "step_device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms > 0 else None,
            "step_top_device_kernels": top_kernels}


def train_phase(dev):
    """The training path: counts from 0, 20 steps (the 20th profiled), a prune, 5 steps,
    counts read after. Then the kernels are held against their plain versions at the
    shapes of step 25."""
    import math
    import torch
    from wisp_tpu_torch import kernels
    t0 = time.perf_counter()
    trainer = flagship_trainer(dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    tracer, nef = trainer.pipeline.tracer, trainer.pipeline.nef
    steps = []
    prune = {}
    kernels.reset_launches()
    for i in range(TRAIN_STEPS_BEFORE_PRUNE + TRAIN_STEPS_AFTER_PRUNE):
        if i == TRAIN_STEPS_BEFORE_PRUNE:
            fed = float((trainer._density_max_grid > 0).float().mean())
            t0 = time.perf_counter()
            trainer.prune()          # the method pre_step calls on its cadence
            torch.cuda.synchronize()
            prune = {"prune_ms": (time.perf_counter() - t0) * 1e3,
                     "cells_fed_by_training_samples": fed,
                     "occupancy_after_prune": float(nef.grid.blas.occ_grid.float().mean())}
        rays = trainer.train_dataset.transform.num_samples
        budget = tracer.compaction
        if i == TRAIN_STEPS_BEFORE_PRUNE - 1:
            profiled = profile_step(trainer)     # step 20 runs under the profiler
            ms = profiled["profile_step_ms"]
        else:
            t0 = time.perf_counter()
            trainer.iterate()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        valid = trainer._prev_num_samples
        steps.append({"step": i + 1, "ms": ms, "rays": rays, "budget": budget,
                      "valid_fraction": valid / (rays * tracer.num_steps),
                      "loss": trainer.last_loss})
    launches = dict(kernels.LAUNCHES)
    missing = [k for k in TRAIN_KERNELS if launches[k] <= 0]
    require(not missing, f"kernels not launched on the training path: {missing}")
    rows, shape_info = train_kernel_phase(trainer, steps[-1]["rays"], steps[-1]["budget"])
    losses = [st["loss"] for st in steps]
    require(all(math.isfinite(x) for x in losses), f"non-finite training loss: {losses}")
    first = sum(losses[:5]) / 5
    late = sum(losses[15:20]) / 5
    require(late < first, f"the loss did not fall: steps 1-5 {first}, steps 16-20 {late}")
    for row_ in rows:
        row_["launches"] = launches[row_["name"]]
    # steps 2-19: after the first step's set-up, before the profiled step 20
    steady = sorted(st["ms"] for st in steps[1:TRAIN_STEPS_BEFORE_PRUNE - 1])
    rates = sorted(st["rays"] / st["ms"] * 1e3
                   for st in steps[1:TRAIN_STEPS_BEFORE_PRUNE - 1])
    info = {
        "train_path": "MultiviewTrainer.iterate (20 steps, prune, 5 steps), flagship width",
        "views": TRAIN_VIEWS, "setup_s": setup_s,
        "step_ms_median": steady[len(steady) // 2],
        "rays_per_s_median": rates[len(rates) // 2],
        "loss_steps_1_5": first, "loss_steps_16_20": late,
        "budget_after_adaptive_compaction": tracer.compaction,
        "rays_per_step_last": trainer.train_dataset.transform.num_samples,
        "steps": steps, "launches": launches, "kernel_phase_shapes": shape_info,
    }
    info.update(prune)
    info.update(profiled)
    return rows, info


SDF_LEVEL = 7
SDF_NUM_LODS = 6
SDF_SAMPLES = 2_000_000
SDF_KERNELS = ("octree_query", "octree_interp", "free_space_distance", "sdf_walk",
               "sphere_step")
# the icosphere's facets lie between radius 0.897 (face centres) and 0.9 (vertices): a
# zero set off that band leaves the one-voxel shell of occupied cells, and rays that miss
# the shell's zero crossing do not hit
SDF_RADIUS = 0.8985
SDF_FD_TAPS = 6                # finitediff_gradient's field queries for the normals
SDF_HIT_MARGIN = 1e-5          # | |sdf| - min_dis | under which a hit may flip
SDF_DEPTH_TOL = 1e-4           # depth and xyz on rays that hit in both traces
SDF_NORMAL_TOL = 1e-4


def nglod_pipeline(device):
    """app/nglod/configs/nglod_octree.yaml at full width on main_nglod.py's procedural
    icosphere (main_nglod.py:61-66: subdivisions 3, normalized to 'sphere', 2,000,000
    surface samples, octree level 7). The feature grid keeps its config init (std 0.01,
    seeded); the decoder is ``interop.sphere_sdf_decoder``, under which the field is close
    to |x| - SDF_RADIUS (random decoder weights give no distance function, and a sphere
    tracer then hits almost nothing)."""
    import numpy as np
    import torch
    from wisp_tpu_torch import interop
    from wisp_tpu_torch.accelstructs.octree_as import OctreeAS
    from wisp_tpu_torch.models.grids.octree_grid import OctreeGrid
    from wisp_tpu_torch.models.nefs.neural_sdf import NeuralSDF
    from wisp_tpu_torch.models.pipeline import Pipeline
    from wisp_tpu_torch.ops.mesh.io import make_sphere_mesh
    from wisp_tpu_torch.ops.mesh.ops import normalize, sample_surface
    from wisp_tpu_torch.ops.spc.core import make_dual, quantize_points_np
    from wisp_tpu_torch.tracers.packed_sdf_tracer import PackedSDFTracer
    v, f = make_sphere_mesh(radius=1.0, subdivisions=3)
    v, f = normalize(v, f, "sphere")
    samples = sample_surface(v, f, SDF_SAMPLES)
    blas = OctreeAS.from_quantized_points(quantize_points_np(samples, SDF_LEVEL), SDF_LEVEL,
                                          device=device)
    gen = torch.Generator().manual_seed(2)
    grid = OctreeGrid(blas=blas, feature_dim=16, num_lods=SDF_NUM_LODS,
                      interpolation_type="linear",
                      multiscale_type="sum", feature_std=0.01, generator=gen, device=device)
    nef = NeuralSDF(grid=grid, pos_embedder="none", position_input=True,
                    activation_type="relu", hidden_dim=128, num_layers=1, generator=gen,
                    device=device)
    with torch.no_grad():
        for name, value in interop.sphere_sdf_decoder(16, 128, seed=0,
                                                      radius=SDF_RADIUS).items():
            nef.get_parameter(name).copy_(torch.from_numpy(value))
    tracer = PackedSDFTracer(num_steps=32, step_size=0.8)
    dual, _ = make_dual(blas.points)
    stats = {"level_counts": list(blas.level_counts),
             "active_lods": list(grid.active_lods),
             "dual_vertex_rows": [int(len(dual[l])) for l in grid.active_lods],
             "feature_bytes": sum(p.numel() * 4 for p in grid.features),
             "trinket_bytes": sum(t.numel() * 4 for t in grid.trinkets),
             "pidx_map_bytes": sum(m.numel() * 4 for m in blas.pidx_maps),
             "occupied_fraction": blas.level_counts[-1] / 8 ** SDF_LEVEL}
    return Pipeline(nef=nef, tracer=tracer), stats


@contextmanager
def plain_sdf_versions():
    """Route the SDF path's kernel calls to the plain PyTorch versions (on the card)."""
    from wisp_tpu_torch.accelstructs import octree_as
    from wisp_tpu_torch.models.grids import octree_grid
    from wisp_tpu_torch.tracers import packed_sdf_tracer as sdf
    with mock.patch.object(octree_as, "octree_query", octree_as.octree_query_plain), \
            mock.patch.object(octree_as, "free_space_distance",
                              octree_as.free_space_distance_plain), \
            mock.patch.object(octree_grid, "octree_interp", octree_grid.octree_interp_plain), \
            mock.patch.object(sdf, "sdf_walk", sdf.sdf_walk_plain), \
            mock.patch.object(sdf, "sphere_step", sdf.sphere_step_plain):
        yield


def walk_work(o, d, t, alive, t_far, free_dist, level: int, num_steps: int):
    """(steps that the walk takes over all rays, distinct cells of the free-space field
    that it reads): the walk's data-dependent work, counted with its plain operations."""
    import torch
    from wisp_tpu_torch.tracers.packed_sdf_tracer import _fsd_at, _free_step
    res, voxel = 2 ** level, 2.0 / 2 ** level
    t, alive = t.clone(), alive.clone()
    steps, cells = 0, []
    for _ in range(num_steps):
        k, pos = _fsd_at(o, d, t, free_dist, level)
        inside = ((pos >= -1.0) & (pos < 1.0)).all(-1)
        q = ((pos + 1.0) * (res / 2.0)).floor().long().clamp(0, res - 1)
        cells.append(((q[:, 0] * res + q[:, 1]) * res + q[:, 2])[alive & inside])
        adv = alive & (k > 0)
        steps += int(adv.sum())
        t = torch.where(adv, t + _free_step(k, pos, d, voxel), t)
        alive = alive & (t <= t_far)
    return steps, int(torch.unique(torch.cat(cells)).numel())


def sdf_kernel_phase(pipeline, rays):
    """Each SDF kernel against its plain version and timed, at the shapes one chunk of the
    main path gives it: the walk from the rays' entry, a sphere step and the field's query
    and interpolation at the rays' points after the walk and 4 sphere iterations."""
    import torch
    from wisp_tpu_torch.accelstructs.octree_as import (aabb_intersect, free_space_distance,
                                                       free_space_distance_plain,
                                                       octree_query, octree_query_plain)
    from wisp_tpu_torch.models.grids.octree_grid import octree_interp, octree_interp_plain
    from wisp_tpu_torch.ops.spc.core import quantize_points
    from wisp_tpu_torch.tracers.packed_sdf_tracer import (sdf_walk, sdf_walk_plain,
                                                          sphere_step, sphere_step_plain)
    nef, tracer = pipeline.nef, pipeline.tracer
    grid, blas = nef.grid, nef.grid.blas
    level, steps = blas.max_level, tracer.num_steps
    o, d = rays.origins, rays.dirs
    n = o.shape[0]
    rows = []

    def copies(*ts, count=48):
        """Fresh inputs for each call of an in-place kernel (timed makes 43 calls)."""
        it = iter([tuple(x.clone() for x in ts) for _ in range(count)])
        return lambda: next(it)

    # K11 on the octree's occupancy
    occ = blas.occ_grid
    fk = free_space_distance(occ, level)
    fp = free_space_distance_plain(occ, level)
    require(torch.equal(fk, fp), "free_space_distance differs from the plain version")
    cells = 8 ** level
    rows.append(kernel_row(
        "free_space_distance", "wisp_tpu_torch/csrc/octree.cu",
        "wisp_tpu/accelstructs/octree_as.py:254", 0.0, 0.0,
        timed(lambda: free_space_distance(occ, level)),
        timed(lambda: free_space_distance_plain(occ, level), iters=5),
        nbytes=cells * (1 + 4), ops=cells * 3 * 2))

    # K12 walk from the rays' entry
    t_near, t_far = aabb_intersect(o, d, rays.dist_min, rays.dist_max)
    t0 = t_near.clamp(min=0.0) + 1e-6
    a0 = t_far > t0
    t_far = t_far.contiguous()
    tk, ak = t0.clone(), a0.clone()
    tp, ap = t0.clone(), a0.clone()
    sdf_walk(o, d, tk, ak, t_far, fk, level, steps)
    sdf_walk_plain(o, d, tp, ap, t_far, fk, level, steps)
    require(torch.equal(tk, tp) and torch.equal(ak, ap),
            "sdf_walk differs from the plain version")
    taken, walk_cells = walk_work(o, d, t0, a0, t_far, fk, level, steps)
    state, plain_state = copies(t0, a0), copies(t0, a0, count=16)
    rows.append(kernel_row(
        "sdf_walk", "wisp_tpu_torch/csrc/sphere_trace.cu",
        "wisp_tpu/tracers/packed_sdf_tracer.py:121", 0.0, 0.0,
        timed(lambda: sdf_walk(o, d, *state(), t_far, fk, level, steps)),
        timed(lambda: sdf_walk_plain(o, d, *plain_state(), t_far, fk, level, steps),
              iters=5),
        nbytes=n * (24 + 4 + 1 + 4) + n * (4 + 1) + walk_cells * 4, ops=taken * 50))

    # 4 sphere iterations with the kernels, then the field at the rays' points
    t, alive, hit = tk, ak, torch.zeros_like(ak)
    for _ in range(4):
        dist = nef(channels="sdf", coords=o + t[:, None] * d)[:, 0].contiguous()
        sphere_step(o, d, t, alive, hit, t_far, dist, fk, level, tracer.step_size,
                    tracer.min_dis)
    coords = (o + t[:, None] * d).contiguous()
    dist = nef(channels="sdf", coords=coords)[:, 0].contiguous()

    # K12 sphere step
    sk, sp = (t.clone(), alive.clone(), hit.clone()), (t.clone(), alive.clone(), hit.clone())
    sphere_step(o, d, *sk, t_far, dist, fk, level, tracer.step_size, tracer.min_dis)
    sphere_step_plain(o, d, *sp, t_far, dist, fk, level, tracer.step_size, tracer.min_dis)
    require(all(torch.equal(a, b) for a, b in zip(sk, sp)),
            "sphere_step differs from the plain version")
    live = int(alive.sum())
    state, plain_state = copies(t, alive, hit), copies(t, alive, hit, count=16)
    rows.append(kernel_row(
        "sphere_step", "wisp_tpu_torch/csrc/sphere_trace.cu",
        "wisp_tpu/tracers/packed_sdf_tracer.py:136", 0.0, 0.0,
        timed(lambda: sphere_step(o, d, *state(), t_far, dist, fk, level, tracer.step_size,
                                  tracer.min_dis)),
        timed(lambda: sphere_step_plain(o, d, *plain_state(), t_far, dist, fk, level,
                                        tracer.step_size, tracer.min_dis), iters=5),
        nbytes=n * (1 + 1) + live * (24 + 4 + 4 + 4 + 4) + live * (4 + 1 + 1),
        ops=live * 60))

    # K9 with parents, as OctreeGrid.interpolate asks, at the last LOD
    maps = blas.pidx_maps
    qk = octree_query(coords, maps, level, True)
    qp = octree_query_plain(coords, maps, level, True)
    require(torch.equal(qk, qp), "octree_query differs from the plain version")
    q = quantize_points(coords, level)
    inside = ((coords >= -1.0) & (coords <= 1.0)).all(-1)
    map_entries = 0
    for l in range(level + 1):
        ql = q[inside] >> (level - l)
        map_entries += int(torch.unique((ql[:, 0] * 2 ** l + ql[:, 1]) * 2 ** l
                                        + ql[:, 2]).numel())
    rows.append(kernel_row(
        "octree_query", "wisp_tpu_torch/csrc/octree.cu",
        "wisp_tpu/accelstructs/octree_as.py:199", 0.0, 0.0,
        timed(lambda: octree_query(coords, maps, level, True)),
        timed(lambda: octree_query_plain(coords, maps, level, True)),
        nbytes=n * 12 + n * (level + 1) * 4 + map_entries * 4,
        ops=n * (3 * 4 + (level + 1) * 6)))

    # K15 over the 6 LODs, 'sum'
    lods = grid.num_lods
    args = (coords, qk, grid.base_lod, grid.trinkets, [f.detach() for f in grid.features],
            grid.active_lods, grid.multiscale_type)
    ik = octree_interp(*args)
    ip = octree_interp_plain(*args)
    f_dim = grid.feature_dim
    trinket_rows = feature_rows = valid = 0
    for i in range(lods):
        p = qk[:, grid.base_lod + i]
        p = p[p >= 0].long()
        valid += int(p.numel())
        trinket_rows += int(torch.unique(p).numel())
        feature_rows += int(torch.unique(grid.trinkets[i][p].reshape(-1)).numel())
    rows.append(kernel_row(
        "octree_interp", "wisp_tpu_torch/csrc/octree_grid.cu",
        "wisp_tpu/models/grids/octree_grid.py:115", float((ik - ip).abs().max()), 1e-6,
        timed(lambda: octree_interp(*args)), timed(lambda: octree_interp_plain(*args)),
        nbytes=n * 12 + n * lods * 4 + trinket_rows * 32 + feature_rows * f_dim * 4
        + n * f_dim * 4,
        ops=valid * (3 * 5 + 8 * (2 + 2 * f_dim))))
    return rows, {"chunk_rays": n, "walk_steps_taken": taken, "walk_cells": walk_cells,
                  "live_rays_after_4_iterations": live, "interp_valid_lod_points": valid,
                  "interp_trinket_rows": trinket_rows, "interp_feature_rows": feature_rows,
                  "query_map_entries": map_entries}


def host_top(renderer, pipeline, top: int = 12) -> dict:
    """One frame under cProfile: its host wall time and the functions with the most host
    time of their own (name, calls, own ms, cumulative ms)."""
    import cProfile
    import pstats
    import torch
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    renderer.render_lookat(pipeline, f=EYE)
    torch.cuda.synchronize()
    prof.disable()
    wall_ms = (time.perf_counter() - t0) * 1e3
    stats = pstats.Stats(prof).stats
    rows = sorted(stats.items(), key=lambda kv: -kv[1][2])[:top]
    return {"host_profile_frame_ms": wall_ms,
            "host_top": [{"fn": f"{path.split('/')[-1]}:{line}({fn})", "calls": v[1],
                          "own_ms": v[2] * 1e3, "cum_ms": v[3] * 1e3}
                         for (path, line, fn), v in rows]}


def sdf_phase(dev):
    """The NGLOD render path: the pipeline at full width, a warm-up frame, then counts
    from 0, one timed 512x512 frame, counts read after. Then the frame's checks, one chunk
    against the plain versions, the kernels at that chunk's shapes, and a profiled frame."""
    import numpy as np
    import torch
    from wisp_tpu_torch import kernels
    from wisp_tpu_torch.core.camera import Camera
    from wisp_tpu_torch.core.rays import Rays
    from wisp_tpu_torch.ops.raygen.raygen import generate_pinhole_rays
    from wisp_tpu_torch.trainers.tracker.offline_renderer import OfflineRenderer
    t0 = time.perf_counter()
    pipeline, stats = nglod_pipeline(dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    print(json.dumps({"nglod_octree": stats, "setup_s": setup_s}), flush=True)
    tracer, nef = pipeline.tracer, pipeline.nef
    renderer = OfflineRenderer(render_res=(RES, RES), device=dev)
    renderer.render_lookat(pipeline, f=EYE)          # warm-up
    torch.cuda.synchronize()

    # -- the SDF path: counts from 0, one frame, counts read right after ----------------
    kernels.reset_launches()
    t0 = time.perf_counter()
    rb = renderer.render_lookat(pipeline, f=EYE)
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(kernels.LAUNCHES)
    missing = [k for k in SDF_KERNELS if launches[k] <= 0]
    require(not missing, f"kernels not launched on the SDF path: {missing}")
    chunks = -(-RES * RES // renderer.render_batch)
    queries = chunks * (tracer.num_steps + SDF_FD_TAPS)
    expected = {"octree_query": queries, "octree_interp": queries,
                "free_space_distance": chunks, "sdf_walk": chunks,
                "sphere_step": chunks * tracer.num_steps}

    # -- the frame ----------------------------------------------------------------------
    for key, c in (("depth", 1), ("normal", 3), ("xyz", 3), ("rgb", 3), ("alpha", 1),
                   ("hit", 1)):
        require(tuple(rb.channels[key].shape) == (RES, RES, c),
                 f"{key}: shape {tuple(rb.channels[key].shape)}")
    finite = all(bool(torch.isfinite(rb.channels[k]).all())
                 for k in ("depth", "normal", "xyz", "rgb", "alpha"))
    require(finite, "non-finite SDF channels")
    hit = rb.hit[..., 0]
    hit_frac = float(hit.float().mean())
    require(0.0 < hit_frac < 1.0, f"SDF hit fraction {hit_frac}: blank or full")
    alpha = rb.alpha[..., 0]
    require(bool(((alpha == 0.0) | (alpha == 1.0)).all())
            and torch.equal(alpha == 1.0, hit), "alpha is not the hit mask in {0, 1}")
    norm_err = float((rb.normal[hit].norm(dim=-1) - 1.0).abs().max())
    require(norm_err <= 1e-4, f"normals on hits are not unit: {norm_err}")

    # geometry: the field approximates the sphere of radius 0.9
    cam = Camera.from_args(eye=EYE, at=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0), width=RES,
                           height=RES, fov=np.radians(30.0), near=0.0, far=10.0)
    all_rays = generate_pinhole_rays(cam, device=dev)
    o_all, d_all = all_rays.origins, all_rays.dirs
    c = RES // 2
    centre = c * RES + c
    centre_depth = float(rb.depth[c, c, 0])
    want_depth = float(np.linalg.norm(EYE)) - 0.9
    centre_dot = float((rb.normal[c, c] * -d_all[centre]).sum())
    closest = (o_all - (o_all * d_all).sum(-1, keepdim=True) * d_all).norm(dim=-1)
    far_hits = int((hit.reshape(-1) & (closest > 0.95)).sum())
    require(hit_frac >= 0.8, f"SDF geometry: {hit_frac} of rays hit, want >= 0.8")
    require(abs(centre_depth - want_depth) <= 0.02,
            f"SDF geometry: centre depth {centre_depth}, want {want_depth} +- 0.02")
    require(centre_dot > 0.9, f"SDF geometry: centre normal . -dir = {centre_dot}")
    require(far_hits == 0, f"SDF geometry: {far_hits} hits on rays passing beyond 0.95")
    more_ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        renderer.render_lookat(pipeline, f=EYE)
        torch.cuda.synchronize()
        more_ms.append((time.perf_counter() - t0) * 1e3)

    # -- one chunk of the frame: kernels against the plain versions on the card ---------
    n_chunk = renderer.render_batch
    sl = slice(CHUNK_INDEX * n_chunk, (CHUNK_INDEX + 1) * n_chunk)
    chunk = Rays(o_all[sl].contiguous(), d_all[sl].contiguous(), all_rays.dist_min,
                 all_rays.dist_max)
    with torch.no_grad():
        a = pipeline(rays=chunk)
        before = dict(kernels.LAUNCHES)
        with plain_sdf_versions():
            b = pipeline(rays=chunk)
        require(dict(kernels.LAUNCHES) == before, "a plain-version trace launched a kernel")
        sdf_a = nef(channels="sdf", coords=a.xyz)[:, 0]
    ha, hb = a.hit[:, 0], b.hit[:, 0]
    differ = ha != hb
    margin = ((sdf_a.abs() - tracer.min_dis).abs())
    require(not bool((differ & (margin > SDF_HIT_MARGIN)).any()),
            f"{int(differ.sum())} hits differ from the plain versions' beyond the margin")
    both = ha & hb
    chunk_err = {k: float((a.channels[k] - b.channels[k])[both].abs().max())
                 for k in ("depth", "xyz", "normal")}
    require(chunk_err["depth"] <= SDF_DEPTH_TOL and chunk_err["xyz"] <= SDF_DEPTH_TOL
            and chunk_err["normal"] <= SDF_NORMAL_TOL,
            f"SDF chunk differs from the plain versions: {chunk_err}")
    require(torch.equal(rb.depth.reshape(-1)[sl], a.depth[:, 0]),
            "SDF chunk re-trace differs from the frame")

    with torch.no_grad():
        rows, shape_info = sdf_kernel_phase(pipeline, chunk)
    for row_ in rows:
        row_["launches"] = launches[row_["name"]]
    info = {
        "sdf_path": f"OfflineRenderer.render_lookat {RES}x{RES}, nglod_octree.yaml width",
        "setup_s": setup_s, "octree": stats, "frame_ms": frame_ms, "more_frame_ms": more_ms,
        "rays_per_s": RES * RES / (frame_ms / 1e3), "hit_fraction": hit_frac,
        "launches": {k: launches[k] for k in SDF_KERNELS}, "expected_launches": expected,
        "other_launches": {k: v for k, v in launches.items() if k not in SDF_KERNELS},
        "centre_depth": centre_depth, "centre_depth_expected": want_depth,
        "centre_normal_dot_minus_dir": centre_dot, "hits_beyond_0_95": far_hits,
        "normal_norm_err": norm_err, "finite": finite,
        "chunk_hits_differ": int(differ.sum()),
        "chunk_min_margin_of_differing": float(margin[differ].min()) if differ.any()
        else None,
        "chunk_max_abs_err_vs_plain": chunk_err,
        "chunk_tol": {"depth_xyz": SDF_DEPTH_TOL, "normal": SDF_NORMAL_TOL,
                      "hit_margin": SDF_HIT_MARGIN},
        "kernel_phase_shapes": shape_info,
    }
    info.update(profile_frame(renderer, pipeline))
    info.update(host_top(renderer, pipeline))
    return rows, info


def run() -> dict:
    import numpy as np
    import torch
    try:
        from wisp_tpu_torch import kernels
        from wisp_tpu_torch.core.rays import Rays
        from wisp_tpu_torch.ops.compaction import compaction_budget
        from wisp_tpu_torch.trainers.tracker.offline_renderer import OfflineRenderer
    except ImportError as e:
        raise SmokeFailure(f"wisp_tpu_torch not importable ({e}); run from the root of "
                           f"a checkout")
    smi = nvidia_smi_line()
    print(f"device: {smi} | torch {torch.__version__} | CUDA {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    kernels.build(verbose=True)
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in str(kernels.BUILD_INFO.get("log", "")).splitlines()
             if "registers" in ln or "spill" in ln and "0 bytes spill" not in ln]
    print(json.dumps({"build_s": build_s, "ptxas": ptxas[:40]}), flush=True)
    kernels.library()

    dev = torch.device("cuda")
    pipeline, occ_frac = flagship_pipeline(dev)
    renderer = OfflineRenderer(render_res=(RES, RES), device=dev)
    tracer = pipeline.tracer
    per_chunk = []
    trace = tracer.trace

    @functools.wraps(trace)
    def recording_trace(*args, **kwargs):
        rb = trace(*args, **kwargs)
        per_chunk.append(tracer.prev_num_samples)
        return rb

    tracer.trace = recording_trace
    renderer.render_lookat(pipeline, f=EYE)          # warm-up: allocator, cuBLAS
    torch.cuda.synchronize()

    # -- the main path: counts from 0, one frame, counts read right after ---------------
    per_chunk.clear()
    kernels.reset_launches()
    t0 = time.perf_counter()
    rb = renderer.render_lookat(pipeline, f=EYE)
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(kernels.LAUNCHES)
    missing = [k for k in RENDER_KERNELS if launches[k] <= 0]
    require(not missing, f"kernels not launched on the main path: {missing}")
    chunk_valid = list(per_chunk)

    rgb, alpha, depth = rb.rgb, rb.alpha, rb.depth
    require(tuple(rgb.shape) == (RES, RES, 3) and tuple(alpha.shape) == (RES, RES, 1)
            and tuple(depth.shape) == (RES, RES, 1), f"bad output shapes {rb}")
    finite = all(bool(torch.isfinite(t).all()) for t in (rgb, alpha, depth))
    require(finite, "non-finite rgb/alpha/depth")
    require(float(alpha.min()) >= 0.0 and float(alpha.max()) <= 1.0 + 1e-5,
            "alpha outside [0, 1]")
    hit_frac = float(rb.hit.float().mean())
    require(0.0 < hit_frac < 1.0, f"hit fraction {hit_frac}: the frame is blank or full")
    more_ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        renderer.render_lookat(pipeline, f=EYE)
        torch.cuda.synchronize()
        more_ms.append((time.perf_counter() - t0) * 1e3)

    # -- one chunk of the frame: kernels against the plain versions on the card ---------
    from wisp_tpu_torch.core.camera import Camera
    from wisp_tpu_torch.ops.raygen.raygen import generate_pinhole_rays
    cam = Camera.from_args(eye=EYE, at=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0), width=RES,
                           height=RES, fov=np.radians(30.0), near=0.0, far=10.0)
    all_rays = generate_pinhole_rays(cam, device=dev)
    n_chunk = renderer.render_batch
    sl = slice(CHUNK_INDEX * n_chunk, (CHUNK_INDEX + 1) * n_chunk)
    chunk = Rays(all_rays.origins[sl].contiguous(), all_rays.dirs[sl].contiguous(),
                 all_rays.dist_min, all_rays.dist_max)
    with torch.no_grad():
        a = pipeline(rays=chunk)
        with plain_versions():
            b = pipeline(rays=chunk)
    chunk_err = {k: float((a.channels[k] - b.channels[k]).abs().max())
                 for k in ("rgb", "alpha", "depth")}
    require(all(e <= 1e-3 for e in chunk_err.values()),
            f"chunk differs from the plain versions: {chunk_err}")
    require(float(a.num_valid_samples) == float(b.num_valid_samples),
            "chunk valid-sample counts differ")
    frame_rows = rgb.reshape(-1, 3)[sl]
    require(float((frame_rows - a.rgb).abs().max()) <= 1e-6,
            "chunk re-trace differs from the frame")

    rows, shape_info = kernel_phase(pipeline, chunk)
    for row_ in rows:
        row_["launches"] = launches[row_["name"]]

    budget = compaction_budget(n_chunk, tracer.num_steps, tracer.compaction)
    total_samples = RES * RES * tracer.num_steps
    valid_total = float(rb.num_valid_samples)
    main = {
        "main_path": f"OfflineRenderer.render_lookat {RES}x{RES}, flagship width",
        "frame_ms": frame_ms, "more_frame_ms": more_ms,
        "rays_per_s": RES * RES / (frame_ms / 1e3),
        "occupancy": occ_frac, "hit_fraction": hit_frac,
        "valid_sample_fraction": valid_total / total_samples,
        "chunks": len(chunk_valid), "chunk_budget": budget,
        "max_chunk_valid": max(chunk_valid),
        "budget_overflow_samples": sum(max(0, v - budget) for v in chunk_valid),
        "launches": launches, "finite": finite,
        "chunk_max_abs_err_vs_plain": chunk_err, "chunk_tol": 1e-3,
        "kernel_phase_shapes": shape_info,
    }
    main.update(profile_frame(renderer, pipeline))
    del pipeline, renderer, rb
    train_rows, train_info = train_phase(dev)
    torch.cuda.empty_cache()
    sdf_rows, sdf_info = sdf_phase(dev)
    print(json.dumps({"kernels": rows + train_rows + sdf_rows}), flush=True)
    print(json.dumps(main), flush=True)
    print(json.dumps(train_info), flush=True)
    print(json.dumps(sdf_info), flush=True)
    print(smi, flush=True)
    return {"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                   "count": torch.cuda.device_count()}}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    try:
        result = run()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
