#!/usr/bin/env python3
"""Time the compaction kernels and the paths that call the redesigned kernels, on one
NVIDIA GPU.

Run from the root of a checkout; it imports that checkout's ``chip_smoke.py`` and
``wisp_tpu_torch``, so the same file run from two checkouts compares them:

    python3 chip_compaction_bench.py kernels
    python3 chip_compaction_bench.py paths [label]
    python3 chip_compaction_bench.py sdf [label]
    python3 chip_compaction_bench.py sdfframe [label]
    python3 chip_compaction_bench.py octree [label]
    python3 chip_compaction_bench.py l8 [label]
    python3 chip_compaction_bench.py spc [label]
    python3 chip_compaction_bench.py seg [label]

``kernels``: ``compact`` (K3, K6a) and ``compact_rays`` (K12, its mid pass) at the four
shapes of ``PERF.md``'s compaction rows, on seeded inputs (march-like runs of valid steps;
K12's masks with the rows' live counts): each held exactly to its plain version and to the
earlier three-pass design, then timed (``chip_smoke.timed``: device ms, CUDA-event ms)
beside the three-pass design and ``torch.nonzero``, with the device ms of each kernel a
call and the launches a call.

``paths``: without profiler or recording, 15 flagship render frames (the render phase's
carved field), 40 flagship training steps (the train phase's trainer; the first two left
out) and, after 300 NGLOD app steps, 10 each of the 512x512 SDF frame uncompacted, at
compaction 0.55 and with the mid pass at 0.3 (the nglod app phase's settings), in turns;
then one flagship frame under torch.profiler (``profile_frame``: device-busy ms, idle
share, the kernels with the most device time; K2 runs once a chunk, 16 times) and one
flagship training step after the 40 (``train_step``: device-busy ms, idle share and the
device kernels it launched).
``sdf``: the SDF frames of ``paths`` alone, in a process that runs nothing before them,
then one frame of each under torch.profiler (``chip_smoke.profile_call``: wall, device-busy
ms and idle share; the compacted frames take one scatter-back launch a chunk, the mid
frame one more for its mid pass).
``sdfframe``: the SDF render phase's frame (``chip_smoke.nglod_pipeline``, 512x512 through
``OfflineRenderer.render_lookat``, the free-space field (K11) made once a chunk, as the
tracer makes it when no field is held): 15 frames' wall ms after a warm-up, then one frame
under torch.profiler (``chip_smoke.profile_frame``: device-busy ms, idle share, the kernels
with the most device time), then one frame's launches, by ``kernels.LAUNCHES`` and by
torch.profiler (every device kernel).
``octree``: the octree NeRF phase's trainer (``nerf_octree_lego_proxy.yaml`` through
``main_nerf``, ``chip_smoke.octree_app``): 40 steps' wall ms (the first two left out of the
median), then one step under torch.profiler (device-busy ms, idle share, the device
kernels it launched, top kernels; K15's backward runs once a step).
``l8``: the NGLOD app's trainer on a level-8 octree (``chip_smoke.nglod_app`` with
``--blas-level 8``, as the nglod phase's level-8 step: its max level above the pidx maps,
so each step's octree query binary-searches its code table): 40 steps' wall ms (the first
two left out of the median), then one step under torch.profiler
(``chip_smoke.profile_step``) and one step's launches (``kernels.LAUNCHES``).
``spc``: the SPC browser scene's frame (the "spc browser" phase's: ``chip_smoke``'s level-7
SPC of 1,000,000 sphere samples, its free-space field held by the tracer, 512x512
orthographic rays through ``OfflineRenderer.render`` in chunks of 65,536, 64 walk steps):
15 frames' wall ms after a warm-up, then 5 frames under torch.profiler
(``chip_smoke.profile_call``: wall, device-busy ms and idle share each; the kernels with the
most device time of the first) and one frame's launches (``kernels.LAUNCHES`` and every
device kernel).
``seg``: the "seg" phase's trainer (the flagship trainer with ``seg_early_stop``
``chip_smoke.SEG_EPS`` and ``seg_count`` ``chip_smoke.SEG_COUNT``: K6a, K6b, K6c and K5
accumulated on four segments a step): 40 steps' wall ms (the first two left out of the
median), then one step under torch.profiler (device-busy ms, idle share, the device
kernels it launched, top kernels) and one step's launches (``kernels.LAUNCHES``).
Each mode prints one JSON line; run ``paths`` from the parent's and the change's checkouts
in turns (parent, change, change, parent, ...) to compare them: these paths are bound by
the host, and their spread from process to process is wide.
"""

from __future__ import annotations

import copy
import json
import statistics
import sys
import tempfile
import time

sys.path.insert(0, ".")        # the checkout this is run from, not this file's

import numpy as np
import torch

import chip_smoke as cs
from wisp_tpu_torch import kernels
from wisp_tpu_torch.ops.compaction import (compact, compact_plain, compact_rays,
                                           compact_rays_plain)

K3_SHAPES = {                  # rays, steps, share of steps in a ray's run, budget, carry
    "K3 render chunk": (16384, 512, 0.09, 2097152, False),
    "K6a segment": (2048, 128, 0.12, 65536, True),
    "K3 train step": (8192, 512, 0.2, 1048576, False),
    "K3 voxel march": (4096, 464, 0.2, 1900544, False),
}
K12_SHAPES = {                 # rays, live rays, budget
    "K12 compaction": (65536, 38511, 36045),
    "K12 mid compaction": (36045, 5475, 19661),
}


def march_mask(gen, r: int, s: int, share: float, dev):
    """Each ray valid over a run of up to 2 * share * s steps from a random step, with 10%
    of the run's steps dropped."""
    start = torch.randint(0, s, (r, 1), generator=gen)
    length = (torch.rand(r, 1, generator=gen) * 2 * share * s).long()
    steps = torch.arange(s)[None]
    keep = torch.rand(r, s, generator=gen) < 0.9
    return ((steps >= start) & (steps < start + length) & keep).to(dev)


def kernels_mode(dev) -> dict:
    started = cs.start_baseline_build(cs.THREEPASS_SRC, "libwisp_threepass.so")
    kernels.build()
    cs.THREEPASS = cs.ThreePass(started)
    gen = torch.Generator(device="cpu").manual_seed(0)
    out = {}
    for name, (r, s, share, budget, carry) in K3_SHAPES.items():
        mask = march_mask(gen, r, s, share, dev)
        samples = torch.randn(r, s, 3, generator=gen).to(dev)
        dirs = torch.randn(r, 3, generator=gen).to(dev)
        acc = (torch.rand(r, generator=gen) * 3.0).to(dev) if carry else None
        cap = 6.9077554 if carry else None
        args = (mask, samples, dirs, budget, acc, cap)
        want = compact_plain(*args)
        cs.require(cs.compact_equal(compact(*args), want, budget), f"{name}: differs")
        cs.require(cs.compact_equal(cs.THREEPASS.compact(*args), want, budget),
                   f"{name}: the three-pass design differs")
        live = mask if acc is None else mask & (acc < cap)[:, None]
        out[name] = {"valid": int(want[3]), "ms": cs.timed(lambda: compact(*args)),
                     "was_ms": cs.timed(lambda: cs.THREEPASS.compact(*args)),
                     "nonzero_ms": cs.timed(lambda: torch.nonzero(live.T)),
                     "launches_per_call": cs.launches_per_call(lambda: compact(*args)),
                     "ms_by_kernel": cs.device_ms_by_kernel(lambda: compact(*args))}
    for name, (r, live, budget) in K12_SHAPES.items():
        mask = torch.zeros(r, dtype=torch.bool)
        mask[torch.randperm(r, generator=gen)[:live]] = True
        mask = mask.to(dev)
        o, d = (torch.randn(r, 3, generator=gen).to(dev) for _ in "od")
        t, tf = (torch.rand(r, generator=gen).to(dev) for _ in "tf")
        args = (mask, budget, o, d, t, tf)
        want = compact_rays_plain(*args)
        cs.require(cs.rays_equal(compact_rays(*args), want), f"{name}: differs")
        cs.require(cs.rays_equal(cs.THREEPASS.compact_rays(*args), want),
                   f"{name}: the three-pass design differs")
        out[name] = {"count": int(want[5]), "ms": cs.timed(lambda: compact_rays(*args)),
                     "was_ms": cs.timed(lambda: cs.THREEPASS.compact_rays(*args)),
                     "nonzero_ms": cs.timed(lambda: torch.nonzero(mask)),
                     "launches_per_call": cs.launches_per_call(lambda: compact_rays(*args)),
                     "ms_by_kernel": cs.device_ms_by_kernel(lambda: compact_rays(*args))}
    return out


def clock(fn) -> float:
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def paths_mode(dev, flagship: bool) -> dict:
    from wisp_tpu_torch.core.camera import Camera
    from wisp_tpu_torch.core.rays import Rays
    from wisp_tpu_torch.ops.raygen.raygen import generate_pinhole_rays
    from wisp_tpu_torch.trainers.tracker.offline_renderer import OfflineRenderer
    kernels.build()
    out, profile = {}, None
    if flagship:
        pipeline, _ = cs.flagship_pipeline(dev)
        renderer = OfflineRenderer(render_res=(cs.RES, cs.RES), device=dev)
        clock(lambda: renderer.render_lookat(pipeline, f=cs.EYE))
        out["render_frame_ms"] = [clock(lambda: renderer.render_lookat(pipeline, f=cs.EYE))
                                  for _ in range(15)]
        profile = cs.profile_frame(renderer, pipeline)
        del pipeline, renderer
        trainer = cs.flagship_trainer(dev)
        out["train_step_ms"] = [clock(trainer.iterate) for _ in range(40)][2:]
        profile["train_step"] = step_profile(trainer)
        del trainer
        torch.cuda.empty_cache()

    _, pipe, tr = cs.nglod_app("--tracker.log-dir", tempfile.mkdtemp(prefix="wisp_bench_"),
                               "--tracker.run-name", "bench")
    for _ in range(300):
        tr.iterate()
    nef, vis = pipe.nef, tr.tracker.cfg.vis_camera
    cam = Camera.from_args(eye=tuple(vis.camera_origin), at=tuple(vis.camera_lookat),
                           up=(0.0, 1.0, 0.0), width=cs.NGLOD_FRAME_RES,
                           height=cs.NGLOD_FRAME_RES, fov=np.radians(vis.camera_fov),
                           near=vis.camera_clamp[0], far=vis.camera_clamp[1])
    rays = generate_pinhole_rays(cam, device=dev)
    perm = torch.from_numpy(np.random.default_rng(0).permutation(
        rays.origins.reshape(-1, 3).shape[0])).to(dev)
    rays = Rays(rays.origins.reshape(-1, 3)[perm].contiguous(),
                rays.dirs.reshape(-1, 3)[perm].contiguous(), rays.dist_min, rays.dist_max)
    base = pipe.tracer.with_free_dist(nef.grid.blas)
    variants = {"uncompacted": {}, "compacted": {"compaction": cs.NGLOD_COMPACTION},
                "mid": {"compaction": cs.NGLOD_COMPACTION,
                        "mid_compaction": cs.NGLOD_MID_COMPACTION, "mid_at": cs.NGLOD_MID_AT}}
    tracers = {}
    for name, kw in variants.items():
        tracers[name] = copy.copy(base)
        for k, v in kw.items():
            setattr(tracers[name], k, v)
        cs.trace_chunks(nef, tracers[name], rays, cs.NGLOD_CHUNK)       # warm-up
    for name in tracers:
        out[f"sdf_{name}_frame_ms"] = []
    for _ in range(10):
        for name, tracer in tracers.items():
            out[f"sdf_{name}_frame_ms"].append(
                clock(lambda: cs.trace_chunks(nef, tracer, rays, cs.NGLOD_CHUNK)))
    if not flagship:
        profile = {}
        for name, tracer in tracers.items():
            wall, busy, top, launched = cs.profile_call(
                lambda: cs.trace_chunks(nef, tracer, rays, cs.NGLOD_CHUNK))
            profile[name] = {"wall_ms": wall, "device_busy_ms": busy,
                             "device_idle_share": cs.idle_share(busy, wall),
                             "device_kernels_launched": launched, "top_device_kernels": top}
    return out, profile


def sdf_frame_mode(dev) -> dict:
    from torch.profiler import ProfilerActivity, profile
    from wisp_tpu_torch.trainers.tracker.offline_renderer import OfflineRenderer
    kernels.build()
    pipeline, _ = cs.nglod_pipeline(dev)
    renderer = OfflineRenderer(render_res=(cs.RES, cs.RES), device=dev)

    def frame():
        return clock(lambda: renderer.render_lookat(pipeline, f=cs.EYE))

    frame()                                                              # warm-up
    frames = [frame() for _ in range(15)]
    frame_profile = cs.profile_frame(renderer, pipeline)
    # one frame's launches: the hand-written kernels' (kernels.LAUNCHES) and every device
    # kernel's (torch.profiler, PyTorch's own included)
    kernels.reset_launches()
    frame()
    frame_profile["hand_written_launches"] = {k: v for k, v in kernels.LAUNCHES.items() if v}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        frame()
    frame_profile["device_kernels_launched"] = sum(
        k["count"] for k in cs.device_kernels(prof, None)[1])
    return {"sdf_frame_ms": frames}, frame_profile


def octree_mode(dev) -> tuple:
    kernels.build()
    _, (_, trainer, _) = cs.octree_app(dev)
    steps = [clock(trainer.iterate) for _ in range(40)]
    return {"octree_step_ms": steps[2:]}, step_profile(trainer)


def level8_mode(dev) -> tuple:
    kernels.build()
    _, _, trainer = cs.nglod_app("--tracker.log-dir", tempfile.mkdtemp(prefix="wisp_bench_"),
                                 "--tracker.run-name", "l8", "--blas-level",
                                 str(cs.NGLOD_L8_LEVEL))
    steps = [clock(trainer.iterate) for _ in range(40)]
    profile = cs.profile_step(trainer)
    kernels.reset_launches()
    clock(trainer.iterate)
    profile["step_launches"] = {k: v for k, v in kernels.LAUNCHES.items() if v}
    return {"level8_step_ms": steps[2:]}, profile


def spc_frame_mode(dev) -> tuple:
    from wisp_tpu_torch.accelstructs.octree_as import OctreeAS
    from wisp_tpu_torch.models.nefs.spc_field import SPCField
    from wisp_tpu_torch.models.pipeline import Pipeline
    from wisp_tpu_torch.ops.mesh.io import make_sphere_mesh
    from wisp_tpu_torch.ops.mesh.ops import sample_surface
    from wisp_tpu_torch.ops.spc.conversions import pointcloud_to_octree
    from wisp_tpu_torch.tracers.packed_spc_tracer import PackedSPCTracer
    from wisp_tpu_torch.trainers.tracker.offline_renderer import OfflineRenderer
    kernels.build()
    v, f = make_sphere_mesh(radius=cs.SPC_RADIUS, subdivisions=cs.SPC_SUBDIV)
    samples = sample_surface(v, f, cs.SPC_SAMPLES)
    codes, colors = pointcloud_to_octree(samples, cs.SPC_LEVEL,
                                         attributes=(samples + 1.0) / 2.0)
    blas = OctreeAS.from_codes(codes, device=dev)
    nef = SPCField(blas=blas, colors=colors, device=dev)
    pipeline = Pipeline(nef=nef, tracer=PackedSPCTracer(num_steps=cs.SPC_STEPS)
                        .with_free_dist(blas))
    renderer = OfflineRenderer(render_batch=cs.SPC_CHUNK, device=dev)
    rays = cs.spc_rays(dev)

    def render():
        renderer.render(pipeline, rays)

    clock(render)                                                        # warm-up
    frames = [clock(render) for _ in range(15)]
    profiles = [cs.profile_call(render) for _ in range(5)]
    frame_profile = {"wall_ms": [p[0] for p in profiles],
                     "device_busy_ms": [p[1] for p in profiles],
                     "device_idle_share": [cs.idle_share(p[1], p[0]) for p in profiles],
                     "top_device_kernels": profiles[0][2],
                     "device_kernels_launched": profiles[0][3]}
    kernels.reset_launches()
    clock(render)
    frame_profile["hand_written_launches"] = {k: v for k, v in kernels.LAUNCHES.items() if v}
    return {"spc_frame_ms": frames}, frame_profile


def step_profile(trainer) -> dict:
    """One step under torch.profiler (``chip_smoke.profile_call``): wall, device-busy ms,
    idle share, the device kernels it launched and the kernels with the most device time."""
    wall, busy, top, launched = cs.profile_call(trainer.iterate)
    return {"profile_step_ms": wall, "step_device_busy_ms": busy,
            "step_device_idle_share": cs.idle_share(busy, wall),
            "step_device_kernels": launched, "step_top_device_kernels": top}


def seg_mode(dev) -> tuple:
    kernels.build()
    trainer = cs.flagship_trainer(dev)
    tracer = trainer.pipeline.tracer
    tracer.seg_early_stop, tracer.seg_count = cs.SEG_EPS, cs.SEG_COUNT
    steps = [clock(trainer.iterate) for _ in range(40)]
    profile = step_profile(trainer)
    kernels.reset_launches()
    clock(trainer.iterate)
    profile["step_launches"] = {k: v for k, v in kernels.LAUNCHES.items() if v}
    return {"seg_step_ms": steps[2:]}, profile


def main() -> int:
    if len(sys.argv) < 2 or sys.argv[1] not in ("kernels", "paths", "sdf", "sdfframe",
                                                "octree", "l8", "spc", "seg"):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_compaction_bench: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    mode = sys.argv[1]
    profile = None
    if mode == "kernels":
        result = kernels_mode(dev)
    elif mode == "sdfframe":
        result, profile = sdf_frame_mode(dev)
    elif mode == "octree":
        result, profile = octree_mode(dev)
    elif mode == "l8":
        result, profile = level8_mode(dev)
    elif mode == "spc":
        result, profile = spc_frame_mode(dev)
    elif mode == "seg":
        result, profile = seg_mode(dev)
    else:
        result, profile = paths_mode(dev, mode == "paths")
    if mode != "kernels":
        result = {"median_ms": {k: statistics.median(v) for k, v in result.items()},
                  "all_ms": result}
    if profile is not None:
        result["profile_step" if mode in ("octree", "l8", "seg") else "profile_frame"] = profile
    print(json.dumps({"mode": mode, "label": sys.argv[2] if len(sys.argv) > 2
                      else None, "device": cs.nvidia_smi_line(), **result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
