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
   ``event_ms``. The compaction rows (K3, K6a, K12 and its mid pass) also carry their
   device launches a call (``launches_per_call``, counted by torch.profiler) and
   ``was_ms``, the time of the earlier three-pass design
   (``wisp_tpu_torch/csrc/baselines/compaction_threepass.cu``, built by this script beside
   the kernel library) on the same inputs, held exactly to the plain version first; the
   K1 forward row likewise, beside the earlier K1 design
   (``wisp_tpu_torch/csrc/baselines/hashgrid_v1.cu``, also built beside the library); the
   scatter-back row's library time is a zeroed [total + 1, C] and ``index_copy_``;
6. training path: builds the flagship-width trainer (the same config, AMP, AdamW with the
   scheduler, adaptive rays and compaction, sample-fed pruning) on a ``make_dense`` level-7
   octree and a 4-view 512x512 lego-proxy dataset (the config has 100 views: a cut of
   depth), sets the launch counts to 0, runs 20 ``MultiviewTrainer.iterate()`` steps, the
   trainer's prune, and 5 more steps, reads the counts (every kernel must have run), and
   requires finite losses that fall from steps 1-5 to steps 16-20;
7. profiles step 20 and, after the counts are read, holds each training kernel (K1, K3
   and K4 backward, K5, and the jittered march) against its plain version at the shapes
   of step 25 and times it (K1 backward beside the earlier K1 design, with its bound
   counting the whole table gradient it writes; K5 and K3's scatter-back backward, the
   one gather of colour and density, on step 25's own calls, beside their earlier
   designs ``wisp_tpu_torch/csrc/baselines/scatter_max_v1.cu`` with the cell lookup's
   PyTorch launches in front and ``scatter_back_bwd_v1.cu``, a launch a channel); the
   prune's and step 25's K1 calls are recorded for the "hashgrid" step, step 25's K5 and
   gather for the "feedback and gather" step;
8. SDF path: builds the NGLOD pipeline of app/nglod/configs/nglod_octree.yaml at full
   width on main_nglod.py's procedural icosphere (octree level 7; OctreeGrid 16 features
   x 6 LODs, 'sum'; NeuralSDF hidden 128; PackedSDFTracer 32 steps, step 0.8) with the
   sphere decoder of ``interop.sphere_sdf_decoder``, renders a warm-up frame, sets the
   counts to 0, renders one 512x512 frame and reads the counts (exactly, a chunk: K11, the
   walk, 32 sphere iterations ``sphere_iter``, the first without its step, one closing
   ``sphere_step``, the normals' 6 taps through the fused query ``octree_query_interp``;
   no K9, no K15 forward, no other kernel); checks the frame (shapes, finite, unit normals,
   alpha = hit, and the sphere's geometry), one chunk against the plain versions, then
   holds each SDF kernel against its plain version at that chunk's shapes, times it (K15's
   forward and K11 beside their earlier designs, the fused query and the sphere iteration
   beside the unfused sequences they replace), profiles a frame on the card (device-busy
   ms, idle share, the device kernels it launched) and one frame's host side (cProfile);
9. SDF training path: builds the trainer of nglod_octree.yaml at full width on the same
   octree (the config's seeded random init; OctreeSampledSDFDataset with 500,000 samples
   and 32 a voxel; batch 512, Adam, AMP), sets the counts to 0, runs 200
   ``SDFTrainer.iterate()`` steps (the 200th profiled), the trainer's ``post_epoch`` (a
   resample), 20 more steps and ``validate()``, reads the counts (each kernel's launches
   as predicted: a query, an interpolation and its backward a step, K16 once a resample
   and once a validation), requires the loss to fall and the IoUs in [0, 1], and holds K15
   backward, K16 and K9 (on validate()'s uniform points, the call that still reaches it)
   against their plain versions (depth cut: 220 steps of a 10-epoch run of ~4,400 steps an
   epoch, one resample); K16's plain version is timed by CUDA events alone (under
   torch.profiler its host cost is ~30 s);
10. octree NeRF path: parses app/nerf/configs/nerf_octree_lego_proxy.yaml through the
   port's own front end (``main_nerf.parse_args``: 4 views, checkpoints, snapshots and the
   epoch validation off) and builds it with ``main_nerf.build()`` at full width (the level-7
   octree of the scene's point cloud, OctreeGrid 4 LODs x 5, the 'voxel' march of 16
   samples in 29 voxels, RMSprop, AMP); prints the octree's sizes; sets the counts to 0,
   runs 25 ``MultiviewTrainer.iterate()`` steps (the 20th profiled) and reads the counts
   (exactly as predicted, and no other kernel); requires the loss to fall and no ray to
   overflow; runs ``validate()`` on 2 views of 256x256; renders a warm-up frame, sets the
   counts to 0, renders one 512x512 voxel frame and reads the counts (the field's fused
   query once a chunk that keeps a sample); checks the frame and one chunk against the
   plain versions; holds K7 against its plain version at the step's and a render chunk's
   shapes, with a density field and early_stop 0.01 and at an overflowing budget, and K15
   and its backward at F = 5; times K7 and profiles the frame;
11. stochastic-backward path: parses app/nerf/configs/nerf_hash_lego_proxy_stoch.yaml
   through ``main_nerf.parse_args`` as shipped but for 4 views and a temporary log dir,
   builds it, sets the counts to 0, runs 20 ``iterate()`` steps, the trainer's prune and 5
   more, reads the counts (K1's stochastic backward once a step that keeps a sample, the
   exact one never) and holds each step's LOD mask to ``stoch_lods`` at the step's budget
   rows; holds the kernel against its plain version on the last step's own coordinates
   and cotangents with injected uniforms (flips allowed only at ties within 4 ulps, and
   under 1e-4 of the draws), its own sin hash to uniformity (mean, Kolmogorov-Smirnov) and
   the mean of 256 draws to the exact backward (in units of the Monte-Carlo error); times
   it beside the exact backward, the plain version and the earlier K1 design (held by the
   same parity check); saves the pipeline ('full') and
   reloads it (one chunk rendered equal), saves the train state, resumes a second trainer
   from it and runs 5 steps of each (the losses within 1e-4 relative, the codebook within
   1e-5 of its largest entry), and renders one snapshot through the tracker's visualizer;
12. segmented-cull path: builds the flagship trainer of item 6 with ``seg_early_stop``
   1e-3 and ``seg_count`` 4 (the segmented true-transmittance cull, K6), sets the counts to
   0, runs 20 ``iterate()`` steps, the trainer's prune and 5 more (the last one's segment
   inputs recorded), reads the counts (the live compaction, the segment composite and its
   backward, the accumulated scatter-max and the shared kernels must all have run; the
   unsegmented compaction and composite never); holds K6a and K5 accumulated against their
   plain versions exactly on every segment of step 25, K6b within 1e-4 (acc_tau out 1e-5
   relative) on every segment and with a culling carry, and K6c within 1e-5 of each
   gradient's largest entry on its second segment, and times them (K6b beside its earlier
   design, ``wisp_tpu_torch/csrc/baselines/integrate_seg_v1.cu``); then, on one
   16,384-ray chunk of the render path's carved field at
   compaction 1.0, holds the segmented trace at eps 1e-20 to the unsegmented one (1e-3,
   the same valid count) and at eps 1e-3 within eps + 1e-4 in rgb, and times one 512x512
   frame with the cull and one without;
13. NGLOD app path ("nglod app"): parses app/nglod/configs/nglod_octree.yaml through the
   port's ``main_nglod.parse_args`` as shipped but for one epoch of its 10, a save at its
   end ('full') and a temporary log dir, and builds it with ``main_nglod.build()`` (the
   icosphere's level-7 octree, OctreeGrid 16 x 6 LODs, hidden 128, 500,000 samples and 32
   a voxel, batch 512); sets the counts to 0, trains the epoch (~4,400 steps, a resample)
   and validates, reads the counts; reloads the saved model with ``--pretrained
   --valid-only`` (the same IoUs on the same samples); renders the trained field's 512x512
   frame (the tracker's snapshot camera, rays shuffled by ``default_rng(0)``, chunks of
   65,536) uncompacted, at compaction 0.55 and with mid-loop compaction 0.3 at mid_at 0.5
   (counts from 0 before the three timed frames, read exactly: 32 sphere iterations and a
   closing step a loop, two loops with the mid pass, no K9, one scatter-back of every
   channel a compacted chunk and one a mid pass), holds the compacted traces to
   the uncompacted one with float32 decoders (the same hits except within SDF_HIT_MARGIN of
   min_dis, depth and normals within their tolerances; no invented hit where a chunk drops
   rays), and profiles a compacted chunk; builds ``--blas-level 8`` and runs 50 steps (the
   last profiled) and one render chunk (counts from 0 before the build: K9's search in the
   dataset's narrowband filter, the fused query's search on every step); builds the
   texture flags on the yaml, resamples and runs 50 steps (counts from 0: K17 launched);
   holds K12's compaction (both passes), its scatter-back (every channel of the last
   compacted chunk and of its mid pass, as the tracer called it; beside the earlier design,
   ``wisp_tpu_torch/csrc/baselines/scatter_rows_v1.cu``, a launch a channel), K9's search
   (with and without the ancestor chain) and K17 against their plain versions and times
   them;
14. SPC browser path ("spc browser"): builds tools/spc_render_bench.py's scene with the
   port's ``pointcloud_to_octree`` (a level-7 SPC of 1,000,000 surface samples of a
   radius-0.7, subdivision-4 icosphere, coloured by position), sets the counts to 0, makes
   the tracer's free-space field (K11, once) and renders one 512x512 orthographic frame
   through ``OfflineRenderer.render`` in chunks of 65,536 with 64 walk steps (K13 once a
   chunk, no other kernel), reads the counts; checks the frame (finite, alpha = hit, the
   sphere's hit share, rgb the hit cells' colours) and times and profiles it; sets the
   counts to 0 and raytraces one chunk through ``SPCField.grid.raytrace`` (K10 once), holds
   the walk's first hit to the DDA's (JAX's equivalence: the same hits, depth within the
   boundary nudge, first cells equal but for corner ties under 1%); holds K13 and K10 to
   their plain versions exactly and times them; times ``main_spc_browser.main`` at its
   defaults (level 6, 256x256);
15. 'uniform' path ("uniform"): parses the flagship yaml with ``--tracer.raymarch-type
   uniform`` through ``main_nerf.parse_args`` (4 views; checkpoints, snapshots and epoch
   validation off) and builds it at full width, sets the counts to 0, runs 20
   ``iterate()`` steps and renders one 512x512 frame, reads the counts (K8 once a step and
   once a chunk, K2 never; the other training kernels ran), requires the loss to fall;
   holds one chunk of the frame to the plain versions, K8 to its plain version (midpoints
   and jittered, on the trained octree and on the render path's carved field at stride
   2) and times it; then, counts from 0, runs K14 (``hashgrid_query``) once on the trained
   flagship codebook at that chunk's kept samples, holds it to its plain version exactly
   and to its earlier design (``wisp_tpu_torch/csrc/baselines/hashgrid_query_v1.cu``,
   built beside the library; the K14 row's ``was_ms``) bit for bit, there and at the
   chunk's first 65,536 kept samples, and times it at both beside both and beside
   ``index_select`` of the precomputed rows;
16. triplanar path ("triplanar"): parses app/nerf/configs/nerf_triplanar_lego_proxy.yaml
   through ``main_nerf.parse_args`` and ``build()`` at its width (a make_dense level-7
   octree; TriplanarGrid of 4 LODs from 2^5, 4 features a plane, 'sum'; hidden 64; a 'ray'
   march of 512 steps, compaction 0.5, AMP, RMSprop) with the octree path's depth cut (4
   views, no snapshots or checkpoints), sets the counts to 0, runs 25 steps (the 20th
   profiled, the 25th's K18 calls recorded), reads the counts (exactly: a step's march,
   compaction, K18 forward and backward, two scatter-backs, their gather, K4 both ways),
   requires finite losses that fall, validates on 2 views, renders a warm-up and then one
   512x512 frame (counts exactly, a chunk: K2, K3, K18 where the chunk keeps samples, two
   scatter-backs, K4), checks the frame and one chunk against the plain versions, and holds
   K18 forward (within 1e-6) and backward (within 1e-5 of the largest entry) to their plain
   versions at step 25's calls, timed, with their bounds;
17. codebook path ("codebook"): the same for app/nerf/configs/nerf_codebook_lego_proxy.yaml
   (a sparse level-7 octree of the scene's point cloud; CodebookOctreeGrid of LODs 4-7,
   F = 5, 2^4 entries, 'sum'; a 'voxel' march of 16 steps, compaction 0.0625): a step's
   K7, K3, K19's resolve, the fused query, K15's backward, K19's backward, two
   scatter-backs, their gather and K4 both ways; a frame chunk's K7, K3, K19's resolve, the
   fused query where the chunk keeps samples, two scatter-backs and K4; K19's resolve
   (E within 1e-6, a equal off the counted vertices whose two largest softmax values lie
   within an ulp) and backward (d logits and d dictionary within 1e-5 of their largest
   entries) held at step 25's calls, timed, with their bounds;
18. compaction step ("compaction"): holds both compaction kernels, and the three-pass
   design, exactly to their plain versions on the last compaction that each phase's
   tracers made (a render chunk, a training step's budget, the octree NeRF's step, the
   stoch and uniform paths', a seg segment with its carry, an SDF chunk and its mid pass),
   times each beside the three-pass design, then runs them all again back to back on one
   stream with no synchronisation between the calls and holds every result once more;
19. hash-grid step ("hashgrid"): holds K1 forward, exact and stochastic backward, and the
   earlier K1 design, to their plain versions on the K1 calls the phases recorded (a render
   chunk, train step 25 and the prune's 2,097,152 cells, the stoch step with injected
   uniforms, the seg step, the uniform chunk): the forward within 1e-5, the backward within
   1e-5 of the largest entry, the stochastic backward by ``stoch_parity`` (no flip outside
   tie rows, counts exact); times each beside the earlier design, then makes 200 calls
   back to back on one stream and holds each shape's last result to its first;
20. octree grid step ("octree grid"): holds K15's forward (within 1e-6) and K11 (exactly),
   and their earlier designs (``wisp_tpu_torch/csrc/baselines/octree_grid_v1.cu`` and
   ``free_space_v1.cu``, built beside the library; the K15 and K11 rows' ``was_ms``), to
   their plain versions on the calls the phases recorded (the SDF render chunk after the
   walk and 4 iterations, an SDF train batch, the octree NeRF's F = 5 step, the trained
   NGLOD field's frames uncompacted on permuted rays, compacted and with the mid pass, a
   level-8 chunk; K11 at levels 7 and 8), times each beside the earlier design with its
   launches and host time a call, then makes 200 calls back to back on one stream and
   holds each shape's last result equal to its first;
21. march and octree grad step ("march and octree grad"): holds K2/K8 (bit for bit) and
   K15's backward (within 1e-5 of the largest entry), and their earlier designs
   (``wisp_tpu_torch/csrc/baselines/raymarch_v1.cu`` and ``octree_grid_bwd_v1.cu``, built
   beside the library; the K2, K8 and K15 backward rows' ``was_ms``), to their plain
   versions on the calls the phases recorded (K2: the render chunk, train step 25 jittered,
   the seg and stoch steps 25; K8: the uniform chunk and uniform step 20; K15's backward:
   the octree NeRF's F = 5 call and its step 25, the SDF train batch, the last step of the
   NGLOD app's epoch and of its level-8 run), times each beside the earlier design with its
   launches and host time a call and, for K15's backward, each LOD's adds, distinct rows,
   most adds to a row and route, then makes 200 calls back to back on one stream and holds
   each shape's last result to its first;
22. mesh step ("mesh"): holds K16 and K17, and their earlier designs
   (``wisp_tpu_torch/csrc/baselines/mesh_sdf_v1.cu``, built beside the library; the K16 and
   K17 rows' ``was_ms``), to their plain versions on the calls the phases recorded (the
   SDF train phase's resample of 2.2 M points and its ``validate()``, the NGLOD texture
   dataset's resample: K16 and K17) and on the hard meshes (a cube, a thin slab, an
   L-prism and a 16-sided bipyramid whose apexes take K16's overflow path): K16's distance
   within 1e-5, a sign flip only where |d| < 1e-5 and the signs the winding number's where
   |d| >= 1e-5; K17's distance and point within 1e-6, its triangle equal but for ties
   within 2 ulp; whether each equals the plain version bit for bit; times each beside the
   earlier design with its bound and share, K16's band pairs and the points whose band
   holds more than its candidate list (from the plain arithmetic in torch), then makes 50
   calls back to back on one stream and holds each shape's last result to its first;
23. query and step folded ("query and step folded"): holds the fused query
   (``octree_query_interp``: K9 folded into K15's forward) and the sphere iteration
   (``sphere_iter``: K12's step folded in front of it) to their plain versions on the calls
   the phases recorded (the SDF render chunk, the SDF train batch with its cells, the
   octree NeRF's F = 5 step, the trained NGLOD field's frames, a level-8 chunk): features
   and rows within 1e-6, cells equal to K9's columns, t, alive and hit bit for bit; times
   each beside the unfused sequence it replaces (K9 then K15; sphere_step, the point, K9,
   K15 and the concatenation) with their launches and host time a call, then makes 200
   fused queries back to back on one stream and holds each shape's last result to its
   first;
24. walks ("walks"): holds K12's walk and K13, and their earlier design
   (``wisp_tpu_torch/csrc/baselines/sphere_trace_v1.cu``, built beside the library; the K12
   walk and K13 rows' ``was_ms``), bit for bit to their plain versions (t, alive; t, hit,
   pidx, the overflow count) on the calls the phases recorded (the SDF render chunk, the
   trained NGLOD frame's four 65,536-ray chunks, a level-8 chunk, the SPC frame's four
   chunks and one of them with a budget that runs out) and on hard rays (axis-aligned
   directions, a component of +0, -0 and +-1e-13, lengths 0.25 and 4, origins on cell
   planes, no moving axis) on the octree's field, an all-free and an all-occupied one, at
   the budget and at 0 and 1 steps; holds ``sphere_step`` and ``sphere_iter`` again on the
   sphere iterations of step 23 and ``sphere_step`` on the hard rays; times three of the
   recorded calls (the SDF render chunk and the SPC chunk are timed in their phases' rows)
   beside the earlier design with their launches, host time a call, floor (the same call at
   num_steps = 0), longest walk and time a chain step; splits a chain
   step between the field's load and the rest at the SDF and SPC chunks (the walk beside a
   probe built from an edited copy of the source whose field read hits one fixed cell, on
   uniform fields of k = 1 and k = 4, where both take the same steps); then makes 200 calls
   back to back on one stream and holds each shape's last result equal to its first;
25. scatter and segment ("scatter and segment"): holds K12's scatter-back (one launch for
   every channel) bit for bit, and its earlier design, to the plain version on the trained
   NGLOD frame's last compacted chunk (t, xyz, hit, normal) and its mid pass (t, hit), and
   K6b, and its earlier design, within 1e-4 (acc_tau out 1e-5 relative) on the seg phase's
   four segments of step 25 and on a segment with a culling carry; times each beside the
   earlier design with its launches a call and the path's launches, then makes 200 calls
   back to back on one stream and holds each call's last result equal to its first;
26. feedback and gather ("feedback and gather"): holds K5 (the cell lookup, the mask and
   the max in one launch) and K3's scatter-back backward (colour's and density's
   cotangents gathered in one launch), and their earlier designs with the launches that
   fed them (``cell_ids``; density's select-view backward), exactly to the plain versions
   on the calls that flagship train step 25 and the seg phase's step 25 made (K5 into a
   fresh grid and into the carried grid of four segments; a gather a trace or segment);
   requires one hand-written launch a call; times each beside the earlier design with the
   device kernels a call of both; reports the device kernels of the flagship's and the
   seg phase's profiled steps and the launches a step; then makes 200 calls back to back on
   one stream and holds each call's last result equal to its first;
27. prints the ``kernels`` JSON line (every kernel: launches from the render frame for the
   forward kernels, from the training run for the training kernels, from the SDF frame
   for the SDF kernels (K15's forward: 0, no path launches it), from the SDF training run
   for K9, K15's backward and K16, from the octree NeRF's 25 steps for K7, from the stoch
   path's 25 steps for K1's stochastic backward, from the segmented path's 25 steps for
   K6a, K6b, K6c and K5 accumulated, from the nglod app path's frames for K12's
   compaction, its level-8 build, steps and chunk for K9's search and its texture
   resample and steps for K17, from the SPC frame for K13 and the SPC raytrace
   for K10, from the uniform path's steps and frame for K8 and from its one query for
   K14, from the triplanar and codebook paths' 25 steps for K18 and K19, with their
   frames' launches beside), the main-path, ``train_path``, ``sdf_path``, ``sdf_train_path``,
   ``octree_nerf_path``, ``stoch_path``, ``seg_path``, ``nglod_path``, ``spc_path``,
   ``uniform_path``, ``triplanar_path`` and ``codebook_path`` JSON lines, the
   ``compaction_shapes``, ``hashgrid_shapes``,
   ``octree_grid_shapes``, ``march_grad_shapes``, ``mesh_shapes``, ``query_step_shapes``,
   ``walk_shapes``, ``scatter_seg_shapes`` and ``feedback_gather_shapes`` lines, the
   ``phase_s`` line, the nvidia-smi
   line and, last, ``{"ok":
   true, "device": {...}}``.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time
from contextlib import contextmanager
from typing import Optional
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


# profiling sessions that recorded a kernel fewer times than it was called
PROFILER_SHORTFALLS = []
# measurements for which every profiling session recorded no kernel at all: a ``timed``
# pair whose device time is then its CUDA-event time, or a profile with no idle share
PROFILER_FALLBACKS = []
PROFILER_SESSIONS = 5


def call_name(fn) -> str:
    """Where a timed or profiled call comes from, for ``PROFILER_FALLBACKS``: a function's
    file and first line, through any ``functools.partial`` around it; else its repr."""
    while isinstance(fn, functools.partial):
        fn = fn.func
    code = getattr(fn, "__code__", None)
    if code is not None:
        return f"{os.path.basename(code.co_filename)} line {code.co_firstlineno}"
    return getattr(fn, "__qualname__", None) or repr(fn)


def timed(fn, iters: int = 20, warmup: int = 3):
    """(device ms, event ms) of one call of ``fn``. The device time is the kernels' own
    device time under torch.profiler over ``iters`` calls: for each kernel its mean time a
    recorded launch times its launches a call (at least one), so that a session that
    misses some launches of a kernel still gives its time a call; the card's work alone.
    The event time brackets back-to-back calls with CUDA events; for a short kernel it
    measures the wrapper's host time instead. A profiling session now and then records no
    kernel at all; after ``PROFILER_SESSIONS`` such sessions the device time is the event
    time, and ``PROFILER_FALLBACKS`` names the function."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    event_ms = cuda_ms(fn, iters, warmup)
    for _ in range(PROFILER_SESSIONS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        _, recorded = device_kernels(prof, None)
        if recorded:
            short = [(k["name"], k["count"]) for k in recorded if k["count"] % iters]
            if short:
                PROFILER_SHORTFALLS.append({"iters": iters, "kernels": short})
            ms = sum(k["ms"] / k["count"] * max(1, round(k["count"] / iters))
                     for k in recorded)
            return ms, event_ms
    PROFILER_FALLBACKS.append({"timed": call_name(fn), "device_ms": "event time"})
    return event_ms, event_ms


def events_only(fn, iters: int = 20, warmup: int = 3):
    """``timed``'s pair for a slow plain version, from CUDA events alone: (event ms, event
    ms)."""
    ms = cuda_ms(fn, iters, warmup)
    return ms, ms


def launches_per_call(fn, iters: int = 10) -> Optional[int]:
    """The device kernels (memsets and copies included) that one call of ``fn`` launches,
    counted by torch.profiler: the most of 3 sessions, since a session may miss launches;
    None if none recorded a kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    best = None
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        _, recorded = device_kernels(prof, None)
        if recorded:
            n = round(sum(k["count"] for k in recorded) / iters)
            best = n if best is None else max(best, n)
    return best


# -- the earlier designs, the yardsticks of the redesigned rows' "was_ms" --------------------
THREEPASS_SRC = "wisp_tpu_torch/csrc/baselines/compaction_threepass.cu"
THREEPASS = None               # a ThreePass once built (run())
THREEPASS_DESIGN = "csrc/baselines/compaction_threepass.cu (three-pass; K12 four)"
HASHGRID_V1_SRC = "wisp_tpu_torch/csrc/baselines/hashgrid_v1.cu"
HASHGRID_V1 = None             # a HashGridV1 once built (run())
HASHGRID_V1_DESIGN = ("csrc/baselines/hashgrid_v1.cu (a thread a (sample, LOD); scalar "
                      "atomics)")
HASHGRID_QUERY_V1_SRC = "wisp_tpu_torch/csrc/baselines/hashgrid_query_v1.cu"
HASHGRID_QUERY_V1 = None       # a HashGridQueryV1 once built (run())
HASHGRID_QUERY_V1_DESIGN = ("csrc/baselines/hashgrid_query_v1.cu (a thread a (point, LOD, "
                            "corner) with 64-bit divisions; scalar stores)")
OCTREE_GRID_V1_SRC = "wisp_tpu_torch/csrc/baselines/octree_grid_v1.cu"
FREE_SPACE_V1_SRC = "wisp_tpu_torch/csrc/baselines/free_space_v1.cu"
OCTREE_V1 = None               # an OctreeV1 once built (run())
OCTREE_V1_DESIGN = {
    "octree_interp": "csrc/baselines/octree_grid_v1.cu (a thread a (point, feature), the "
                     "LODs' dependent loads one LOD after another)",
    "free_space_distance": "csrc/baselines/free_space_v1.cu (three byte passes of a thread "
                           "a cell)"}


RAYMARCH_V1_SRC = "wisp_tpu_torch/csrc/baselines/raymarch_v1.cu"
OCTREE_GRID_BWD_V1_SRC = "wisp_tpu_torch/csrc/baselines/octree_grid_bwd_v1.cu"
MARCH_GRAD_V1 = None           # a MarchGradV1 once built (run())
MARCH_GRAD_V1_DESIGN = {
    "march": "csrc/baselines/raymarch_v1.cu (a thread a (ray, strided sample), each with its "
             "ray's slab test; scalar stores)",
    "octree_interp_bwd": "csrc/baselines/octree_grid_bwd_v1.cu (a thread a (point, feature), "
                         "the LODs in series, a scalar atomic an add; a zero fill a LOD)"}

MESH_V1_SRC = "wisp_tpu_torch/csrc/baselines/mesh_sdf_v1.cu"
MESH_V1 = None                 # a MeshV1 once built (run())
MESH_V1_DESIGN = ("csrc/baselines/mesh_sdf_v1.cu (a thread a point; K16 in two passes; "
                  "the triangle's terms and six IEEE divisions made for every pair)")

SPHERE_TRACE_V1_SRC = "wisp_tpu_torch/csrc/baselines/sphere_trace_v1.cu"
SPHERE_TRACE_V1 = None         # a WalkDesign once built (run())
SPHERE_TRACE_V1_DESIGN = ("csrc/baselines/sphere_trace_v1.cu (a thread a ray; six IEEE "
                          "divisions and four floors a step whatever k is; K13: a float "
                          "atomic an overflowing ray)")
# the walk variant of the "walks" step: the library's sphere_trace.cu with its walker's
# field read pointed at one fixed cell (an opaque zero ANDed into the cell's index keeps
# the address on the chain), built from an edited copy into its own library
WALK_PROBE_READ = "    return __ldg(free_dist + cell(qx, qy, qz));"
WALK_PROBE_EDIT = ("    unsigned zero;\n"
                   "    asm volatile(\"mov.u32 %0, 0;\" : \"=r\"(zero));\n"
                   "    return __ldg(free_dist + (cell(qx, qy, qz) & zero));")
WALK_PROBE = None              # a WalkDesign once built (run())

SCATTER_ROWS_V1_SRC = "wisp_tpu_torch/csrc/baselines/scatter_rows_v1.cu"
INTEGRATE_SEG_V1_SRC = "wisp_tpu_torch/csrc/baselines/integrate_seg_v1.cu"
SCATTER_SEG_V1 = None          # a ScatterSegV1 once built (run())
SCATTER_SEG_V1_DESIGN = {
    "scatter_rows": "csrc/baselines/scatter_rows_v1.cu (a launch a channel; a thread a "
                    "(slot, 4-byte word) or (slot, byte), each reading the slot's index)",
    "integrate_seg_fwd": "csrc/baselines/integrate_seg_v1.cu (K4's forward with the carry: "
                         "a step a lane, 32 steps a dependent round; 4 rounds at S = 128)"}

SCATTER_MAX_V1_SRC = "wisp_tpu_torch/csrc/baselines/scatter_max_v1.cu"
SCATTER_BACK_BWD_V1_SRC = "wisp_tpu_torch/csrc/baselines/scatter_back_bwd_v1.cu"
FEEDBACK_GATHER_V1 = None      # a FeedbackGatherV1 once built (run())
FEEDBACK_GATHER_V1_DESIGN = {
    "scatter_max": "csrc/baselines/scatter_max_v1.cu (ready int64 ids; the cell lookup in "
                   "front as PyTorch's cell_ids, and torch.where on the mask)",
    "scatter_back_bwd": "csrc/baselines/scatter_back_bwd_v1.cu (a launch a channel, a thread "
                        "a (slot, column) with a 64-bit division; density's cotangent through "
                        "the select view's backward, a zero fill and a copy)"}


def start_walk_probe_build():
    """Start nvcc on the walk probe: edited copies of ``csrc/sphere_trace.cu`` and
    ``csrc/sphere_walker.cuh`` side by side (the copy's include finds the edited header
    first); (library path, process)."""
    from wisp_tpu_torch import kernels
    walker = (kernels.CSRC / "sphere_walker.cuh").read_text()
    require(walker.count(WALK_PROBE_READ) == 1,
            "the walk probe's edit no longer matches csrc/sphere_walker.cuh")
    out_dir = kernels.BUILD_ROOT / "walk_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "sphere_walker.cuh").write_text(walker.replace(WALK_PROBE_READ,
                                                              WALK_PROBE_EDIT))
    src = out_dir / "sphere_trace.cu"
    src.write_text((kernels.CSRC / "sphere_trace.cu").read_text())
    return start_baseline_build(str(src), "libwisp_walk_probe.so")


def start_baseline_build(src: str, lib: str):
    """Start nvcc on an earlier design's source (built beside, not into, the kernel
    library); (library path, process)."""
    from wisp_tpu_torch import kernels
    out = kernels.BUILD_ROOT / "baselines" / lib
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-I", str(kernels.CSRC), src, "-o",
           str(out)]
    return out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                 text=True)


def finish_baseline_build(started, src: str):
    """The loaded library of ``start_baseline_build``, once nvcc is done."""
    import ctypes
    out, proc = started
    log, _ = proc.communicate()
    require(proc.returncode == 0, f"nvcc failed for {src}:\n{log}")
    return ctypes.CDLL(str(out))


class ThreePass:
    """The earlier design of ``compact`` and ``compact_rays`` (three and four launches),
    called on the current stream with the wrappers' arguments; its launches are not the
    port's and are not counted."""

    def __init__(self, started):
        import ctypes
        P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        self.lib = finish_baseline_build(started, THREEPASS_SRC)
        self.lib.wisp_compact_threepass.argtypes = [P, P, F, P, P, I, I, L, P, P, P, P, P, P,
                                                    P]
        self.lib.wisp_compact_rays_threepass.argtypes = [P, I, L, P, P, P, P, P, P, P, P, P,
                                                         P, P, P, P]

    @staticmethod
    def _stream() -> int:
        import torch
        return torch.cuda.current_stream().cuda_stream

    def compact(self, mask, samples, dirs, budget, acc_tau=None, tau_cap=None):
        import torch
        r, s = mask.shape
        nb = -(-r * s // 4096)
        scratch = torch.empty((2 * nb,), dtype=torch.int32, device=mask.device)
        count = torch.empty((), dtype=torch.int64, device=mask.device)
        idx = torch.empty((budget,), dtype=torch.int64, device=mask.device)
        cflat = torch.empty((budget, 3), dtype=torch.float32, device=mask.device)
        cray_d = torch.empty((budget, 3), dtype=torch.float32, device=mask.device)
        status = self.lib.wisp_compact_threepass(
            mask.data_ptr(), None if acc_tau is None else acc_tau.data_ptr(),
            0.0 if tau_cap is None else float(tau_cap), samples.data_ptr(), dirs.data_ptr(),
            r, s, budget, scratch.data_ptr(), scratch[nb:].data_ptr(), count.data_ptr(),
            idx.data_ptr(), cflat.data_ptr(), cray_d.data_ptr(), self._stream())
        require(status == 0, f"wisp_compact_threepass failed to launch ({status})")
        return idx, cflat, cray_d, count

    def compact_rays(self, mask, budget, o, d, t, tf):
        import torch
        r = mask.shape[0]
        nb = -(-r // 4096)
        dev = mask.device
        scratch = torch.empty((2 * nb,), dtype=torch.int32, device=dev)
        count = torch.empty((), dtype=torch.int64, device=dev)
        idx = torch.empty((budget,), dtype=torch.int64, device=dev)
        o_c, d_c = (torch.empty((budget, 3), dtype=torch.float32, device=dev) for _ in "od")
        t_c, tf_c = (torch.empty((budget,), dtype=torch.float32, device=dev) for _ in "tf")
        status = self.lib.wisp_compact_rays_threepass(
            mask.data_ptr(), r, budget, o.data_ptr(), d.data_ptr(), t.data_ptr(),
            tf.data_ptr(), scratch.data_ptr(), scratch[nb:].data_ptr(), count.data_ptr(),
            idx.data_ptr(), o_c.data_ptr(), d_c.data_ptr(), t_c.data_ptr(), tf_c.data_ptr(),
            self._stream())
        require(status == 0, f"wisp_compact_rays_threepass failed to launch ({status})")
        return idx, o_c, d_c, t_c, tf_c, count


class HashGridV1:
    """The earlier design of K1 forward and backward, exact and stochastic (one thread a
    (sample, LOD), scalar atomics), called on the current stream with a wrapper's geometry
    (``grid._lod_args``); its launches are not the port's and are not counted."""

    def __init__(self, started):
        import ctypes
        P, I, L, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint32
        self.lib = finish_baseline_build(started, HASHGRID_V1_SRC)
        self.lib.wisp_hashgrid_v1_fwd.argtypes = [P, P, L, I, I, I, I, P, P, P, P, P, U, P, P]
        self.lib.wisp_hashgrid_v1_bwd.argtypes = [P, P, P, P, L, I, I, I, I, P, P, P, P, P, P,
                                                  U, P, P]

    def fwd(self, coords, table, geometry):
        import torch
        dim, f_dim, n_lods, out_lods, codebook_size, arrays = geometry
        n = coords.shape[0]
        out = torch.empty((n, out_lods * f_dim), dtype=torch.float32, device=coords.device)
        if n:
            status = self.lib.wisp_hashgrid_v1_fwd(
                coords.data_ptr(), table.data_ptr(), n, dim, f_dim, n_lods, out_lods,
                *(a.ctypes.data for a in arrays), codebook_size, out.data_ptr(),
                ThreePass._stream())
            require(status == 0, f"wisp_hashgrid_v1_fwd failed to launch ({status})")
        return out

    def bwd(self, coords, grad_out, geometry, table_rows, stoch_mask=None, u0=None):
        import numpy as np
        import torch
        dim, f_dim, n_lods, out_lods, codebook_size, arrays = geometry
        n = coords.shape[0]
        grad = torch.zeros((table_rows, f_dim), dtype=torch.float32, device=coords.device)
        flags = None if stoch_mask is None else \
            np.asarray([int(bool(stoch_mask[i])) for i in range(n_lods)], np.int32)
        if n:
            status = self.lib.wisp_hashgrid_v1_bwd(
                coords.data_ptr(), grad_out.data_ptr(), None if u0 is None else u0.data_ptr(),
                None, n, dim, f_dim, n_lods, out_lods, *(a.ctypes.data for a in arrays),
                None if flags is None else flags.ctypes.data, codebook_size, grad.data_ptr(),
                ThreePass._stream())
            require(status == 0, f"wisp_hashgrid_v1_bwd failed to launch ({status})")
        return grad

    def hashgrid(self, coords, resolutions, bitwidth, lod_idx, table, first, sizes,
                 out_lods=None):
        """``grid.hashgrid``'s forward with this design."""
        return self.fwd(coords, table, k1_geometry(coords, table, (
            resolutions, bitwidth, lod_idx, None, first, sizes), out_lods))

    def hashgrid_bwd(self, coords, grad_out, resolutions, bitwidth, lod_idx, table_rows, first,
                     sizes, out_lods=None, stoch_mask=None, u0=None):
        """``grid.hashgrid_bwd`` with this design."""
        import torch
        f_dim = grad_out.shape[1] // (out_lods if out_lods is not None else lod_idx + 1)
        rows = torch.empty((table_rows, f_dim), dtype=torch.float32, device=coords.device)
        geometry = k1_geometry(coords, rows, (resolutions, bitwidth, lod_idx, table_rows, first,
                                              sizes), out_lods)
        return self.bwd(coords, grad_out, geometry, table_rows, stoch_mask, u0)


class HashGridQueryV1:
    """The earlier design of K14 (a thread a (point, LOD, corner)), called on the current
    stream with ``hashgrid_query``'s arguments; its launches are not the port's and are not
    counted."""

    def __init__(self, started):
        import ctypes
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        self.lib = finish_baseline_build(started, HASHGRID_QUERY_V1_SRC)
        self.lib.wisp_hashgrid_query_v1.argtypes = [P, P, L, I, I, I, P, P, P, P, P,
                                                    ctypes.c_uint32, P, P]

    def query(self, coords, *args):
        """``grid.hashgrid_query`` with this design."""
        import torch
        from wisp_tpu_torch.ops.grid import query_args
        n, dim, f_dim, n_lods, codebook_size, arrays = query_args(coords, *args)
        out = torch.empty((n, n_lods, 2 ** dim, f_dim), dtype=torch.float32,
                          device=coords.device)
        if n:
            status = self.lib.wisp_hashgrid_query_v1(
                coords.data_ptr(), args[3].data_ptr(), n, dim, f_dim, n_lods,
                *(a.ctypes.data for a in arrays), codebook_size, out.data_ptr(),
                ThreePass._stream())
            require(status == 0, f"wisp_hashgrid_query_v1 failed to launch ({status})")
        return out


class OctreeV1:
    """The earlier designs of K15's forward and of K11, called on the current stream with
    their wrappers' arguments and the host work of the earlier K15 wrapper (its checks, and
    its pointer and level arrays built at every call); their launches are not the port's
    and are not counted."""

    def __init__(self, started_interp, started_fsd):
        import ctypes
        import numpy as np
        import torch
        from wisp_tpu_torch import kernels
        from wisp_tpu_torch.accelstructs.octree_as import free_space_cap
        from wisp_tpu_torch.models.grids.octree_grid import _check_geometry
        # resolved once, so that a call's host time is the earlier wrapper's own
        self.np, self.torch, self.kernels, self.ctypes = np, torch, kernels, ctypes
        self.free_space_cap, self.check_geometry = free_space_cap, _check_geometry
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        self.interp_lib = finish_baseline_build(started_interp, OCTREE_GRID_V1_SRC)
        self.interp_lib.wisp_octree_interp_v1.argtypes = [P, P, L, I, I, I, I, P, P, P, I, P,
                                                          P]
        self.fsd_lib = finish_baseline_build(started_fsd, FREE_SPACE_V1_SRC)
        self.fsd_lib.wisp_free_space_distance_v1.argtypes = [P, I, I, P, P, P]

    def _stream(self) -> int:
        """The raw current stream, as ``kernels.launch`` reads it."""
        return self.torch._C._cuda_getCurrentRawStream(self.torch._C._cuda_getDevice())

    def interp(self, coords, pidx, col0, trinkets, features, levels, multiscale_type="sum"):
        """``octree_interp``'s forward with this design."""
        ctypes, np, torch, kernels = self.ctypes, self.np, self.torch, self.kernels
        f_dim = features[0].shape[1]
        n, n_lods = self.check_geometry(coords, pidx, col0, trinkets, levels, multiscale_type)
        for i in range(n_lods):
            kernels.check(features[i], f"features[{i}]", torch.float32, (None, f_dim))
        out = torch.empty((n, f_dim if multiscale_type == "sum" else f_dim * n_lods),
                          dtype=torch.float32, device=coords.device)
        if n:
            trk, fts = kernels.pointers(trinkets), kernels.pointers(features)
            lvl = np.asarray(levels, dtype=np.int32)
            status = self.interp_lib.wisp_octree_interp_v1(
                coords.data_ptr(), pidx.data_ptr(), n, pidx.shape[1], int(col0), n_lods,
                f_dim, ctypes.addressof(trk), ctypes.addressof(fts), lvl.ctypes.data,
                int(multiscale_type == "sum"), out.data_ptr(), self._stream())
            require(status == 0, f"wisp_octree_interp_v1 failed to launch ({status})")
        return out

    def free_space(self, occ, level, max_k=31):
        """``free_space_distance`` with this design."""
        torch, free_space_cap = self.torch, self.free_space_cap
        res = 2 ** level
        scratch = torch.empty((2, res ** 3), dtype=torch.uint8, device=occ.device)
        out = torch.empty((res ** 3,), dtype=torch.int32, device=occ.device)
        status = self.fsd_lib.wisp_free_space_distance_v1(
            occ.data_ptr(), level, free_space_cap(max_k), scratch.data_ptr(), out.data_ptr(),
            self._stream())
        require(status == 0, f"wisp_free_space_distance_v1 failed to launch ({status})")
        return out


class WalkDesign:
    """K12's walk and K13 from another library than the port's (the earlier design,
    ``baselines/sphere_trace_v1.cu``, entry points ending in "_v1"; or the walk probe, the
    library's names), called on the current stream with their wrappers' arguments; their
    launches are not the port's and are not counted."""

    def __init__(self, lib, suffix: str):
        import ctypes
        P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        self.walk = getattr(lib, f"wisp_sdf_walk{suffix}")
        self.walk.argtypes = [P, P, P, P, P, P, L, I, I, P]
        self.trace = getattr(lib, f"wisp_spc_trace{suffix}")
        self.trace.argtypes = [P, P, L, F, F, P, P, I, I, I, P, L, P, P, P, P, P]

    @staticmethod
    def _stream() -> int:
        import torch
        return torch.cuda.current_stream().cuda_stream

    def sdf_walk(self, o, d, t, alive, t_far, free_dist, level, num_steps):
        """``sdf_walk`` with this library, in place."""
        status = self.walk(o.data_ptr(), d.data_ptr(), t.data_ptr(), alive.data_ptr(),
                           t_far.data_ptr(), free_dist.data_ptr(), o.shape[0], int(level),
                           int(num_steps), self._stream())
        require(status == 0, f"sdf_walk ({self.walk.__name__}) failed to launch ({status})")

    def spc_trace(self, o, d, dist_min, dist_max, free_dist, occ_grid, route, level,
                  num_steps):
        """``spc_trace`` with this library: (t, hit, pidx, num_overflow)."""
        import torch
        from wisp_tpu_torch.accelstructs.octree_as import route_args
        n, dev = o.shape[0], o.device
        code, table, length = route_args(route, level, "route")
        t = torch.empty((n,), dtype=torch.float32, device=dev)
        hit = torch.empty((n,), dtype=torch.bool, device=dev)
        pidx = torch.empty((n,), dtype=torch.int32, device=dev)
        over = torch.zeros((), dtype=torch.float32, device=dev)
        status = self.trace(o.data_ptr(), d.data_ptr(), n, float(dist_min), float(dist_max),
                            free_dist.data_ptr(),
                            None if occ_grid is None else occ_grid.data_ptr(), int(level),
                            int(num_steps), code, table, length, t.data_ptr(),
                            hit.data_ptr(), pidx.data_ptr(), over.data_ptr(), self._stream())
        require(status == 0,
                f"spc_trace ({self.trace.__name__}) failed to launch ({status})")
        return t, hit, pidx, over


class MarchGradV1:
    """The earlier designs of K2/K8 (``wisp_raymarch_ray``) and of K15's backward, called on
    the current stream with their wrappers' arguments (K2/K8: ``octree_as._march``'s after
    its counter) and the earlier wrappers' host work (K15's backward: a zero fill a LOD);
    their launches are not the port's and are not counted."""

    def __init__(self, started_march, started_bwd):
        import ctypes
        import numpy as np
        import torch
        from wisp_tpu_torch import kernels
        from wisp_tpu_torch.accelstructs.base_as import ASRaymarchResults
        from wisp_tpu_torch.models.grids.octree_grid import _check_geometry
        self.np, self.torch, self.kernels, self.ctypes = np, torch, kernels, ctypes
        self.results, self.check_geometry = ASRaymarchResults, _check_geometry
        self.march_lib = finish_baseline_build(started_march, RAYMARCH_V1_SRC)
        self.march_lib.wisp_raymarch_ray_v1.argtypes = \
            kernels._SIGNATURES["wisp_raymarch_ray"]
        self.bwd_lib = finish_baseline_build(started_bwd, OCTREE_GRID_BWD_V1_SRC)
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        self.bwd_lib.wisp_octree_interp_bwd_v1.argtypes = [P, P, L, I, I, I, I, P, P, P, I,
                                                           P, P]

    def _stream(self) -> int:
        return self.torch._C._cuda_getCurrentRawStream(self.torch._C._cuda_getDevice())

    def march(self, origins, dirs, dist_min, dist_max, num_samples, stride, cell_density,
              level, jitter, ustep):
        """``octree_as._march`` with this design."""
        torch = self.torch
        n, s, dev = origins.shape[0], int(num_samples), origins.device
        samples = torch.empty((n, s, 3), dtype=torch.float32, device=dev)
        depths = torch.empty((n, s), dtype=torch.float32, device=dev)
        mask = torch.empty((n, s), dtype=torch.bool, device=dev)
        dens = (torch.empty((n, s), dtype=torch.float32, device=dev)
                if cell_density is not None else None)
        deltas = torch.empty((n, 1), dtype=torch.float32, device=dev)
        ptr = self.kernels.ptr
        status = self.march_lib.wisp_raymarch_ray_v1(
            origins.data_ptr(), dirs.data_ptr(), ptr(jitter), n, s, int(stride), float(ustep),
            float(dist_min), float(dist_max), ptr(cell_density), int(level),
            samples.data_ptr(), depths.data_ptr(), mask.data_ptr(), ptr(dens),
            deltas.data_ptr(), self._stream())
        require(status == 0, f"wisp_raymarch_ray_v1 failed to launch ({status})")
        return self.results(samples=samples, depth_samples=depths, deltas=deltas, mask=mask,
                            cell_density=dens)

    def interp_bwd(self, coords, pidx, col0, trinkets, rows, f_dim, levels, multiscale_type,
                   grad_out):
        """``octree_interp_bwd`` with this design."""
        ctypes, np, torch, kernels = self.ctypes, self.np, self.torch, self.kernels
        n, n_lods = self.check_geometry(coords, pidx, col0, trinkets, levels, multiscale_type)
        grads = [torch.zeros((v, f_dim), dtype=torch.float32, device=coords.device)
                 for v in rows]
        if n:
            trk, gps = kernels.pointers(trinkets), kernels.pointers(grads)
            lvl = np.asarray(levels, dtype=np.int32)
            status = self.bwd_lib.wisp_octree_interp_bwd_v1(
                coords.data_ptr(), pidx.data_ptr(), n, pidx.shape[1], int(col0), n_lods,
                f_dim, ctypes.addressof(trk), ctypes.addressof(gps), lvl.ctypes.data,
                int(multiscale_type == "sum"), grad_out.data_ptr(), self._stream())
            require(status == 0, f"wisp_octree_interp_bwd_v1 failed to launch ({status})")
        return grads


class MeshV1:
    """The earlier design of K16 (``mesh_sdf``) and K17 (``closest_point``), called on the
    current stream with their wrappers' arguments; its launches are not the port's and are
    not counted."""

    def __init__(self, started):
        import torch
        from wisp_tpu_torch import kernels
        self.torch = torch
        self.lib = finish_baseline_build(started, MESH_V1_SRC)
        self.lib.wisp_mesh_sdf_v1.argtypes = kernels._SIGNATURES["wisp_mesh_sdf"]
        self.lib.wisp_closest_point_v1.argtypes = kernels._SIGNATURES["wisp_closest_point"]

    def _stream(self) -> int:
        return self.torch._C._cuda_getCurrentRawStream(self.torch._C._cuda_getDevice())

    def mesh_sdf(self, points, tris):
        """``mesh_sdf`` with this design."""
        n = points.shape[0]
        out = self.torch.empty((n,), dtype=self.torch.float32, device=points.device)
        if n:
            status = self.lib.wisp_mesh_sdf_v1(points.data_ptr(), n, tris.data_ptr(),
                                               tris.shape[0], out.data_ptr(), self._stream())
            require(status == 0, f"wisp_mesh_sdf_v1 failed to launch ({status})")
        return out

    def closest_point(self, points, tris):
        """``closest_point`` with this design."""
        torch, n, dev = self.torch, points.shape[0], points.device
        dist = torch.empty((n,), dtype=torch.float32, device=dev)
        nearest = torch.empty((n, 3), dtype=torch.float32, device=dev)
        tidx = torch.empty((n,), dtype=torch.int64, device=dev)
        if n:
            status = self.lib.wisp_closest_point_v1(
                points.data_ptr(), n, tris.data_ptr(), tris.shape[0], dist.data_ptr(),
                nearest.data_ptr(), tidx.data_ptr(), self._stream())
            require(status == 0, f"wisp_closest_point_v1 failed to launch ({status})")
        return dist, nearest, tidx

class ScatterSegV1:
    """The earlier designs of K12's scatter-back (a launch a channel) and of K6b, called on
    the current stream with their wrappers' arguments; their launches are not the port's
    and are not counted."""

    def __init__(self, started_scatter, started_seg):
        import ctypes
        import torch
        from wisp_tpu_torch import kernels
        self.torch, self.kernels = torch, kernels
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        self.scatter_lib = finish_baseline_build(started_scatter, SCATTER_ROWS_V1_SRC)
        self.scatter_lib.wisp_scatter_rows_v1.argtypes = [P, P, L, I, L, P, P]
        self.seg_lib = finish_baseline_build(started_seg, INTEGRATE_SEG_V1_SRC)
        self.seg_lib.wisp_integrate_seg_fwd_v1.argtypes = \
            kernels._SIGNATURES["wisp_integrate_seg_fwd"]

    def _stream(self) -> int:
        return self.torch._C._cuda_getCurrentRawStream(self.torch._C._cuda_getDevice())

    def scatter_rows_many(self, idx, pairs, mid=False):
        """``scatter_rows_many`` as the earlier design's launch a channel."""
        import math
        for v, out in pairs:
            k, row_bytes = v.shape[0], math.prod(v.shape[1:]) * v.element_size()
            if k and row_bytes:
                status = self.scatter_lib.wisp_scatter_rows_v1(
                    v.data_ptr(), idx.data_ptr(), k, row_bytes, out.shape[0], out.data_ptr(),
                    self._stream())
                require(status == 0, f"wisp_scatter_rows_v1 failed to launch ({status})")
        return [out for _, out in pairs]

    def integrate_segment(self, density, deltas, depths, mask, color, acc_tau, extra=None,
                          with_depth=True):
        """``integrate_segment``'s forward with the earlier design."""
        torch, ptr = self.torch, self.kernels.ptr
        r, s = density.shape
        ce = 0 if extra is None else extra.shape[-1]
        new = functools.partial(torch.empty, dtype=torch.float32, device=density.device)
        out = {"rgb": new((r, 3)), "alpha": new((r, 1)), "acc_tau": new((r,))}
        if with_depth:
            out["depth"] = new((r, 1))
        if extra is not None:
            out["extra"] = new((r, ce))
        status = self.seg_lib.wisp_integrate_seg_fwd_v1(
            density.data_ptr(), deltas.data_ptr(), depths.data_ptr(), mask.data_ptr(),
            color.data_ptr(), ptr(extra), acc_tau.data_ptr(), r, s, ce, out["rgb"].data_ptr(),
            out["alpha"].data_ptr(), ptr(out.get("depth")), ptr(out.get("extra")),
            out["acc_tau"].data_ptr(), self._stream())
        require(status == 0, f"wisp_integrate_seg_fwd_v1 failed to launch ({status})")
        return out


class FeedbackGatherV1:
    """The earlier designs of K5 (keyed by ready ids) and of K3's scatter-back backward (a
    launch a channel), called on the current stream with the launches in front of them that
    the path made for them (K5: ``cell_ids`` and, with a mask, ``torch.where``; the
    backward: density's select view undone by a zero fill and a copy); their launches are
    not the port's and are not counted."""

    def __init__(self, started_max, started_bwd):
        import ctypes
        import torch
        self.torch = torch
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        self.max_lib = finish_baseline_build(started_max, SCATTER_MAX_V1_SRC)
        self.max_lib.wisp_scatter_max_v1.argtypes = [P, P, L, L, P, P]
        self.bwd_lib = finish_baseline_build(started_bwd, SCATTER_BACK_BWD_V1_SRC)
        self.bwd_lib.wisp_scatter_back_bwd_v1.argtypes = [P, P, L, I, L, P, P]

    def _stream(self) -> int:
        return self.torch._C._cuda_getCurrentRawStream(self.torch._C._cuda_getDevice())

    def scatter_max_points(self, points, density, level, out=None, keep=None):
        """``scatter_max_points`` as the earlier path computed it: ``cell_ids``, the mask's
        ``torch.where``, the density as a contiguous float32 column, then the kernel."""
        torch = self.torch
        from wisp_tpu_torch.ops.density_grid import cell_ids
        size = 8 ** level
        ids = cell_ids(points, level)
        if keep is not None:
            ids = torch.where(keep, ids, size)
        values = density.float().contiguous()
        grid = torch.zeros((size,), dtype=torch.float32, device=points.device) \
            if out is None else out
        if ids.numel():
            status = self.max_lib.wisp_scatter_max_v1(ids.data_ptr(), values.data_ptr(),
                                                      ids.numel(), size, grid.data_ptr(),
                                                      self._stream())
            require(status == 0, f"wisp_scatter_max_v1 failed to launch ({status})")
        return grid

    def scatter_back_bwd_many(self, grads, idx, k):
        """The gather of each channel's cotangent with the earlier design's launch a channel;
        a flat cotangent (density's) first goes through the select view's backward."""
        torch = self.torch
        outs = []
        for g in grads:
            if g.ndim == 1:
                z = torch.zeros((g.shape[0], 1), dtype=g.dtype, device=g.device)
                z.select(-1, 0).copy_(g)
                g = z
            out = torch.empty((k, g.shape[1]), dtype=torch.float32, device=g.device)
            if k:
                status = self.bwd_lib.wisp_scatter_back_bwd_v1(
                    g.data_ptr(), idx.data_ptr(), k, g.shape[1], g.shape[0], out.data_ptr(),
                    self._stream())
                require(status == 0, f"wisp_scatter_back_bwd_v1 failed to launch ({status})")
            outs.append(out)
        return outs


def march_equal(got, want) -> bool:
    """K2/K8's contract: points, depths, deltas, mask and densities bit for bit."""
    import torch
    same = all(torch.equal(getattr(got, k), getattr(want, k))
               for k in ("samples", "depth_samples", "deltas", "mask"))
    if (got.cell_density is None) != (want.cell_density is None):
        return False
    return same and (want.cell_density is None
                     or torch.equal(got.cell_density, want.cell_density))


def k1_geometry(coords, table, args, out_lods):
    """The K1 wrappers' geometry (``grid._lod_args``) of a call with ``args`` = (resolutions,
    bitwidth, lod_idx, table or its rows, first, sizes); ``table`` is any [rows, F] tensor
    of the table's shape."""
    from wisp_tpu_torch.ops import grid as grid_ops
    return grid_ops._lod_args(coords, table, args[0], args[1], args[2], args[4], args[5],
                              out_lods)


def compact_equal(got, want, budget) -> bool:
    """``compact``'s contract: the same count and the same first min(count, budget) slots."""
    import torch
    kept = min(int(want[3]), budget)
    return torch.equal(got[3], want[3]) and all(torch.equal(a[:kept], b[:kept])
                                                for a, b in zip(got[:3], want[:3]))


def rays_equal(got, want) -> bool:
    """``compact_rays``'s contract: every slot and the count equal."""
    import torch
    return all(torch.equal(a, b) for a, b in zip(got, want))


def add_launches_and_was(row, fn, was_fn, check_was, design=THREEPASS_DESIGN):
    """The row's launches a call (``fn``'s, and the earlier design's) and ``was_ms``, the
    earlier ``design``'s time on the same inputs, held to the plain version first
    (``check_was``). ``was_fn`` is None where that design was not built."""
    row["launches_per_call"] = launches_per_call(fn)
    if was_fn is None:
        return row
    require(check_was(), f"{row['name']}: the earlier design ({design}) differs from the "
                         f"plain version")
    was = timed(was_fn)
    row.update(was_ms=was[0], was_event_ms=was[1],
               was_launches_per_call=launches_per_call(was_fn), was_design=design)
    return row


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
    """Route the NeRF tracer's kernel calls (both marches, both grids) to the plain PyTorch
    versions (on the card)."""
    from wisp_tpu_torch.accelstructs import octree_as
    from wisp_tpu_torch.ops import compaction, grid, integration
    from wisp_tpu_torch.tracers import packed_rf_tracer
    from wisp_tpu_torch.models.grids import octree_grid

    def hashgrid_plain(*args, stoch_grad=False, dense_lod_matmul=None, stoch_rows=None, **kw):
        return grid.hashgrid_plain(*args, **kw)      # the backward's options: no gradient here

    with mock.patch.object(octree_as, "raymarch_ray", octree_as.raymarch_ray_plain), \
            mock.patch.object(octree_as, "raymarch_voxel", octree_as.raymarch_voxel_plain), \
            mock.patch.object(octree_grid, "octree_query_interp", query_interp_plain), \
            mock.patch.object(grid, "hashgrid", hashgrid_plain), \
            mock.patch.object(packed_rf_tracer, "compact", compaction.compact_plain), \
            mock.patch.object(packed_rf_tracer, "scatter_back",
                              compaction.scatter_back_plain), \
            mock.patch.object(packed_rf_tracer, "scatter_back_many",
                              compaction.scatter_back_many_plain), \
            mock.patch.object(packed_rf_tracer, "integrate", integration.integrate_plain):
        yield


def query_interp_plain(*args):
    """``octree_query_interp``'s plain version with its signature (features alone)."""
    from wisp_tpu_torch.models.grids.octree_grid import octree_query_interp_plain
    return octree_query_interp_plain(*args)[0]


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
    march_args = (o, d, rays.dist_min, rays.dist_max, s, stride, field, level, None, 0.0)
    add_launches_and_was(rows[-1], lambda: raymarch_ray(*march_args[:-1]),
                         MARCH_GRAD_V1 and (lambda: MARCH_GRAD_V1.march(*march_args)),
                         lambda: march_equal(MARCH_GRAD_V1.march(*march_args), mp),
                         MARCH_GRAD_V1_DESIGN["march"])

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
    rows[-1]["library_call"] = "torch.nonzero(mask.T)"
    add_launches_and_was(rows[-1], lambda: compact(mask, samples, d, budget),
                         THREEPASS and (lambda: THREEPASS.compact(mask, samples, d, budget)),
                         lambda: compact_equal(THREEPASS.compact(mask, samples, d, budget),
                                               want, budget))
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
    add_launches_and_was(
        rows[-1], lambda: grid_ops.hashgrid(cflat, *args, out_lods=grid.num_lods),
        HASHGRID_V1 and (lambda: HASHGRID_V1.hashgrid(cflat, *args, out_lods=grid.num_lods)),
        lambda: float((HASHGRID_V1.hashgrid(cflat, *args, out_lods=grid.num_lods)
                       - hp).abs().max()) <= 1e-5, HASHGRID_V1_DESIGN)

    # K3 scatter-back of the field's colours
    with torch.no_grad():
        out = nef(channels=["rgb", "density"], coords=cflat, ray_d=cray_d,
                  lod_idx=grid.num_lods - 1, max_compute_lod=mcl)
    v = out["rgb"].contiguous()
    sk = scatter_back(v, idx, r * s)
    sp = scatter_back_plain(v, idx, r * s)
    idx_kept = idx[:kept]

    def library_scatter():
        """The same function in PyTorch: a zeroed [total + 1, C], then index_copy_."""
        return torch.zeros((r * s + 1, v.shape[1]), dtype=v.dtype,
                           device=v.device).index_copy_(0, idx_kept, v)

    require(torch.equal(library_scatter()[:r * s], sp), "scatter_back's library call differs")
    padded = torch.zeros((r * s + 1, v.shape[1]), dtype=v.dtype, device=v.device)
    row("scatter_back", "wisp_tpu_torch/csrc/compaction.cu",
        "wisp_tpu/tracers/packed_rf_tracer.py:210", float((sk - sp).abs().max()), 0.0,
        timed(lambda: scatter_back(v, idx, r * s)),
        timed(lambda: scatter_back_plain(v, idx, r * s)),
        nbytes=kept * (12 + 8) + r * s * 12, ops=0.0, library_ms=timed(library_scatter))
    rows[-1]["library_call"] = ("torch.zeros([total + 1, C]).index_copy_(0, idx[:K], v): "
                                "the zero fill and the copy")
    rows[-1]["library_index_copy_only_ms"] = timed(
        lambda: padded.index_copy_(0, idx_kept, v))

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


# the arguments of the last compaction each phase's tracers made: (phase, counter) -> args
COMPACTION_CALLS = {}
COMPACTION_PHASE = ["render"]


@contextmanager
def recording_compactions():
    """Keep the arguments of the last ``compact`` (K3, K6a) and ``compact_rays`` (K12, first
    and mid pass) call that the tracers make in each phase (``COMPACTION_PHASE``)."""
    from wisp_tpu_torch.tracers import packed_rf_tracer, packed_sdf_tracer
    compact, compact_rays = packed_rf_tracer.compact, packed_sdf_tracer.compact_rays

    def rec_compact(mask, samples, dirs, budget, acc_tau=None, tau_cap=None):
        key = (COMPACTION_PHASE[0], "compact" if acc_tau is None else "compact_live")
        COMPACTION_CALLS[key] = (mask, samples, dirs, budget,
                                 None if acc_tau is None else acc_tau.clone(), tau_cap)
        return compact(mask, samples, dirs, budget, acc_tau, tau_cap)

    def rec_rays(mask, budget, o, d, t, tf, mid=False):
        key = (COMPACTION_PHASE[0], "compact_rays_mid" if mid else "compact_rays")
        COMPACTION_CALLS[key] = (mask, budget, o, d, t, tf)
        return compact_rays(mask, budget, o, d, t, tf, mid=mid)

    with mock.patch.object(packed_rf_tracer, "compact", rec_compact), \
            mock.patch.object(packed_sdf_tracer, "compact_rays", rec_rays):
        yield


def compaction_phase() -> dict:
    """Both compaction kernels at every shape the paths gave them (each phase's last call):
    exactly equal to the plain version and to the earlier three-pass design, timed beside
    it, then all of them again back to back on one stream with no synchronisation between
    the calls, each result held to the plain version once more."""
    import torch
    from wisp_tpu_torch.ops.compaction import (compact, compact_plain, compact_rays,
                                               compact_rays_plain)
    require(COMPACTION_CALLS, "no phase recorded a compaction")
    out, checks = {}, []
    for (phase, kind), args in sorted(COMPACTION_CALLS.items()):
        if kind.startswith("compact_rays"):
            mask, budget = args[:2]
            run_new = functools.partial(compact_rays, *args, mid=kind.endswith("mid"))
            run_was = functools.partial(THREEPASS.compact_rays, *args)
            want = compact_rays_plain(*args)
            equal = rays_equal
            shape = {"rays": mask.shape[0], "budget": budget, "count": int(want[5])}
        else:
            mask, budget = args[0], args[3]
            run_new = functools.partial(compact, *args)
            run_was = functools.partial(THREEPASS.compact, *args)
            want = compact_plain(*args)
            equal = functools.partial(compact_equal, budget=budget)
            shape = {"rays": mask.shape[0], "steps": mask.shape[1], "budget": budget,
                     "count": int(want[3])}
        where = f"{kind} at the {phase} phase's shape {shape}"
        require(equal(run_new(), want), f"{where} differs from the plain version")
        require(equal(run_was(), want), f"the three-pass {where} differs from the plain "
                                        f"version")
        new, was = timed(run_new), timed(run_was)
        out[f"{phase}: {kind}"] = dict(shape, ms=new[0], event_ms=new[1], was_ms=was[0],
                                       was_event_ms=was[1])
        checks.append((run_new, want, equal, where))
    torch.cuda.synchronize()
    got = [c[0]() for c in checks]
    torch.cuda.synchronize()
    for g, (_, want, equal, where) in zip(got, checks):
        require(equal(g, want), f"{where}, called back to back, differs from the plain "
                                f"version")
    return out


# the K1 calls that the paths made, for the "hashgrid" step: key -> inputs (cloned)
HASHGRID_CALLS = {}


def k1_record(key, coords, geometry, table=None, grad_out=None, table_rows=None,
              stoch_mask=None, u0=None):
    """Keep one K1 call's inputs under ``key``: a forward (``table``) or a backward
    (``grad_out``, ``table_rows``, the stochastic LODs' flags and uniforms)."""
    HASHGRID_CALLS[key] = {
        "coords": coords.detach().clone(), "geometry": geometry,
        "table": None if table is None else table.detach().clone(),
        "grad_out": None if grad_out is None else grad_out.detach().clone(),
        "table_rows": table_rows, "stoch_mask": stoch_mask,
        "u0": None if u0 is None else u0.clone()}


@contextmanager
def recording_k1(key: str, copy_at_exit: bool = False):
    """Keep the inputs of the last K1 forward and backward launched inside, under
    "<key>: fwd" and "<key>: bwd": copied at the call, or with ``copy_at_exit`` held and
    copied when the block ends, so that a time taken inside the block leaves the copies out
    (only for a block that changes no input after its call, as a prune leaves the
    codebook)."""
    from wisp_tpu_torch.ops import grid as grid_ops
    fwd, bwd = grid_ops._hashgrid_fwd, grid_ops._hashgrid_bwd
    held = {}
    keep = held.__setitem__ if copy_at_exit else lambda k, kw: k1_record(k, **kw)

    def rec_fwd(coords, codebook, geometry):
        keep(f"{key}: fwd", dict(coords=coords, geometry=geometry, table=codebook))
        return fwd(coords, codebook, geometry)

    def rec_bwd(coords, grad_out, geometry, grad, stoch_mask=None, u0=None, u0_out=None):
        keep(f"{key}: bwd", dict(coords=coords, geometry=geometry, grad_out=grad_out,
                                 table_rows=grad.shape[0], stoch_mask=stoch_mask, u0=u0))
        return bwd(coords, grad_out, geometry, grad, stoch_mask, u0, u0_out)

    with mock.patch.object(grid_ops, "_hashgrid_fwd", rec_fwd), \
            mock.patch.object(grid_ops, "_hashgrid_bwd", rec_bwd):
        yield
    for k, kw in held.items():
        k1_record(k, **kw)


def k1_plain_args(geometry, rows):
    """``(resolutions, bitwidth, lod_idx, rows, first, sizes)`` of a K1 geometry."""
    dim, _, n_lods, _, codebook_size, arrays = geometry
    res = [int(r) for r in arrays[0]]
    return (res, codebook_size.bit_length() - 1, n_lods - 1, rows,
            [int(b) for b in arrays[3]], [min(r ** dim, codebook_size) for r in res])


# the "hashgrid" step also takes the first N samples of train step 25's calls as short calls
# (the seg phase's sizes and one between the routes' thresholds), and times the backward of
# a step with LODs 0..k-1 in shared memory for each k below HASHGRID_SHARED_SETS
HASHGRID_SHORT = (822, 4096, 22580, 50000)
HASHGRID_SHARED_SETS = 4


def hashgrid_phase() -> dict:
    """K1 forward and backward, exact and stochastic, at every shape the paths recorded
    (a render chunk, train step 25 and the prune's cells, the stoch step with injected
    uniforms, the seg step, the uniform chunk) and at the first ``HASHGRID_SHORT`` samples
    of train step 25: both designs held to the plain version (forward within 1e-5; backward
    within 1e-5 of the largest entry; the stochastic one by ``stoch_parity``: no flip
    outside tie rows, counts exact) and timed side by side. A backward of 65,536 samples or
    more (the privatizing route) is also held and timed with each of the first
    ``HASHGRID_SHARED_SETS`` shared LOD sets (``shared_ms``; ``grid.SHARED_LOD_BYTES`` set
    to their bytes). Then 200 calls of the redesign back to back on one stream with no
    synchronisation between them, short and long routes in turns, each entry's last result
    held to its own first (forward equal; backward within 1e-5 of the largest entry, the
    atomics' order)."""
    import torch
    from wisp_tpu_torch.ops import grid as grid_ops
    require(HASHGRID_CALLS, "no phase recorded a K1 call")
    calls = dict(HASHGRID_CALLS)
    for kind in ("fwd", "bwd"):
        c = HASHGRID_CALLS.get(f"train step 25: {kind}")
        for n in HASHGRID_SHORT if c is not None else ():
            calls[f"train step 25, first {n}: {kind}"] = dict(
                c, coords=c["coords"][:n].contiguous(),
                grad_out=None if c["grad_out"] is None else c["grad_out"][:n].contiguous())
    out, checks = {}, []
    for key, c in sorted(calls.items()):
        coords, geometry = c["coords"], c["geometry"]
        dim, f_dim, n_lods, out_lods, _, arrays = geometry
        n = coords.shape[0]
        shape = {"samples": n, "lods": n_lods, "out_lods": out_lods}
        if c["table"] is not None:
            table = c["table"]
            args = k1_plain_args(geometry, table)
            run_new = functools.partial(grid_ops._hashgrid_fwd, coords, table, geometry)
            run_was = functools.partial(HASHGRID_V1.fwd, coords, table, geometry)
            want = grid_ops.hashgrid_plain(coords, args[0], args[1], args[2], table, args[4],
                                           args[5], out_lods)
            errs = [float((f() - want).abs().max()) if n else 0.0 for f in (run_new, run_was)]
            require(all(e <= 1e-5 for e in errs), f"K1 forward at {key} {shape}: max abs err "
                                                  f"(new, earlier) {errs}, tolerance 1e-5")
            shape["max_abs_err"] = errs[0]
        else:
            g, rows, mask, u0 = c["grad_out"], c["table_rows"], c["stoch_mask"], c["u0"]
            args = k1_plain_args(geometry, rows)

            def run_new(coords=coords, g=g, geometry=geometry, rows=rows, mask=mask, u0=u0):
                grad = torch.zeros((rows, f_dim), dtype=torch.float32, device=coords.device)
                return grid_ops._hashgrid_bwd(coords, g, geometry, grad, mask, u0)

            run_was = functools.partial(HASHGRID_V1.bwd, coords, g, geometry, rows, mask, u0)
            if mask is None:
                want = grid_ops.hashgrid_bwd_plain(coords, g, *args, out_lods=out_lods)
                tol = 1e-5 * float(want.abs().max())

                def held(fns, want=want, tol=tol):
                    errs = [float((f() - want).abs().max()) for f in fns]
                    return all(e <= tol for e in errs), {"max_abs_err": errs[0], "tol": tol,
                                                         "errs (new, earlier)": errs}
            else:
                require(u0 is not None, f"{key}: a stochastic backward needs its uniforms")

                def held(fns, c=coords, g=g, a=args, m=mask, u=u0, o=out_lods):
                    parity = [stoch_parity(c, g, a, m, u, o, bwd) for bwd in
                              (grid_ops.hashgrid_bwd, HASHGRID_V1.hashgrid_bwd)[:len(fns)]]
                    return all(p["held"] for p in parity), {
                        "stoch_lods": int(sum(m[:n_lods])), "flips": parity[0]["flips"],
                        "tie_draws": parity[0]["tie_draws"], "max_abs_err": parity[0]["err"],
                        "tol": parity[0]["tol"], "parity (new, earlier)": parity}

            ok, found = held((run_new, run_was))
            require(ok, f"K1 backward at {key} {shape}: {found}")
            found.pop("errs (new, earlier)", None)
            found.pop("parity (new, earlier)", None)
            shape.update(found)
            if n >= 65536:
                lod_bytes = [int(r) ** dim * f_dim * 4 for r in arrays[0]]
                shape["shared_ms"] = {}
                for k in range(HASHGRID_SHARED_SETS):
                    with mock.patch.object(grid_ops, "SHARED_LOD_BYTES", sum(lod_bytes[:k])):
                        ok, found = held((run_new,))
                        require(ok, f"K1 backward at {key} with {k} shared LODs: {found}")
                        shape["shared_ms"][k] = timed(run_new)[0]
        new, was = timed(run_new), timed(run_was)
        out[key] = dict(shape, ms=new[0], event_ms=new[1], was_ms=was[0], was_event_ms=was[1])
        ref = run_new()
        tol = 0.0 if c["table"] is not None else 1e-5 * float(ref.abs().max()) if n else 0.0
        checks.append((key, run_new, ref, tol))
    torch.cuda.synchronize()
    last = {}
    for i in range(200):
        key, run_new, _, _ = checks[i % len(checks)]
        last[key] = run_new()
    torch.cuda.synchronize()
    for key, _, ref, tol in checks:
        err = float((last[key] - ref).abs().max()) if ref.numel() else 0.0
        require(err <= tol, f"K1 at {key}, called back to back, differs from its first result "
                            f"by {err} (tolerance {tol})")
    return out


def device_ms_by_kernel(fn, iters: int = 20) -> list:
    """(name, device ms a call) of each kernel that ``fn`` launches, from one torch.profiler
    session; empty if the session recorded none."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    _, recorded = device_kernels(prof, None)
    return [(k["name"][:60], k["ms"] / iters) for k in recorded]


def host_ms_in_turns(fns, calls: int = 200, rounds: int = 3) -> list:
    """Host ms a call of each function in ``fns``: the host clock around ``calls`` calls
    with no synchronisation between them (the launches queue on the card, so this is the
    host's time alone), the functions in turns, the median of ``rounds``."""
    import torch
    times = [[] for _ in fns]
    for _ in range(rounds):
        for i, fn in enumerate(fns):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            times[i].append((time.perf_counter() - t0) * 1e3 / calls)
            torch.cuda.synchronize()
    return [sorted(t)[len(t) // 2] for t in times]


# the K15 forward and K11 calls that the paths made, for the "octree grid" step: key ->
# {"kind": counter name, "args": the wrapper's arguments (cloned)}
OCTREE_GRID_CALLS = {}


def k15_record(key, coords, pidx, col0, trinkets, features, levels, multiscale_type):
    """Keep one K15 forward call's inputs under ``key``."""
    OCTREE_GRID_CALLS[key] = {"kind": "octree_interp", "args": (
        coords.detach().clone(), pidx.clone(), int(col0), [t.clone() for t in trinkets],
        [f.detach().clone() for f in features], [int(v) for v in levels], multiscale_type)}


def k11_record(key, occ, level, max_k=31):
    """Keep one K11 call's inputs under ``key``."""
    OCTREE_GRID_CALLS[key] = {"kind": "free_space_distance",
                              "args": (occ.clone(), int(level), int(max_k))}


@contextmanager
def recording_octree_grid(key: str):
    """Keep the inputs of the last K15 forward, the last K11, the last fused query and
    interpolation and the last sphere iteration with its step called inside, under "<key>"
    (K15's, and the fused query's, whose K15 call is the same blend at K9's columns),
    "<key>: K11" and "<key>: sphere_iter" for the "octree grid" and "query and step folded"
    steps. K15's, K11's and the fused query's inputs are held and copied when the block
    ends (no input of theirs is changed inside a block that uses this); the sphere
    iteration's state, which it changes, is copied before each call."""
    from wisp_tpu_torch.accelstructs import octree_as
    from wisp_tpu_torch.models.grids import octree_grid
    from wisp_tpu_torch.tracers import packed_sdf_tracer
    fwd, fsd = octree_grid._interp_fwd, octree_as.free_space_distance
    fused, step = octree_grid.octree_query_interp, packed_sdf_tracer.sphere_iter
    held = {}

    def rec_fwd(*args):
        held["k15"] = args
        return fwd(*args)

    def rec_fsd(occ, level, max_k=31):
        held["k11"] = (occ, level, max_k)
        return fsd(occ, level, max_k)

    def rec_fused(*args):
        held["fused"] = args
        return fused(*args)

    def rec_step(o, d, t, alive, hit, t_far, field, *args, out=None):
        if field is not None:
            held["step"] = (o, d, t.clone(), alive.clone(), hit.clone(), t_far, field, *args)
        return step(o, d, t, alive, hit, t_far, field, *args, out=out)

    with mock.patch.object(octree_grid, "_interp_fwd", rec_fwd), \
            mock.patch.object(octree_as, "free_space_distance", rec_fsd), \
            mock.patch.object(octree_grid, "octree_query_interp", rec_fused), \
            mock.patch.object(packed_sdf_tracer, "sphere_iter", rec_step):
        yield
    if "fused" in held:
        query_interp_record(key, *held["fused"])
    if "k15" in held:
        k15_record(key, *held["k15"])
    elif "fused" in held:
        k15_record(key, *unfused_args(*held["fused"]))
    if "k11" in held:
        k11_record(f"{key}: K11", *held["k11"])
    if "step" in held:
        sphere_iter_record(f"{key}: sphere_iter", *held["step"])


# the fused query's and the sphere iteration's calls that the paths made, for the "query
# and step folded" step: key -> {"kind": counter name, "args": the wrapper's arguments}
QUERY_STEP_CALLS = {}


def query_interp_record(key, coords, routes, trinkets, features, levels, multiscale_type,
                        with_cells=False):
    """Keep one ``octree_query_interp`` call's inputs (``_query_interp_fwd``'s) under
    ``key``; the routes' tables are the octree's own and are not copied."""
    QUERY_STEP_CALLS[key] = {"kind": "octree_query_interp", "args": (
        coords.detach().clone(), routes, [t.clone() for t in trinkets],
        [f.detach().clone() for f in features], [int(v) for v in levels], multiscale_type,
        bool(with_cells))}


def sphere_iter_record(key, o, d, t, alive, hit, t_far, field, free_dist, level, step_size,
                       min_dis, routes, trinkets, features, levels, multiscale_type,
                       with_xyz):
    """Keep one ``sphere_iter`` call with its step (its state before the call) under
    ``key``."""
    QUERY_STEP_CALLS[key] = {"kind": "sphere_iter", "args": (
        o.clone(), d.clone(), t.clone(), alive.clone(), hit.clone(), t_far.clone(),
        field.detach().clone(), free_dist.clone(), int(level), float(step_size),
        float(min_dis), routes, [x.clone() for x in trinkets],
        [f.detach().clone() for f in features], [int(v) for v in levels], multiscale_type,
        bool(with_xyz))}


def unfused_args(coords, routes, trinkets, features, levels, multiscale_type):
    """K15 forward's arguments for the blend that ``octree_query_interp`` makes: K9's pidx
    (with parents at the last LOD's level where there are several LODs), by the plain
    query."""
    from wisp_tpu_torch.accelstructs.octree_as import octree_query_plain
    if len(levels) == 1:
        pidx, col0 = octree_query_plain(coords, routes, levels[0])[:, None].contiguous(), 0
    else:
        pidx, col0 = octree_query_plain(coords, routes, levels[-1], True), levels[0]
    return coords, pidx, col0, trinkets, features, levels, multiscale_type


def octree_grid_phase() -> dict:
    """K15's forward and K11 at every call the paths recorded (an SDF render chunk after the
    walk and 4 iterations, an SDF train batch, the octree NeRF's F = 5 step, the trained
    NGLOD field's frames uncompacted on permuted rays, compacted and with the mid pass; K11
    at level 7 and at level 8): both designs held to the plain version (K15 within 1e-6,
    K11 equal) and timed side by side, with their launches a call, the event ms less the
    device ms a call (``host_ms``: the card's idle time a call when the calls come back to
    back), the wrappers' own host time a call (``wrapper_host_ms``, ``host_ms_in_turns``;
    K15's wrapper is ``_interp_fwd``) and the redesign's device ms by kernel. Then 200
    calls of the redesign back to back on one stream with no synchronisation between them,
    the shapes in turns, each shape's last result held equal to its first."""
    import torch
    from wisp_tpu_torch.accelstructs.octree_as import (free_space_distance,
                                                       free_space_distance_plain)
    from wisp_tpu_torch.models.grids.octree_grid import (_interp_fwd, interp_vector_width,
                                                         octree_interp_plain)
    require(OCTREE_GRID_CALLS, "no phase recorded a K15 forward or K11 call")
    out, checks = {}, []
    for key, c in sorted(OCTREE_GRID_CALLS.items()):
        args = c["args"]
        if c["kind"] == "octree_interp":
            coords, pidx, _, _, feats, levels, multiscale = args
            # the wrapper itself, beside the earlier one: their host work a call compares
            run_new = functools.partial(_interp_fwd, *args)
            run_was = functools.partial(OCTREE_V1.interp, *args)
            want = octree_interp_plain(*args)
            errs = [float((f() - want).abs().max()) if want.numel() else 0.0
                    for f in (run_new, run_was)]
            require(all(e <= 1e-6 for e in errs), f"K15 forward at {key}: max abs err "
                                                  f"(new, earlier) {errs}, tolerance 1e-6")
            f_dim = feats[0].shape[1]
            shape = {"points": coords.shape[0], "F": f_dim, "lods": len(levels),
                     "multiscale": multiscale, "features_a_lane": interp_vector_width(
                         f_dim, [f.data_ptr() for f in feats]),
                     "max_abs_err": errs[0], "was_max_abs_err": errs[1], "tol": 1e-6}
        else:
            occ, level, max_k = args
            run_new = functools.partial(free_space_distance, *args)
            run_was = functools.partial(OCTREE_V1.free_space, *args)
            want = free_space_distance_plain(*args)
            require(torch.equal(run_new(), want) and torch.equal(run_was(), want),
                    f"K11 at {key}: a design differs from the plain version")
            shape = {"level": level, "max_k": max_k, "cells": occ.numel(),
                     "occupied": int(occ.sum()), "max_abs_err": 0, "tol": 0}
        with torch.no_grad():
            new, was = timed(run_new), timed(run_was)
            host = host_ms_in_turns((run_new, run_was))
            out[key] = dict(shape, ms=new[0], event_ms=new[1], host_ms=new[1] - new[0],
                            wrapper_host_ms=host[0], ms_by_kernel=device_ms_by_kernel(run_new),
                            launches_per_call=launches_per_call(run_new), was_ms=was[0],
                            was_event_ms=was[1], was_host_ms=was[1] - was[0],
                            was_wrapper_host_ms=host[1],
                            was_launches_per_call=launches_per_call(run_was),
                            was_design=OCTREE_V1_DESIGN[c["kind"]])
            checks.append((key, run_new, run_new()))
    torch.cuda.synchronize()
    last = {}
    with torch.no_grad():
        for i in range(200):
            key, run_new, _ = checks[i % len(checks)]
            last[key] = run_new()
    torch.cuda.synchronize()
    for key, _, ref in checks:
        require(torch.equal(last[key], ref), f"{key}, called back to back, differs from its "
                                             f"first result")
    return out


def query_step_phase() -> dict:
    """The fused query and interpolation (``octree_query_interp``) and the sphere iteration
    with its step (``sphere_iter``) at every call the paths recorded (the SDF render chunk
    after the walk and 4 iterations, the SDF train batch with its cells, the octree NeRF's
    F = 5 step, the trained NGLOD field's frames, a level-8 chunk): each held to its plain
    version (features and rows within 1e-6; cells, t, alive and hit exactly) and timed
    beside the unfused sequence it replaces (``UNFUSED_DESIGN``, held to the plain version
    first), with their launches a call, host time a call (``host_ms_in_turns``) and the
    fused kernel's device ms by kernel. Then 200 fused queries back to back on one stream
    with no synchronisation between them, the shapes in turns, each shape's last result
    held equal to its first."""
    import torch
    from wisp_tpu_torch.accelstructs.octree_as import octree_query
    from wisp_tpu_torch.models.grids.octree_grid import (_query_interp_fwd,
                                                         interp_vector_width, octree_interp,
                                                         octree_query_interp_plain, ray_lanes)
    from wisp_tpu_torch.tracers.packed_sdf_tracer import (sphere_iter, sphere_iter_plain,
                                                          sphere_step)
    require(any(c["kind"] == "octree_query_interp" for c in QUERY_STEP_CALLS.values())
            and any(c["kind"] == "sphere_iter" for c in QUERY_STEP_CALLS.values()),
            "no phase recorded a fused query or a sphere iteration")
    out, checks = {}, []

    def unfused_query(coords, routes, trinkets, feats, levels, ms):
        top = levels[-1]
        if len(levels) == 1:
            pidx, col0 = octree_query(coords, routes, top)[:, None], 0
        else:
            pidx, col0 = octree_query(coords, routes, top, True), levels[0]
        return octree_interp(coords, pidx, col0, trinkets, feats, levels, ms)

    for key, c in sorted(QUERY_STEP_CALLS.items()):
        args = c["args"]
        with torch.no_grad():
            if c["kind"] == "octree_query_interp":
                coords, routes, trinkets, feats, levels, ms, with_cells = args
                want, want_cells = octree_query_interp_plain(*args[:6])
                got, cells = _query_interp_fwd(*args)
                err = float((got - want).abs().max()) if want.numel() else 0.0
                was_err = (float((unfused_query(*args[:6]) - want).abs().max())
                           if want.numel() else 0.0)
                require(err <= 1e-6 and was_err <= 1e-6,
                        f"octree_query_interp at {key}: max abs err (fused, unfused) "
                        f"{(err, was_err)}, tolerance 1e-6")
                require(not with_cells or torch.equal(cells, want_cells),
                        f"octree_query_interp at {key}: the cells differ from K9's columns")
                run_new = functools.partial(_query_interp_fwd, *args)
                run_was = functools.partial(unfused_query, *args[:6])
                f_dim = feats[0].shape[1]
                shape = {"kind": c["kind"], "points": coords.shape[0], "F": f_dim,
                         "lods": len(levels), "multiscale": ms, "with_cells": with_cells,
                         "routes": [routes[l].kind for l in levels],
                         "features_a_lane": interp_vector_width(
                             f_dim, [f.data_ptr() for f in feats]),
                         "max_abs_err": err, "was_max_abs_err": was_err, "tol": 1e-6}
                checks.append((key, run_new, run_new()[0]))
            else:
                (o, d, t, alive, hit, t_far, field, fd, level, step, min_dis, routes,
                 trinkets, feats, levels, ms, with_xyz) = args
                rest = (t_far, field, fd, level, step, min_dis, routes, trinkets, feats,
                        levels, ms, with_xyz)
                sk = [t.clone(), alive.clone(), hit.clone()]
                sp = [t.clone(), alive.clone(), hit.clone()]
                got = sphere_iter(o, d, *sk, *rest)
                want = sphere_iter_plain(o, d, *sp, *rest)
                require(all(torch.equal(a, b) for a, b in zip(sk, sp)),
                        f"sphere_iter at {key}: t, alive or hit differs from sphere_step's")
                err = float((got - want).abs().max()) if want.numel() else 0.0

                def unfused_iter(t_, alive_, hit_, o=o, d=d, rest=rest):
                    (t_far_, field_, fd_, level_, step_, min_dis_, routes_, trk_, fts_,
                     levels_, ms_, with_xyz_) = rest
                    sphere_step(o, d, t_, alive_, hit_, t_far_, field_[:, 0].contiguous(),
                                fd_, level_, step_, min_dis_)
                    pos = o + t_[:, None] * d
                    feats_ = unfused_query(pos, routes_, trk_, fts_, levels_, ms_)
                    return torch.cat([feats_, pos], dim=-1) if with_xyz_ else feats_

                wk = [t.clone(), alive.clone(), hit.clone()]
                was_rows = unfused_iter(*wk)
                live = sp[1]
                was_err = (float((was_rows[live] - want[live]).abs().max())
                           if bool(live.any()) else 0.0)
                require(err <= 1e-6 and was_err <= 1e-6
                        and all(torch.equal(a, b) for a, b in zip(wk, sp)),
                        f"sphere_iter at {key}: max abs err (fused, unfused) "
                        f"{(err, was_err)}, tolerance 1e-6, or the unfused step differs")
                # a fresh state for every call (the step changes it): a pool of copies,
                # refilled from the recorded state before each measurement
                pool = [tuple(x.clone() for x in (t, alive, hit)) for _ in range(130)]
                turn = [0]

                def state(pool=pool, turn=turn):
                    turn[0] += 1
                    return pool[turn[0] % len(pool)]

                def refresh(pool=pool, t=t, alive=alive, hit=hit):
                    for copy in pool:
                        for x, y in zip(copy, (t, alive, hit)):
                            x.copy_(y)

                run_new = (lambda o=o, d=d, rest=rest, state=state:
                           sphere_iter(o, d, *state(), *rest))
                run_was = (lambda f=unfused_iter, state=state: f(*state()))
                f_dim = feats[0].shape[1]
                shape = {"kind": c["kind"], "rays": o.shape[0],
                         "alive_before": int(alive.sum()), "alive_after": int(live.sum()),
                         "hits_made": int((sp[2] & ~hit).sum()), "F": f_dim,
                         "lods": len(levels), "multiscale": ms, "with_xyz": with_xyz,
                         "routes": [routes[l].kind for l in levels],
                         "lanes_a_ray": ray_lanes(feats)[1],
                         "max_abs_err": err, "was_max_abs_err": was_err, "tol": 1e-6,
                         "state_exact": True}
            if c["kind"] == "octree_query_interp":
                def refresh():
                    return None
            refresh()
            new = timed(run_new)
            refresh()
            was = timed(run_was)
            refresh()
            by_kernel = device_ms_by_kernel(run_new)
            host = host_ms_in_turns((run_new, run_was))
            out[key] = dict(shape, ms=new[0], event_ms=new[1], host_ms=new[1] - new[0],
                            wrapper_host_ms=host[0], ms_by_kernel=by_kernel,
                            launches_per_call=launches_per_call(run_new), was_ms=was[0],
                            was_event_ms=was[1], was_host_ms=was[1] - was[0],
                            was_wrapper_host_ms=host[1],
                            was_launches_per_call=launches_per_call(run_was),
                            was_design=UNFUSED_DESIGN[c["kind"]])
    torch.cuda.synchronize()
    last = {}
    with torch.no_grad():
        for i in range(200):
            key, run_new, _ = checks[i % len(checks)]
            last[key] = run_new()[0]
    torch.cuda.synchronize()
    for key, _, ref in checks:
        require(torch.equal(last[key], ref), f"{key}, called back to back, differs from its "
                                             f"first result")
    return out


# the K12 walk and K13 calls that the paths made, for the "walks" step: key -> {"kind":
# counter name, "args": the wrapper's arguments (rays and state cloned; the free-space field,
# the occupancy and the route held, as the paths hold them)}
WALK_CALLS = {}
WALK_POOL = 130                # fresh states of an in-place walk for one measurement
WALK_SPLIT_FIELDS = (1, 4)     # uniform fields of the split: every step full; every step far
WALK_OVERFLOW_STEPS = 8        # the SPC chunk again, with a budget that runs out
# timed here; the SDF render chunk and the SPC chunk are timed in their phases' rows
WALK_TIMED = ("nglod frame: chunk 0", "nglod level 8 chunk: chunk 0", "spc frame: overflow")
WALK_BACK_TO_BACK = 200


def walk_record(key, kind, args):
    """Keep one ``sdf_walk`` (its state before the call) or ``spc_trace`` call under
    ``key``."""
    if kind == "sdf_walk":
        o, d, t, alive, t_far, fd, level, steps = args
        args = (o.clone(), d.clone(), t.clone(), alive.clone(), t_far.clone(), fd,
                int(level), int(steps))
    else:
        o, d, dmin, dmax, fd, occ, route, level, steps = args
        args = (o.clone(), d.clone(), float(dmin), float(dmax), fd, occ, route, int(level),
                int(steps))
    WALK_CALLS[key] = {"kind": kind, "args": args}


@contextmanager
def recording_walks(key: Optional[str]):
    """Keep every ``sdf_walk`` and ``spc_trace`` call made inside, as "<key>: chunk <i>"
    (none where ``key`` is None)."""
    from wisp_tpu_torch.tracers import packed_sdf_tracer, packed_spc_tracer
    if key is None:
        yield
        return
    walk, trace = packed_sdf_tracer.sdf_walk, packed_spc_tracer.spc_trace
    count = [0]

    def rec(kind, fn):
        def call(*args):
            walk_record(f"{key}: chunk {count[0]}", kind, args)
            count[0] += 1
            return fn(*args)
        return call

    with mock.patch.object(packed_sdf_tracer, "sdf_walk", rec("sdf_walk", walk)), \
            mock.patch.object(packed_spc_tracer, "spc_trace", rec("spc_trace", trace)):
        yield


def walk_with(args, **changes):
    """A walk call's arguments with some replaced (free_dist, occ, num_steps)."""
    names = (("o", "d", "t", "alive", "t_far", "free_dist", "level", "num_steps")
             if len(args) == 8 else
             ("o", "d", "dist_min", "dist_max", "free_dist", "occ", "route", "level",
              "num_steps"))
    return tuple(changes.get(n, a) for n, a in zip(names, args))


def walk_start(kind, args):
    """``walk_work``'s arguments for a call: the ray state the walk starts from (K13's: its
    slab test)."""
    from wisp_tpu_torch.accelstructs.octree_as import aabb_intersect
    if kind == "sdf_walk":
        return args
    o, d, dmin, dmax, fd, _, _, level, steps = args
    t_near, t_far = aabb_intersect(o, d, dmin, dmax)
    t0 = t_near.clamp(min=0.0) + 1e-6
    return o, d, t0, t_far > t0, t_far, fd, level, steps


def walk_caller(fn, kind, args):
    """(call, refresh): ``call()`` runs ``fn`` (``sdf_walk`` or ``spc_trace``, or another
    design's) on ``args`` and returns its outputs; an in-place walk takes its state from a
    pool of ``WALK_POOL`` copies, which ``refresh()`` restores before each measurement
    (``timed`` makes at most 123 calls)."""
    if kind == "spc_trace":
        return (lambda: fn(*args)), (lambda: None)
    o, d, t, alive, t_far, fd, level, steps = args
    pool = [(t.clone(), alive.clone()) for _ in range(WALK_POOL)]
    turn = [0]

    def call():
        tt, aa = pool[turn[0] % WALK_POOL]
        turn[0] += 1
        fn(o, d, tt, aa, t_far, fd, level, steps)
        return tt, aa

    def refresh():
        for tt, aa in pool:
            tt.copy_(t)
            aa.copy_(alive)
        turn[0] = 0

    return call, refresh


def walk_designs(kind):
    """{design: the entry point}: the port's wrapper, its plain version, the earlier design
    and the probe."""
    from wisp_tpu_torch.tracers.packed_sdf_tracer import sdf_walk, sdf_walk_plain
    from wisp_tpu_torch.tracers.packed_spc_tracer import spc_trace, spc_trace_plain
    if kind == "sdf_walk":
        return {"new": sdf_walk, "plain": sdf_walk_plain, "was": SPHERE_TRACE_V1.sdf_walk,
                "probe": WALK_PROBE.sdf_walk}
    return {"new": spc_trace, "plain": spc_trace_plain, "was": SPHERE_TRACE_V1.spc_trace,
            "probe": WALK_PROBE.spc_trace}


def walk_once(fn, kind, args):
    """One call on fresh state: the outputs (t, alive; or t, hit, pidx, num_overflow)."""
    if kind == "spc_trace":
        return fn(*args)
    o, d, t, alive, t_far, fd, level, steps = args
    t, alive = t.clone(), alive.clone()
    fn(o, d, t, alive, t_far, fd, level, steps)
    return t, alive


def walk_equal(got, want) -> bool:
    import torch
    return all(bool(torch.equal(a, b)) for a, b in zip(got, want))


def walk_timed(fn, kind, args):
    """``timed`` of ``fn`` on ``args`` (fresh state every call)."""
    call, refresh = walk_caller(fn, kind, args)
    refresh()
    return timed(call)


def walk_row_extras(row, kind, args, work: dict) -> dict:
    """A K12 walk or K13 row's launches a call, the earlier design's time on the same inputs
    (``was_ms``, held bit for bit to the plain version first), the same call's time with
    num_steps = 0 (``floor_ms``), its longest walk and the time a chain step
    (``ns_per_chain_step``: (ms - floor) / longest walk); ``work`` is ``walk_work``'s."""
    longest = work["longest_walk"]
    designs = walk_designs(kind)
    want = walk_once(designs["plain"], kind, args)
    require(walk_equal(walk_once(designs["was"], kind, args), want),
            f"{row['name']}: the earlier design ({SPHERE_TRACE_V1_DESIGN}) differs from the "
            f"plain version")
    new_call, _ = walk_caller(designs["new"], kind, args)
    was = walk_timed(designs["was"], kind, args)
    floor = walk_timed(designs["new"], kind, walk_with(args, num_steps=0))
    row.update(launches_per_call=launches_per_call(new_call), was_ms=was[0],
               was_event_ms=was[1], was_design=SPHERE_TRACE_V1_DESIGN, floor_ms=floor[0],
               floor_event_ms=floor[1], longest_walk=longest,
               ns_per_chain_step=((row["ms"] - floor[0]) / longest * 1e6 if longest
                                  else None),
               far_steps=work["far_steps"], steps_taken=work["steps_taken"],
               mixed_warp_steps=work["mixed_warp_steps"], warp_steps=work["warp_steps"])
    return row


def walk_hard_rays(dev, level: int, seed: int = 23):
    """Rays that stress the step's rules: axis-aligned directions; a component of +0, -0
    and +-1e-13 on each axis; directions of length 0.25 and 4; origins exactly on cell
    planes inside the box; directions with no moving axis."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    voxel = 2.0 / 2 ** level
    os_, ds = [], []

    def unit(m):
        d = rng.normal(size=(m, 3))
        return d / np.linalg.norm(d, axis=-1, keepdims=True)

    for axis in range(3):
        for sign in (1.0, -1.0):
            o = rng.uniform(-0.95, 0.95, (64, 3))
            o[:, axis] = -2.0 * sign
            d = np.zeros((64, 3))
            d[:, axis] = sign
            os_.append(o)
            ds.append(d)
        for v in (0.0, -0.0, 1e-13, -1e-13):
            d = unit(32)
            d[:, axis] = v
            os_.append(rng.uniform(-0.4, 0.4, (32, 3)) - 2.2 * d)
            ds.append(d)
    for length in (0.25, 4.0):
        d = unit(64)
        os_.append(rng.uniform(-0.4, 0.4, (64, 3)) - 2.2 * d)
        ds.append(d * length)
    planes = -1.0 + voxel * rng.integers(1, 2 ** level, (128, 3))
    os_.append(planes)
    ds.append(unit(128))
    os_.append(rng.uniform(-0.9, 0.9, (16, 3)))
    ds.append(np.tile([[1e-13, -1e-13, 0.0]], (16, 1)))
    o = torch.from_numpy(np.concatenate(os_).astype(np.float32)).to(dev)
    d = torch.from_numpy(np.concatenate(ds).astype(np.float32)).to(dev)
    return o, d


def walk_hard_cases(spc_args) -> dict:
    """The hard rays' calls, at the SPC chunk's level, route and occupancy: K12's walk and
    K13, each on the octree's field, an all-free field (k = 32 everywhere) and an
    all-occupied one, at the budget and at 0 and 1 steps."""
    import torch
    from wisp_tpu_torch.accelstructs.octree_as import aabb_intersect
    _, _, dmin, dmax, fd, occ, route, level, steps = spc_args
    o, d = walk_hard_rays(fd.device, level)
    t_near, t_far = aabb_intersect(o, d, dmin, dmax)
    t0 = t_near.clamp(min=0.0) + 1e-6
    occ = occ if occ is not None else torch.ones_like(fd, dtype=torch.bool)
    fields = {"octree": (fd, occ),
              "all free": (torch.full_like(fd, 32), torch.zeros_like(occ)),
              "all occupied": (torch.zeros_like(fd), torch.ones_like(occ))}
    cases = {}
    for name, (f, oc) in fields.items():
        for n in (steps, 0, 1):
            cases[f"hard rays, {name}, {n} steps: sdf_walk"] = (
                "sdf_walk", (o, d, t0, t_far > t0, t_far, f, level, n))
            cases[f"hard rays, {name}, {n} steps: spc_trace"] = (
                "spc_trace", (o, d, dmin, dmax, f, oc, route, level, n))
    return cases


def walk_split(kind, args) -> dict:
    """Tentpole step 2's split of a chain step between the field's load and the rest: on a
    uniform field of each k in ``WALK_SPLIT_FIELDS`` (k = 1: every step the full step, with
    its divisions; k = 4: every step the far step), the library's walk and the probe (its
    field read pointed at one fixed cell, which holds the same k: the same steps, bit for
    bit) at this call's rays, each as ns a chain step ((ms - floor) / longest walk), and
    the earlier design's beside them."""
    import torch
    designs = walk_designs(kind)
    out = {}
    for k in WALK_SPLIT_FIELDS:
        field = args[5 if kind == "sdf_walk" else 4]
        a = walk_with(args, free_dist=torch.full_like(field, k))
        got = {n: walk_once(fn, kind, a) for n, fn in designs.items()}
        require(all(walk_equal(got[n], got["plain"]) for n in ("new", "was", "probe")),
                f"walk split ({kind}, k = {k}): a design differs from the plain version")
        longest = walk_work(*walk_start(kind, a))["longest_walk"]
        floor = walk_timed(designs["new"], kind, walk_with(a, num_steps=0))[0]
        ms = {n: walk_timed(designs[n], kind, a)[0] for n in ("new", "probe", "was")}
        per = {n: (v - floor) / longest * 1e6 if longest else None for n, v in ms.items()}
        out[f"k = {k}"] = {
            "longest_walk": longest, "floor_ms": floor, "ms": ms, "ns_per_chain_step": per,
            "load_share_of_a_step": (1.0 - per["probe"] / per["new"]
                                     if longest and per["new"] else None)}
    return out


def walk_phase(dev) -> dict:
    """K12's walk and K13 at every call the paths recorded (the SDF render chunk, the
    trained NGLOD frame's chunks, a level-8 chunk, the SPC frame's chunks and one with a
    budget that runs out) and on the hard rays: the library's walk and the earlier design
    held bit for bit to the plain version (t, alive; t, hit, pidx, the overflow count);
    ``sphere_step`` and ``sphere_iter`` held again on the sphere iterations that the "query
    and step folded" step holds (t, alive and hit exactly, rows within 1e-6) and
    ``sphere_step`` on the hard rays. The calls of ``WALK_TIMED`` timed beside the earlier
    design with their launches, host time a call, floor (num_steps = 0), longest walk and
    time a chain step; the split of a chain step (``walk_split``) at the SDF chunk and the
    SPC chunk; then ``WALK_BACK_TO_BACK`` calls back to back on one stream, the recorded
    shapes in turns, each shape's last result held equal to its first."""
    import torch
    from wisp_tpu_torch.tracers.packed_sdf_tracer import (sphere_iter, sphere_iter_plain,
                                                          sphere_step, sphere_step_plain)
    spc_key = "spc frame: chunk 1"
    require("sdf render chunk" in WALK_CALLS and spc_key in WALK_CALLS,
            f"the walks recorded are {sorted(WALK_CALLS)}")
    spc = WALK_CALLS[spc_key]["args"]
    calls = {k: (c["kind"], c["args"]) for k, c in WALK_CALLS.items()}
    calls["spc frame: overflow"] = ("spc_trace",
                                    walk_with(spc, num_steps=WALK_OVERFLOW_STEPS))
    calls.update(walk_hard_cases(spc))
    out, held = {}, []
    with torch.no_grad():
        for key, (kind, args) in sorted(calls.items()):
            designs = walk_designs(kind)
            want = walk_once(designs["plain"], kind, args)
            got = walk_once(designs["new"], kind, args)
            was = walk_once(designs["was"], kind, args)
            require(walk_equal(got, want) and walk_equal(was, want),
                    f"{kind} at {key}: (new, earlier design) bit-equal to the plain "
                    f"version: {(walk_equal(got, want), walk_equal(was, want))}")
            shape = {"kind": kind, "rays": args[0].shape[0], "level": args[-2],
                     "num_steps": args[-1], "exact": True}
            if kind == "spc_trace":
                shape.update(hits=int(want[1].sum()), num_overflow=float(want[3]),
                             route=args[6].kind)
            else:
                shape.update(alive_after=int(want[1].sum()))
            if key == "spc frame: overflow":
                require(float(want[3]) > 0, "the overflow chunk did not overflow")
            if key in WALK_TIMED:
                work = walk_work(*walk_start(kind, args))
                longest = work["longest_walk"]
                new_call, new_refresh = walk_caller(designs["new"], kind, args)
                was_call, was_refresh = walk_caller(designs["was"], kind, args)
                new_refresh()
                new = timed(new_call)
                was_refresh()
                was_t = timed(was_call)
                floor = walk_timed(designs["new"], kind, walk_with(args, num_steps=0))
                new_refresh()
                was_refresh()
                host = host_ms_in_turns((new_call, was_call), calls=100)
                shape.update(
                    ms=new[0], event_ms=new[1], was_ms=was_t[0], was_event_ms=was_t[1],
                    floor_ms=floor[0], **work,
                    ns_per_chain_step=((new[0] - floor[0]) / longest * 1e6 if longest
                                       else None),
                    was_ns_per_chain_step=((was_t[0] - floor[0]) / longest * 1e6 if longest
                                           else None),
                    wrapper_host_ms=host[0], was_host_ms=host[1],
                    launches_per_call=launches_per_call(new_call))
            if not key.startswith("hard rays"):
                held.append((key, kind, args, got))
            out[key] = shape
        out["was_design"] = SPHERE_TRACE_V1_DESIGN
        out["split"] = {"sdf render chunk": walk_split("sdf_walk",
                                                       calls["sdf render chunk"][1]),
                        spc_key: walk_split("spc_trace", spc)}
        # sphere_step and sphere_iter on the sphere iterations step 21 holds, and
        # sphere_step on the hard rays with a field of both signs and some under min_dis
        steps_held = 0
        for key, c in sorted(QUERY_STEP_CALLS.items()):
            if c["kind"] != "sphere_iter":
                continue
            (o, d, t, alive, hit, t_far, field, fd, level, step, min_dis, *rest) = c["args"]
            sk = [t.clone(), alive.clone(), hit.clone()]
            sp = [t.clone(), alive.clone(), hit.clone()]
            sphere_step(o, d, *sk, t_far, field[:, 0].contiguous(), fd, level, step, min_dis)
            sphere_step_plain(o, d, *sp, t_far, field[:, 0].contiguous(), fd, level, step,
                              min_dis)
            ik = [t.clone(), alive.clone(), hit.clone()]
            ip = [t.clone(), alive.clone(), hit.clone()]
            rows_k = sphere_iter(o, d, *ik, t_far, field, fd, level, step, min_dis, *rest)
            rows_p = sphere_iter_plain(o, d, *ip, t_far, field, fd, level, step, min_dis,
                                       *rest)
            err = float((rows_k - rows_p).abs().max()) if rows_p.numel() else 0.0
            require(walk_equal(sk, sp) and walk_equal(ik, ip) and walk_equal(ik, sp)
                    and err <= 1e-6,
                    f"sphere_step / sphere_iter at {key}: t, alive or hit differs, or rows "
                    f"off by {err}")
            steps_held += 1
        g = torch.Generator(device="cpu").manual_seed(29)
        for key, (kind, args) in sorted(calls.items()):
            if not key.startswith("hard rays") or kind != "sdf_walk" or args[-1] == 0:
                continue
            o, d, t, alive, t_far, fd, level, _ = args
            dist = ((torch.rand(o.shape[0], generator=g) - 0.2) * 0.05).to(dev)
            sk = [t.clone(), alive.clone(), torch.zeros_like(alive)]
            sp = [t.clone(), alive.clone(), torch.zeros_like(alive)]
            for _ in range(4):
                sphere_step(o, d, *sk, t_far, dist, fd, level, 0.8, 3e-3)
                sphere_step_plain(o, d, *sp, t_far, dist, fd, level, 0.8, 3e-3)
                require(walk_equal(sk, sp), f"sphere_step at {key} differs from the plain "
                                            f"version")
            steps_held += 1
        require(steps_held > 0, "no sphere iteration was recorded to hold sphere_step on")
        out["sphere_step_and_iter_held"] = steps_held
        torch.cuda.synchronize()
        callers = [(key, walk_caller(walk_designs(kind)["new"], kind, args)[0], ref)
                   for key, kind, args, ref in held]
        last = {}
        for i in range(WALK_BACK_TO_BACK):
            key, call, _ = callers[i % len(callers)]
            last[key] = call()
        torch.cuda.synchronize()
        for key, _, ref in callers:
            require(walk_equal(last[key], ref), f"{key}, called back to back, differs from "
                                                f"its first result")
    return out


SCATTER_SEG_BACK_TO_BACK = 200


def scatter_seg_phase() -> dict:
    """K12's scatter-back and K6b on the calls the paths recorded (SCATTER_SEG_CALLS): the
    trained NGLOD frame's last compacted chunk's scatter-back of every channel and its mid
    pass's, bit for bit to the plain version and to the earlier design (a launch a
    channel); the seg phase's segments of step 25 and the checked segment with the culling
    carry within SEG_FWD_TOL (acc_tau out SEG_ACC_REL_TOL relative) of the plain version,
    the earlier design too. Each call timed beside the earlier design (device ms, event
    ms), with its hand-written launches and device kernels a call and the path's launches;
    then SCATTER_SEG_BACK_TO_BACK calls back to back on one stream, the calls in turns,
    each call's last result held equal to its first."""
    import torch
    from wisp_tpu_torch import kernels
    from wisp_tpu_torch.ops.compaction import scatter_rows_many, scatter_rows_many_plain
    from wisp_tpu_torch.ops.integration import integrate_segment, integrate_segment_plain
    require(all(k in SCATTER_SEG_CALLS for k in ("scatter", "scatter mid", "segments")),
            f"the scatter and segment calls recorded are {sorted(SCATTER_SEG_CALLS)}")
    frame, seg = SCATTER_SEG_CALLS["frame launches"], SCATTER_SEG_CALLS["seg launches"]
    out = {"was_design": SCATTER_SEG_V1_DESIGN, "frame_launches": frame,
           "seg_launches": seg, "seg_launches_a_step": seg["integrate_seg_fwd"] / seg["steps"]}
    callers = []

    def hand_launches(counter, fn):
        before = kernels.LAUNCHES[counter]
        result = fn()
        return result, kernels.LAUNCHES[counter] - before

    with torch.no_grad():
        for key in ("scatter", "scatter mid"):
            rec = SCATTER_SEG_CALLS[key]
            mid, idx = key.endswith("mid"), rec["idx"]
            counter = "scatter_rays_mid" if mid else "scatter_rays"
            want = scatter_rows_many_plain(idx, scatter_pairs(rec))
            got, hand = hand_launches(
                counter, lambda: scatter_rows_many(idx, scatter_pairs(rec), mid=mid))
            was = SCATTER_SEG_V1.scatter_rows_many(idx, scatter_pairs(rec))
            require(scatter_equal(got, want) and scatter_equal(was, want),
                    f"{key}: (new, earlier design) bit-equal to the plain version: "
                    f"{(scatter_equal(got, want), scatter_equal(was, want))}")
            require(hand == 1, f"{key}: {hand} launches a call, not one")
            work = scatter_pairs(rec)
            new_call = functools.partial(scatter_rows_many, idx, work, mid=mid)
            was_call = functools.partial(SCATTER_SEG_V1.scatter_rows_many, idx, work)
            new_t, was_t = timed(new_call), timed(was_call)
            sizes = scatter_sizes(rec)
            out[key] = {
                **sizes, "channels": list(rec["names"]), "exact": True, "ms": new_t[0],
                "event_ms": new_t[1], "was_ms": was_t[0], "was_event_ms": was_t[1],
                "bound_ms": bound(scatter_bytes(rec, sizes), 0)[0],
                "hand_written_launches_per_call": hand,
                "launches_per_call": launches_per_call(new_call),
                "was_launches_per_call": launches_per_call(was_call),
                "path_launches": frame[counter]}
            bases = [b for _, b in rec["pairs"]]

            def again(work=work, bases=bases, new_call=new_call):
                for (_, o), b in zip(work, bases):
                    o.copy_(b)
                return new_call()

            callers.append((key, again, want))
        for key, args in SCATTER_SEG_CALLS["segments"]:
            want = integrate_segment_plain(*args)
            got, hand = hand_launches("integrate_seg_fwd", lambda: integrate_segment(*args))
            was = SCATTER_SEG_V1.integrate_segment(*args)
            err, rel = seg_fwd_errors(got, want)
            was_err, was_rel = seg_fwd_errors(was, want)
            require(seg_fwd_within(got, want) and seg_fwd_within(was, want),
                    f"integrate_seg_fwd at {key}: (new, earlier design) off the plain version "
                    f"by {(err, rel)}, {(was_err, was_rel)}")
            require(hand == 1, f"integrate_seg_fwd at {key}: {hand} launches a call, not one")
            new_call = functools.partial(integrate_segment, *args)
            was_call = functools.partial(SCATTER_SEG_V1.integrate_segment, *args)
            new_t, was_t = timed(new_call), timed(was_call)
            r, steps = args[0].shape
            out[key] = {
                "rays": r, "steps": steps, "rounds": -(-steps // 128),
                "was_rounds": -(-steps // 32), "max_abs_err": err, "acc_tau_rel_err": rel,
                "was_max_abs_err": was_err, "was_acc_tau_rel_err": was_rel,
                "rays_culled": float((args[5] >= SCATTER_SEG_CALLS["tau_cap"]).float().mean()),
                "ms": new_t[0], "event_ms": new_t[1], "was_ms": was_t[0],
                "was_event_ms": was_t[1],
                "bound_ms": bound(r * steps * 21 + r * 28, r * steps * 16)[0],
                "hand_written_launches_per_call": hand,
                "launches_per_call": launches_per_call(new_call),
                "was_launches_per_call": launches_per_call(was_call)}
            callers.append((key, new_call, got))
        torch.cuda.synchronize()
        last = {}
        for i in range(SCATTER_SEG_BACK_TO_BACK):
            key, call, _ = callers[i % len(callers)]
            last[key] = call()
        torch.cuda.synchronize()
        for key, _, first in callers:
            same = (scatter_equal(last[key], first) if key.startswith("scatter") else
                    set(last[key]) == set(first)
                    and all(torch.equal(last[key][k], first[k]) for k in first))
            require(same, f"{key}, called back to back, differs from its first result")
    out["back_to_back_calls"] = SCATTER_SEG_BACK_TO_BACK
    return out


# the tracer's K5 calls and the scatter-back's backward gathers that the flagship's and the
# seg phase's step 25 made, for the "feedback and gather" step and the K5 and K3 backward
# rows: key -> {"k5": [(points, density, level, the grid before the call or None, keep)],
# "gather": [(cotangents (cloned), idx, k)]}; and "<path> step" -> its profiled step's
# device kernels and the hand-written launches a step
FEEDBACK_GATHER_CALLS = {}
FEEDBACK_GATHER_BACK_TO_BACK = 200


@contextmanager
def recording_feedback_gather(key: str):
    """Record the inputs of the tracer's K5 calls (``scatter_max_points``; the grid it maxes
    into cloned before the call) and of the scatter-back's backward gathers
    (``scatter_back_bwd_many``; the cotangents cloned) under ``key``. The calls go on
    unchanged and count their launches."""
    from wisp_tpu_torch.ops import compaction
    from wisp_tpu_torch.tracers import packed_rf_tracer as tr
    k5, bwd = tr.scatter_max_points, compaction.scatter_back_bwd_many
    rec = FEEDBACK_GATHER_CALLS.setdefault(key, {"k5": [], "gather": []})

    def rec_k5(points, density, level, out=None, keep=None):
        rec["k5"].append((points, density, level, None if out is None else out.clone(),
                          keep))
        return k5(points, density, level, out=out, keep=keep)

    def rec_bwd(grads, idx, k):
        grads = list(grads)
        rec["gather"].append(([g.clone() for g in grads], idx, k))
        return bwd(grads, idx, k)

    with mock.patch.object(tr, "scatter_max_points", rec_k5), \
            mock.patch.object(compaction, "scatter_back_bwd_many", rec_bwd):
        yield


def grid_equal(a, b) -> bool:
    """K5's contract: the same grid, NaN where the other has NaN (the kernel writes one NaN
    pattern, PyTorch another)."""
    import torch
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(0.0),
                                                              b.nan_to_num(0.0))


def feedback_work(rec) -> dict:
    """A recorded K5 call's sizes and compulsory bytes: 12 bytes of point and the density's
    bytes (1 of mask) a sample, 4 bytes a touched cell (a cell some kept sample with a
    positive or NaN density reaches)."""
    import torch
    from wisp_tpu_torch.ops.density_grid import cell_ids
    pts, dens, level, start, keep = rec
    k = pts.shape[0]
    hits = (dens.float() > 0) | dens.isnan()
    if keep is not None:
        hits = hits & keep
    touched = int(torch.unique(cell_ids(pts, level)[hits]).numel())
    return {"samples": k, "samples_kept": k if keep is None else int(keep.sum()),
            "cells_touched": touched, "level": level, "density_dtype": str(dens.dtype),
            "density_stride": dens.stride(0), "masked": keep is not None,
            "carried_grid": start is not None,
            "bytes": k * (12 + dens.element_size() + (0 if keep is None else 1)) + touched * 4}


def feedback_calls(rec, held: bool = False):
    """(new, plain, earlier design) callers of a recorded K5 call as the path made it: into
    a fresh grid (with its zero fill), or into a fresh copy of the carried grid; ``held``
    (for timing): each caller maxes into one copy of the carried grid, or of a zero grid
    for a fresh one, made here, so that a call times the kernel and what feeds it alone."""
    import torch
    from wisp_tpu_torch.ops.density_grid import scatter_max_points, scatter_max_points_plain
    pts, dens, level, start, keep = rec

    def with_grid(fn):
        if held:
            grid = (torch.zeros((8 ** level,), dtype=torch.float32, device=pts.device)
                    if start is None else start.clone())
            return lambda: fn(pts, dens, level, grid, keep)
        return lambda: fn(pts, dens, level, None if start is None else start.clone(), keep)

    return (with_grid(scatter_max_points), with_grid(scatter_max_points_plain),
            FEEDBACK_GATHER_V1 and with_grid(FEEDBACK_GATHER_V1.scatter_max_points))


def feedback_row(name, replaces, rec):
    """K5's ``kernels`` row on a recorded call: held exactly to its plain version, timed as
    the path calls it, beside the earlier design with the lookup's launches in front
    (``was_ms``) and ``scatter_reduce_`` over precomputed ids (``library_ms``: not the same
    function, no cell lookup)."""
    import torch
    from wisp_tpu_torch.ops.density_grid import cell_ids
    pts, dens, level, start, keep = rec
    new, plain, was = feedback_calls(rec)
    got, want = new(), plain()
    err = 0.0 if grid_equal(got, want) else float((got - want).nan_to_num(0.0).abs().max())
    if start is not None:           # the carried grid: no copy of it in the timed calls
        new, plain, was = feedback_calls(rec, held=True)
    work = feedback_work(rec)
    ids = cell_ids(pts, level)
    vals = dens.float()
    if keep is not None:
        ids, vals = ids[keep], vals[keep]
    lib = torch.zeros_like(got) if start is None else start.clone()
    row = kernel_row(name, "wisp_tpu_torch/csrc/scatter_max.cu", replaces, err, 0.0,
                     timed(new), timed(plain), work["bytes"], 0.0,
                     library_ms=timed(lambda: lib.scatter_reduce_(0, ids, vals, "amax",
                                                                  include_self=True)))
    row.update(work)
    row["library_call"] = ("scatter_reduce_(0, ids, values, 'amax') over precomputed cell ids "
                           "into a held grid: not the same function (no cell lookup, no "
                           "zero fill)")
    if start is None:               # a fresh grid: ms has its zero fill; the kernel alone
        kernel_t = timed(feedback_calls(rec, held=True)[0])
        row.update(kernel_ms=kernel_t[0], kernel_event_ms=kernel_t[1])
    check = feedback_calls(rec)[2]
    return add_launches_and_was(row, new, was, lambda: grid_equal(check(), want),
                                FEEDBACK_GATHER_V1_DESIGN["scatter_max"])


def gather_work(rec) -> dict:
    """A recorded gather's sizes and compulsory bytes: 8 bytes of index a slot, each
    channel's row read at a live slot and written at every slot."""
    import math
    grads, idx, k = rec
    cols = sum(math.prod(g.shape[1:]) for g in grads)
    live = int((idx[:k] < grads[0].shape[0]).sum())
    return {"slots": k, "live_slots": live, "channels": [list(g.shape[1:]) for g in grads],
            "columns": cols, "bytes": k * 8 + live * cols * 4 + k * cols * 4}


def gather_row(rec):
    """K3's scatter-back backward row on a recorded gather (colour's and density's
    cotangents): held exactly to its plain version, timed beside the earlier design (a
    launch a channel, density through the select view's backward: ``was_ms``) and
    ``index_select`` of the colour rows alone (``library_ms``)."""
    import functools as ft
    from wisp_tpu_torch.ops.compaction import (scatter_back_bwd_many,
                                               scatter_back_bwd_many_plain)
    grads, idx, k = rec
    new = ft.partial(scatter_back_bwd_many, grads, idx, k)
    plain = ft.partial(scatter_back_bwd_many_plain, grads, idx, k)
    was = FEEDBACK_GATHER_V1 and ft.partial(FEEDBACK_GATHER_V1.scatter_back_bwd_many, grads,
                                            idx, k)
    got, want = new(), plain()
    err = max([float((a.reshape(-1) - b.reshape(-1)).abs().max()) if k else 0.0
               for a, b in zip(got, want)])
    work = gather_work(rec)
    sel = idx[:k]
    library = (timed(lambda: grads[0].index_select(0, sel))
               if work["live_slots"] == k else None)
    row = kernel_row("scatter_back_bwd", "wisp_tpu_torch/csrc/compaction.cu",
                     "wisp_tpu/tracers/packed_rf_tracer.py:214", err, 0.0, timed(new),
                     timed(plain), work["bytes"], 0.0, library_ms=library)
    row.update(work)
    row["library_call"] = ("index_select of the colour cotangent's rows alone: no single "
                           "PyTorch call gathers both channels")

    def was_equal():
        return all(a.reshape(-1).equal(b.reshape(-1)) for a, b in zip(was(), want))

    return add_launches_and_was(row, new, was, was_equal,
                                FEEDBACK_GATHER_V1_DESIGN["scatter_back_bwd"])


def feedback_gather_phase() -> dict:
    """K5 and K3's scatter-back backward on the calls that the flagship's and the seg phase's
    step 25 made (FEEDBACK_GATHER_CALLS: the flagship's K5 into a fresh grid and its gather
    of colour and density, the seg step's four segments' K5 into the carried grid and
    their four gathers): each new kernel exactly equal to its plain version and to the
    earlier design with the launches in front of it, one hand-written launch a call, timed
    beside that design (device ms, event ms) with the device kernels a call of each; the
    device kernels of a profiled flagship and seg step; then FEEDBACK_GATHER_BACK_TO_BACK
    calls back to back on one stream, the calls in turns, each call's last result held
    equal to its first."""
    import torch
    from wisp_tpu_torch import kernels
    from wisp_tpu_torch.ops.compaction import (scatter_back_bwd_many,
                                               scatter_back_bwd_many_plain)
    recs = {k: FEEDBACK_GATHER_CALLS.get(k, {}) for k in ("train step 25", "seg step 25")}
    counts = {k: (len(r.get("k5", ())), len(r.get("gather", ()))) for k, r in recs.items()}
    require(counts == {"train step 25": (1, 1), "seg step 25": (SEG_COUNT, SEG_COUNT)},
            f"K5 calls and gathers recorded: {counts}")
    out = {"was_design": FEEDBACK_GATHER_V1_DESIGN,
           "steps": {k: FEEDBACK_GATHER_CALLS.get(k) for k in ("flagship step", "seg step")}}
    callers = []

    def hand_launches(counter, fn):
        before = kernels.LAUNCHES[counter]
        result = fn()
        return result, kernels.LAUNCHES[counter] - before

    with torch.no_grad():
        for key, rec in recs.items():
            for i, call in enumerate(rec["k5"]):
                name = f"{key}: K5 {i}"
                new, plain, was = feedback_calls(call)
                counter = "scatter_max" if call[3] is None else "scatter_max_acc"
                want = plain()
                got, hand = hand_launches(counter, new)
                require(grid_equal(got, want) and grid_equal(was(), want),
                        f"{name}: (new, earlier design) equal to the plain version: "
                        f"{(grid_equal(got, want), grid_equal(was(), want))}")
                require(hand == 1, f"{name}: {hand} launches a call, not one")
                callers.append((name, new, got, grid_equal))
                # timed as the path calls it (a fresh grid: with its zero fill), the carried
                # grid held; "kernel_ms": into a held grid, the kernel and what feeds it alone
                if call[3] is not None:
                    new, _, was = feedback_calls(call, held=True)
                held_new, _, held_was = feedback_calls(call, held=True)
                new_t, was_t = timed(new), timed(was)
                kernel_t, was_kernel_t = timed(held_new), timed(held_was)
                work = feedback_work(call)
                out[name] = {**work, "exact": True, "ms": new_t[0], "event_ms": new_t[1],
                             "was_ms": was_t[0], "was_event_ms": was_t[1],
                             "kernel_ms": kernel_t[0], "was_kernel_ms": was_kernel_t[0],
                             "bound_ms": bound(work["bytes"], 0)[0],
                             "hand_written_launches_per_call": hand,
                             "launches_per_call": launches_per_call(new),
                             "was_launches_per_call": launches_per_call(was)}
            for i, (grads, idx, k) in enumerate(rec["gather"]):
                name = f"{key}: gather {i}"
                want = scatter_back_bwd_many_plain(grads, idx, k)
                got, hand = hand_launches("scatter_back_bwd",
                                          lambda: scatter_back_bwd_many(grads, idx, k))
                was = FEEDBACK_GATHER_V1.scatter_back_bwd_many(grads, idx, k)

                def same(a, b):
                    return all(x.reshape(-1).equal(y.reshape(-1)) for x, y in zip(a, b))

                require(same(got, want) and same(was, want),
                        f"{name}: (new, earlier design) equal to the plain version: "
                        f"{(same(got, want), same(was, want))}")
                require(hand == (1 if k else 0), f"{name}: {hand} launches a call, not one")
                new_call = functools.partial(scatter_back_bwd_many, grads, idx, k)
                was_call = functools.partial(FEEDBACK_GATHER_V1.scatter_back_bwd_many, grads,
                                             idx, k)
                new_t, was_t = timed(new_call), timed(was_call)
                work = gather_work((grads, idx, k))
                out[name] = {**work, "exact": True, "ms": new_t[0], "event_ms": new_t[1],
                             "was_ms": was_t[0], "was_event_ms": was_t[1],
                             "bound_ms": bound(work["bytes"], 0)[0],
                             "hand_written_launches_per_call": hand,
                             "launches_per_call": launches_per_call(new_call),
                             "was_launches_per_call": launches_per_call(was_call)}
                callers.append((name, new_call, got, same))
        torch.cuda.synchronize()
        last = {}
        for i in range(FEEDBACK_GATHER_BACK_TO_BACK):
            name, call, _, _ = callers[i % len(callers)]
            last[name] = call()
        torch.cuda.synchronize()
        for name, _, first, same in callers:
            require(same(last[name], first), f"{name}, called back to back, differs from its "
                                             f"first result")
    out["back_to_back_calls"] = FEEDBACK_GATHER_BACK_TO_BACK
    out["gather_order"] = "the backward's: a seg step's gather 0 is its last segment's"
    return out


# the K2/K8 and K15 backward calls that the paths made, for the "march and octree grad"
# step: key -> {"kind": counter name, "args": the wrapper's arguments (cloned)}
MARCH_GRAD_CALLS = {}


def march_grad_record(key, kind, args):
    """Keep one call's inputs under ``key``: K2/K8 (``kind`` its counter; ``args`` those of
    ``octree_as._march`` after the counter) or K15's backward (``octree_interp_bwd``'s)."""
    import torch

    def copy(a):
        if isinstance(a, torch.Tensor):
            return a.detach().clone()
        return [copy(x) for x in a] if isinstance(a, (list, tuple)) else a

    MARCH_GRAD_CALLS[key] = {"kind": kind, "args": tuple(copy(a) for a in args)}


@contextmanager
def recording_march_grad(key: str):
    """Keep the inputs of the last K2 or K8 march and the last K15 backward launched
    inside, under "<key>: <counter>", held and copied when the block ends (no input of
    either is changed inside a block that uses this; held, so that a loop of steps pays no
    copies)."""
    from wisp_tpu_torch.accelstructs import octree_as
    from wisp_tpu_torch.models.grids import octree_grid
    march, bwd = octree_as._march, octree_grid.octree_interp_bwd
    held = {}

    def rec_march(counter, *args):
        held[counter] = args
        return march(counter, *args)

    def rec_bwd(*args):
        held["octree_interp_bwd"] = args
        return bwd(*args)

    with mock.patch.object(octree_as, "_march", rec_march), \
            mock.patch.object(octree_grid, "octree_interp_bwd", rec_bwd):
        yield
    for kind, args in held.items():
        march_grad_record(f"{key}: {kind}", kind, args)


def k15_bwd_counts(coords, pidx, col0, trinkets, rows, f_dim, levels) -> list:
    """Per LOD of a K15 backward call: its row adds (8 a point in an occupied cell), the
    distinct rows they touch, the most adds to one row, the table's rows and whether the
    redesign sums the LOD in shared memory first (``bwd_shared_lods``)."""
    import torch
    from wisp_tpu_torch.models.grids.octree_grid import bwd_shared_lods
    shared = bwd_shared_lods(rows, f_dim, coords.shape[0])
    out = []
    for i, level in enumerate(levels):
        p = pidx[:, col0 + i]
        valid = p >= 0
        corner_rows = trinkets[i][p[valid].long()].reshape(-1).long()
        counts = (torch.bincount(corner_rows) if corner_rows.numel()
                  else torch.zeros(1, dtype=torch.long))
        out.append({"level": int(level), "points": int(valid.sum()),
                    "adds": int(corner_rows.numel()), "rows": int((counts > 0).sum()),
                    "most_adds_to_a_row": int(counts.max()), "table_rows": int(rows[i]),
                    "shared": bool(shared[i])})
    return out


def march_grad_phase() -> dict:
    """K2/K8 and K15's backward at every call the paths recorded (K2: the render chunk,
    train step 25 jittered, the seg and stoch steps; K8: the uniform chunk and uniform step
    20 jittered; K15 backward: the octree NeRF's F = 5 call of its kernel phase and its step
    25, the SDF train batch, an NGLOD app step and a level-8 step): both designs held to
    the plain version (K2/K8 bit for bit; K15's backward within 1e-5 of the largest entry)
    and timed side by side, with their launches a call, the event ms less the device ms a
    call (``host_ms``), the wrappers' own host time a call (``wrapper_host_ms``) and the
    redesign's device ms by kernel (the backward's zero fill and its kernel); for K15's
    backward, each LOD's adds, distinct rows, most adds to a row and route. Then 200 calls of the redesign back to back on one stream with no
    synchronisation between them, the shapes in turns, each shape's last result held to
    its first (K2/K8 equal, K15's backward within its tolerance)."""
    import torch
    from wisp_tpu_torch.accelstructs import octree_as
    from wisp_tpu_torch.models.grids import octree_grid
    require(MARCH_GRAD_CALLS, "no phase recorded a K2/K8 or K15 backward call")
    out, checks = {}, []
    for key, c in sorted(MARCH_GRAD_CALLS.items()):
        args = c["args"]
        if c["kind"] == "octree_interp_bwd":
            coords, pidx, col0, trinkets, rows, f_dim, levels, multiscale, g = args
            run_new = functools.partial(octree_grid.octree_interp_bwd, *args)
            run_was = functools.partial(MARCH_GRAD_V1.interp_bwd, *args)
            want = octree_grid.octree_interp_bwd_plain(*args)
            tol = 1e-5 * max(float(w.abs().max()) for w in want)
            errs = [max(float((a - w).abs().max()) for a, w in zip(f(), want))
                    for f in (run_new, run_was)]
            require(all(e <= tol for e in errs), f"K15 backward at {key}: max abs err (new, "
                                                 f"earlier) {errs}, tolerance {tol}")
            shape = {"points": coords.shape[0], "F": f_dim, "lods": len(levels),
                     "multiscale": multiscale, "table_rows": sum(rows),
                     "max_abs_err": errs[0], "was_max_abs_err": errs[1], "tol": tol,
                     "by_lod": k15_bwd_counts(coords, pidx, col0, trinkets, rows, f_dim,
                                              levels)}

            def same(a, b, tol=tol):
                return max(float((x - y).abs().max()) for x, y in zip(a, b)) <= tol
            design = MARCH_GRAD_V1_DESIGN["octree_interp_bwd"]
        else:
            o, d, lo, hi, s, stride, field, level, jitter, ustep = args
            run_new = functools.partial(octree_as._march, c["kind"], *args)
            run_was = functools.partial(MARCH_GRAD_V1.march, *args)
            plain = (octree_as.raymarch_ray_plain if c["kind"] == "raymarch_ray"
                     else octree_as.raymarch_uniform_plain)
            want = plain(*args[:-1])
            require(march_equal(run_new(), want) and march_equal(run_was(), want),
                    f"{c['kind']} at {key}: a design differs from the plain version")
            shape = {"rays": o.shape[0], "samples": s, "stride": stride,
                     "jittered": jitter is not None, "field": field is not None,
                     "valid": int(want.mask.sum()), "max_abs_err": 0, "tol": 0}
            same = march_equal
            design = MARCH_GRAD_V1_DESIGN["march"]
        with torch.no_grad():
            new, was = timed(run_new), timed(run_was)
            host = host_ms_in_turns((run_new, run_was))
            out[key] = dict(shape, ms=new[0], event_ms=new[1], host_ms=new[1] - new[0],
                            wrapper_host_ms=host[0], ms_by_kernel=device_ms_by_kernel(run_new),
                            launches_per_call=launches_per_call(run_new), was_ms=was[0],
                            was_event_ms=was[1], was_host_ms=was[1] - was[0],
                            was_wrapper_host_ms=host[1],
                            was_launches_per_call=launches_per_call(run_was),
                            was_design=design)
            checks.append((key, run_new, run_new(), same))
    torch.cuda.synchronize()
    last = {}
    with torch.no_grad():
        for i in range(200):
            key, run_new, _, _ = checks[i % len(checks)]
            last[key] = run_new()
    torch.cuda.synchronize()
    for key, _, ref, same in checks:
        require(same(last[key], ref), f"{key}, called back to back, differs from its first "
                                      f"result")
    out["ptxas"] = mesh_ptxas()
    return out


# the K16 and K17 calls that the paths made, for the "mesh" step: key -> {"kind": counter
# name, "points", "tris"}
MESH_CALLS = {}


@contextmanager
def recording_mesh(key: str):
    """Keep the inputs of the last K16 and the last K17 call launched inside, under
    "<key>: <counter>", copied when the block ends (neither input is changed inside)."""
    from wisp_tpu_torch.ops.mesh import closest_tex, compute_sdf
    sdf, closest = compute_sdf.mesh_sdf, closest_tex.closest_point
    held = {}

    def rec_sdf(points, tris):
        held["mesh_sdf"] = (points, tris)
        return sdf(points, tris)

    def rec_closest(points, tris):
        held["closest_point"] = (points, tris)
        return closest(points, tris)

    with mock.patch.object(compute_sdf, "mesh_sdf", rec_sdf), \
            mock.patch.object(closest_tex, "closest_point", rec_closest):
        yield
    for kind, (points, tris) in held.items():
        MESH_CALLS[f"{key}: {kind}"] = {"kind": kind, "points": points.detach().clone(),
                                        "tris": tris.detach().clone()}


def l_prism_mesh():
    """Watertight non-convex L-shaped prism with a concave edge along z (the mesh of
    tests/core/test_compute_sdf.py)."""
    import numpy as np
    outline = np.array([[0, 0], [2, 0], [2, 1], [1, 1], [1, 2], [0, 2]], np.float32)
    n = len(outline)
    bot = np.concatenate([outline, np.full((n, 1), -0.5, np.float32)], -1)
    top = np.concatenate([outline, np.full((n, 1), 0.5, np.float32)], -1)
    cap = np.array([[0, 1, 2], [0, 2, 3], [0, 3, 4], [0, 4, 5]], np.int32)
    sides = []
    for i in range(n):
        j = (i + 1) % n
        sides += [[i, j, j + n], [i, j + n, i + n]]
    return (np.concatenate([bot, top], 0),
            np.concatenate([cap[:, ::-1], cap + n, np.asarray(sides, np.int32)], 0))


def bipyramid_mesh(sides: int = 16, radius: float = 0.6, height: float = 0.5):
    """A closed bipyramid: a regular ``sides``-gon of ``radius`` in z = 0 and two apexes at
    z = +-``height``, each of valence ``sides``; 2 * ``sides`` outward triangles."""
    import numpy as np
    ang = 2.0 * np.pi * np.arange(sides) / sides
    ring = np.stack([radius * np.cos(ang), radius * np.sin(ang), np.zeros(sides)], -1)
    v = np.concatenate([ring, [[0.0, 0.0, height], [0.0, 0.0, -height]]]).astype(np.float32)
    f = []
    for k in range(sides):
        j = (k + 1) % sides
        f += [[k, j, sides], [j, k, sides + 1]]
    return v, np.asarray(f, np.int32)


MESH_HARD_POINTS = 2000


def mesh_hard_cases(dev) -> dict:
    """The hard meshes of the "mesh" step, name -> (points [N, 3], triangle table): a cube's
    corners and edges, a thin slab's midplane and an L-prism's concave edge (the queries of
    tests/core/test_compute_sdf.py), and a closed 16-sided bipyramid whose apexes have
    valence 16 (points near each apex, on its axis and at the centre take K16's overflow
    path); each with MESH_HARD_POINTS seeded points around it."""
    import numpy as np
    import torch
    from wisp_tpu_torch.ops.mesh.compute_sdf import triangle_table
    from wisp_tpu_torch.ops.mesh.io import make_box_mesh
    rng = np.random.default_rng(14)
    apexes = np.asarray([[0.0, 0.0, 0.5], [0.0, 0.0, -0.5]])
    bipyramid_pts = np.concatenate([
        [[0.0, 0.0, 0.0], [0.0, 0.0, 0.55], [0.0, 0.0, -0.52], [0.0, 0.0, 0.3]],
        apexes[rng.integers(0, 2, 300)] + rng.normal(scale=0.02, size=(300, 3))])
    cases = {}
    for name, mesh, pts, lo, hi in (
            ("cube", make_box_mesh((0.5, 0.5, 0.5)),
             [[0.6, 0.6, 0.6], [0.55, 0.55, 0.0], [0.49, 0.49, 0.0], [0.0, 0.0, 0.0]],
             -0.8, 0.8),
            ("slab", make_box_mesh((1.0, 1.0, 0.02)),
             [[0.0, 0.0, 0.0], [0.5, -0.3, 0.0], [1.001, 0.0, 0.0], [0.999, 0.999, 0.0]],
             -1.2, 1.2),
            ("l_prism", l_prism_mesh(),
             [[1.05, 1.05, 0.0], [0.95, 0.95, 0.0], [1.05, 1.05, 0.49]], -0.3, 2.3),
            ("bipyramid", bipyramid_mesh(), bipyramid_pts, -0.8, 0.8)):
        pts = np.concatenate([pts, rng.uniform(lo, hi, (MESH_HARD_POINTS - len(pts), 3))])
        cases[name] = (torch.from_numpy(pts.astype(np.float32)).to(dev),
                       triangle_table(*mesh, dev))
    return cases


def mesh_ptxas() -> list:
    """Each kernel of csrc/mesh_sdf.cu as ptxas built it (``build.log`` beside the library):
    registers, spills, static shared memory and the blocks of 128 threads an SM that
    registers and shared memory allow (65,536 registers, 228 KB, 16 blocks at most)."""
    import re
    from pathlib import Path
    from wisp_tpu_torch import kernels
    kernels_, section = [], False
    log = Path(kernels.BUILD_INFO["path"]).parent / "build.log"
    for line in (log.read_text() if log.exists() else "").splitlines():
        if line.startswith("=="):
            section = line.strip() == "== mesh_sdf.cu"
        elif section and "Compiling entry function" in line:
            name = re.search(r"(mesh_sdf_kernel|closest_point_kernel)ILi(\d)E", line)
            kernels_.append({"kernel": f"{name.group(1)}<{name.group(2)}>" if name else line})
        elif section and kernels_ and "spill" in line:
            kernels_[-1]["spill"] = line.strip()
        elif section and kernels_ and "registers" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            smem = int(smem.group(1)) if smem else 0
            kernels_[-1].update(registers=regs, smem=smem, blocks_per_sm=min(
                65536 // (-(-regs // 8) * 8 * 128), 228 * 1024 // (smem + 1024), 16))
    return kernels_


MESH_BACK_TO_BACK = 50


def mesh_phase(dev) -> dict:
    """K16 and K17 at every call the paths recorded (the SDF train phase's resample and
    validate(), the NGLOD texture dataset's resample) and on the hard meshes: both designs
    held to the plain version (K16: the distance within 1e-5, a sign flip only where
    |d| < 1e-5, the signs the winding number's where |d| >= 1e-5; K17: distance and point
    within 1e-6, the triangle equal but for ties within 2 ulp of d^2), with whether each
    result equals the plain version's bit for bit (K16: its absolute value, since PyTorch
    sums the votes in its own order); timed side by side with its launches a call, its
    bound and share of it and, for K16, the band's pairs and the points whose band holds
    more than MESH_SDF_CANDIDATES triangles (they take the overflow path; counted from the
    plain arithmetic in torch, not by the kernel). Then MESH_BACK_TO_BACK calls of the
    redesign back to back on one stream, the shapes in turns, each shape's last result held
    equal to its first."""
    import torch
    from wisp_tpu_torch.ops.mesh.compute_sdf import (MESH_SDF_CANDIDATES, closest_point,
                                                     closest_point_plain, mesh_sdf,
                                                     mesh_sdf_plain)
    kinds = {c["kind"] for c in MESH_CALLS.values()}
    require(kinds == {"mesh_sdf", "closest_point"},
            f"the phases recorded K16 and K17 calls of kinds {kinds}")
    calls = dict(MESH_CALLS)
    for name, (points, tris) in mesh_hard_cases(dev).items():
        for kind in ("mesh_sdf", "closest_point"):
            calls[f"{name}: {kind}"] = {"kind": kind, "points": points, "tris": tris}
    out, checks = {}, []
    for key, c in calls.items():
        points, tris = c["points"], c["tris"]
        n, t = points.shape[0], tris.shape[0]
        if c["kind"] == "mesh_sdf":
            run_new = functools.partial(mesh_sdf, points, tris)
            run_was = functools.partial(MESH_V1.mesh_sdf, points, tris)
            want = mesh_sdf_plain(points, tris)
            inside = winding_inside(points, tris)
            far = want.abs() >= 1e-5
            results = {}
            for design, got in (("new", run_new()), ("was", run_was())):
                err, flips, far_flips = sdf_mismatch(got, want)
                wrong = int(((got[far] < 0) != inside[far]).sum())
                require(err <= 1e-5 and far_flips == 0 and wrong == 0,
                        f"K16 ({design}) at {key}: max abs err {err}, {far_flips} sign flips "
                        f"where |d| >= 1e-5, {wrong} signs against the winding number")
                results[design] = (err, flips, bool(torch.equal(got.abs(), want.abs())))
            sizes = mesh_band_sizes(points, tris)
            over = int((sizes > MESH_SDF_CANDIDATES).sum())
            require(over > 0 or not key.startswith("bipyramid"),
                    "no point of the bipyramid has a band above the candidate list")
            nbytes = n * 16 + t * 15 * 4
            ops = mesh_sdf_ops(n, t, int(sizes.sum()))
            shape = {"max_abs_err": results["new"][0], "was_max_abs_err": results["was"][0],
                     "sign_flips": results["new"][1], "tol": 1e-5,
                     "abs_bit_equal_plain": results["new"][2],
                     "was_abs_bit_equal_plain": results["was"][2],
                     "band_pairs": int(sizes.sum()), "band_max": int(sizes.max()),
                     "band_over_candidates": over, "inside": int(inside.sum()),
                     "bound_ms_earlier_basis": bound(nbytes, n * t * MESH_SDF_PAIR_OPS)[0]}
            same = torch.equal
        else:
            run_new = functools.partial(closest_point, points, tris)
            run_was = functools.partial(MESH_V1.closest_point, points, tris)
            want = closest_point_plain(points, tris)
            got = run_new()
            err, ties = closest_mismatch(got, want, points, tris)
            was_err, was_ties = closest_mismatch(run_was(), want, points, tris)
            require(err <= 1e-6 and was_err <= 1e-6,
                    f"K17 at {key}: max abs err (new, earlier) {err}, {was_err}")
            nbytes = n * 12 + t * 9 * 4 + n * (4 + 12 + 8)
            ops = n * t * CLOSEST_PAIR_OPS + t * MESH_TRIANGLE_OPS
            shape = {"max_abs_err": err, "was_max_abs_err": was_err, "ties": ties,
                     "was_ties": was_ties, "tol": 1e-6,
                     "bit_equal_plain": all(bool(torch.equal(a, b))
                                            for a, b in zip(got, want))}

            def same(a, b):
                return all(torch.equal(x, y) for x, y in zip(a, b))
        iters = (5, 1) if n * t > 1e9 else (20, 3)
        with torch.no_grad():
            new, was = timed(run_new, *iters), timed(run_was, *iters)
        bms, by = bound(nbytes, ops)
        out[key] = dict(points=n, triangles=t, **shape, ms=new[0], event_ms=new[1],
                        was_ms=was[0], was_event_ms=was[1], bound_ms=bms, bound_by=by,
                        bound_share=bms / new[0], was_bound_share=bms / was[0],
                        launches_per_call=launches_per_call(run_new),
                        was_launches_per_call=launches_per_call(run_was),
                        was_design=MESH_V1_DESIGN)
        checks.append((key, run_new, run_new(), same))
    torch.cuda.synchronize()
    last = {}
    with torch.no_grad():
        for i in range(MESH_BACK_TO_BACK):
            key, run_new, _, _ = checks[i % len(checks)]
            last[key] = run_new()
    torch.cuda.synchronize()
    for key, _, ref, same in checks:
        require(same(last[key], ref), f"{key}, called back to back, differs from its first "
                                      f"result")
    out["ptxas"] = mesh_ptxas()
    return out

def profile_call(fn, top: int = 12):
    """(wall ms, device busy ms, the ``top`` kernels by device time, the device kernels
    launched) of one call of ``fn`` under torch.profiler. The busy time is the sum of the
    kernels' device time (kernels on one stream do not overlap), so 1 - busy / wall is the
    device's idle share. Busy time and launches are None when the session recorded no
    kernel (``PROFILER_FALLBACKS`` then names the call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, top_kernels = device_kernels(prof, top)
    launches = sum(k["count"] for k in device_kernels(prof, None)[1])
    if not top_kernels:
        PROFILER_FALLBACKS.append({"profile": call_name(fn), "device_busy_ms": "not measured"})
        busy_ms = launches = None
    return wall_ms, busy_ms, top_kernels, launches


def idle_share(busy_ms, wall_ms):
    """The device's idle share of a profiled call, None where it was not measured."""
    return 1.0 - busy_ms / wall_ms if busy_ms is not None and wall_ms > 0 else None


def profile_frame(renderer, pipeline, top: int = 12) -> dict:
    """One frame under torch.profiler: device time by kernel name, the device kernels it
    launched (the hand-written ones and PyTorch's) and the share of the frame's wall time in
    which no kernel ran."""
    wall_ms, busy_ms, top_kernels, launches = profile_call(
        lambda: renderer.render_lookat(pipeline, f=EYE), top)
    return {"profile_frame_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": idle_share(busy_ms, wall_ms),
            "device_launches": launches, "top_device_kernels": top_kernels}


def device_kernels(prof, top: int):
    """(device busy ms, the ``top`` kernels by device time, all of them for None) of a
    profile: the sum of the kernels' own device time (kernels on one stream do not
    overlap), leaving out annotated ranges such as ``Optimizer.step``, whose device time is
    their kernels'."""
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
    from wisp_tpu_torch.ops.compaction import compact, compaction_budget, scatter_back
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
    # bytes: the coords and the computed LODs' cotangent read once, the whole table gradient
    # (which the op returns dense) written once
    row("hashgrid_bwd", "wisp_tpu_torch/csrc/hashgrid.cu", "wisp_tpu/ops/grid.py:55",
        float((hk - hp).abs().max()), 1e-5 * scale,
        timed(lambda: grid_ops.hashgrid_bwd(coords, g_feat, *args,
                                              out_lods=grid.num_lods)),
        timed(lambda: grid_ops.hashgrid_bwd_plain(coords, g_feat, *args,
                                                    out_lods=grid.num_lods), iters=3),
        nbytes=kept * 12 + kept * n_lods * f_dim * 4 + args[3] * f_dim * 4,
        ops=kept * n_lods * (9 + 8 * (2 + 2 * f_dim)))
    add_launches_and_was(
        rows[-1], lambda: grid_ops.hashgrid_bwd(coords, g_feat, *args, out_lods=grid.num_lods),
        HASHGRID_V1 and (lambda: HASHGRID_V1.hashgrid_bwd(coords, g_feat, *args,
                                                          out_lods=grid.num_lods)),
        lambda: float((HASHGRID_V1.hashgrid_bwd(coords, g_feat, *args, out_lods=grid.num_lods)
                       - hp).abs().max()) <= 1e-5 * scale, HASHGRID_V1_DESIGN)
    rows[-1].update(table_rows=args[3], shared_lods=grid_ops.shared_lods(
        grid.codebook.resolutions, grid.codebook_bitwidth, 3, f_dim, n_lods,
        grid_ops.SHARED_LOD_BYTES))

    # K3's scatter-back backward: the gather of colour's and density's cotangents, as step
    # 25 made it
    rows.append(gather_row(FEEDBACK_GATHER_CALLS["train step 25"]["gather"][0]))
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

    # K5 on step 25's points and densities, as the tracer called it
    rows.append(feedback_row("scatter_max", "wisp_tpu/tracers/packed_rf_tracer.py:255",
                             FEEDBACK_GATHER_CALLS["train step 25"]["k5"][0]))
    return rows, {"rays": r, "valid": valid, "budget": budget, "kept": kept,
                  "trained_lods": n_lods}


def profile_step(trainer, top: int = 12) -> dict:
    """One training step under torch.profiler: device time by kernel and the idle share."""
    wall_ms, busy_ms, top_kernels, launched = profile_call(trainer.iterate, top)
    return {"profile_step_ms": wall_ms, "step_device_busy_ms": busy_ms,
            "step_device_idle_share": idle_share(busy_ms, wall_ms),
            "step_device_kernels": launched, "step_top_device_kernels": top_kernels}


def step_kernels(profiled: dict, launches: dict, steps: int) -> dict:
    """A path's profiled step's device kernels and busy ms, and the hand-written launches a
    step of K5 and K3's scatter-back both ways over its ``steps`` steps."""
    names = ("scatter_max", "scatter_max_acc", "scatter_back", "scatter_back_bwd")
    return {"profiled_step_device_kernels": profiled.get("step_device_kernels"),
            "profiled_step_device_busy_ms": profiled.get("step_device_busy_ms"),
            "launches_a_step": {k: launches[k] / steps for k in names}}


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
            with recording_k1("prune", copy_at_exit=True):
                t0 = time.perf_counter()
                trainer.prune()      # the method pre_step calls on its cadence
                torch.cuda.synchronize()
                prune_ms = (time.perf_counter() - t0) * 1e3
            prune = {"prune_ms": prune_ms,
                     "cells_fed_by_training_samples": fed,
                     "occupancy_after_prune": float(nef.grid.blas.occ_grid.float().mean())}
        rays = trainer.train_dataset.transform.num_samples
        budget = tracer.compaction
        if i == TRAIN_STEPS_BEFORE_PRUNE - 1:
            profiled = profile_step(trainer)     # step 20 runs under the profiler
            ms = profiled["profile_step_ms"]
        else:
            t0 = time.perf_counter()
            if i == TRAIN_STEPS_BEFORE_PRUNE + TRAIN_STEPS_AFTER_PRUNE - 1:
                with recording_k1("train step 25"), recording_march_grad("train step 25"), \
                        recording_feedback_gather("train step 25"):
                    trainer.iterate()
            else:
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
    FEEDBACK_GATHER_CALLS["flagship step"] = step_kernels(profiled, launches, len(steps))
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
SDF_KERNELS = ("octree_query_interp", "sphere_iter", "free_space_distance", "sdf_walk",
               "sphere_step")
# the icosphere's facets lie between radius 0.897 (face centres) and 0.9 (vertices): a
# zero set off that band leaves the one-voxel shell of occupied cells, and rays that miss
# the shell's zero crossing do not hit
SDF_RADIUS = 0.8985
SDF_FD_TAPS = 6                # finitediff_gradient's field queries for the normals
SDF_HIT_MARGIN = 1e-5          # | |sdf| - min_dis | under which a hit may flip
SDF_DEPTH_TOL = 1e-4           # depth and xyz on rays that hit in both traces
SDF_NORMAL_TOL = 1e-4


def sphere_octree(device):
    """main_nglod.py:61-69: the icosphere (subdivisions 3, normalized to 'sphere'), its
    SDF_SAMPLES surface samples quantized into a level-SDF_LEVEL octree that carries the
    mesh as ``extent``."""
    from wisp_tpu_torch.accelstructs.octree_as import MeshExtent, OctreeAS
    from wisp_tpu_torch.ops.mesh.io import make_sphere_mesh
    from wisp_tpu_torch.ops.mesh.ops import normalize, sample_surface
    from wisp_tpu_torch.ops.spc.core import quantize_points_np
    v, f = normalize(*make_sphere_mesh(radius=1.0, subdivisions=3), "sphere")
    samples = sample_surface(v, f, SDF_SAMPLES)
    blas = OctreeAS.from_quantized_points(quantize_points_np(samples, SDF_LEVEL), SDF_LEVEL,
                                          device=device)
    blas.extent = MeshExtent(v, f)
    return blas


def nglod_pipeline(device):
    """app/nglod/configs/nglod_octree.yaml at full width on main_nglod.py's procedural
    icosphere (main_nglod.py:61-66: subdivisions 3, normalized to 'sphere', 2,000,000
    surface samples, octree level 7). The feature grid keeps its config init (std 0.01,
    seeded); the decoder is ``interop.sphere_sdf_decoder``, under which the field is close
    to |x| - SDF_RADIUS (random decoder weights give no distance function, and a sphere
    tracer then hits almost nothing)."""
    import torch
    from wisp_tpu_torch import interop
    from wisp_tpu_torch.models.grids.octree_grid import OctreeGrid
    from wisp_tpu_torch.models.nefs.neural_sdf import NeuralSDF
    from wisp_tpu_torch.models.pipeline import Pipeline
    from wisp_tpu_torch.ops.spc.core import make_dual
    from wisp_tpu_torch.tracers.packed_sdf_tracer import PackedSDFTracer
    blas = sphere_octree(device)
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
    with mock.patch.object(octree_as, "free_space_distance",
                              octree_as.free_space_distance_plain), \
            mock.patch.object(octree_grid, "octree_query_interp", query_interp_plain), \
            mock.patch.object(sdf, "sdf_walk", sdf.sdf_walk_plain), \
            mock.patch.object(sdf, "sphere_step", sdf.sphere_step_plain), \
            mock.patch.object(sdf, "sphere_iter", sdf.sphere_iter_plain):
        yield


def walk_work(o, d, t, alive, t_far, free_dist, level: int, num_steps: int) -> dict:
    """The walk's data-dependent work, counted with its plain operations: the steps taken
    over all rays, the distinct cells of the free-space field read, the most steps one ray
    takes (``longest_walk``), the steps that take the walker's far step (rule (b) of
    ``csrc/sphere_walker.cuh``: the skip, no division), and the warp-steps (32 consecutive
    rays, one step, some lane advancing) whose advancing lanes mix far and full steps (the
    warp then runs both)."""
    import torch
    import torch.nn.functional as F
    from wisp_tpu_torch.tracers.packed_sdf_tracer import OUTSIDE, _fsd_at, _free_step
    res, voxel = 2 ** level, 2.0 / 2 ** level
    t, alive = t.clone(), alive.clone()
    taken = torch.zeros_like(t, dtype=torch.int32)
    m = torch.where(d.abs() > 1e-12, d.abs(), torch.zeros_like(d)).amax(dim=-1)
    cells = [torch.zeros((0,), dtype=torch.int64, device=t.device)]
    far_steps = warp_steps = mixed = 0
    pad = (-t.numel()) % 32
    for _ in range(num_steps):
        k, pos = _fsd_at(o, d, t, free_dist, level)
        inside = ((pos >= -1.0) & (pos < 1.0)).all(-1)
        q = ((pos + 1.0) * (res / 2.0)).floor().long().clamp(0, res - 1)
        cells.append(((q[:, 0] * res + q[:, 1]) * res + q[:, 2])[alive & inside])
        adv = alive & (k > 0)
        skip = (k.to(torch.float32) - 1.0) * voxel
        far = adv & (k != OUTSIDE) & ((skip - 1e-3 * voxel) * m
                                      >= voxel * (1.0 + 2.0 ** -10))
        far_steps += int(far.sum())
        warp_far = F.pad(far, (0, pad)).reshape(-1, 32).any(dim=1)
        warp_full = F.pad(adv & ~far, (0, pad)).reshape(-1, 32).any(dim=1)
        warp_steps += int((warp_far | warp_full).sum())
        mixed += int((warp_far & warp_full).sum())
        taken += adv.to(torch.int32)
        t = torch.where(adv, t + _free_step(k, pos, d, voxel), t)
        alive = alive & (t <= t_far)
    return {"steps_taken": int(taken.sum()),
            "cells_read": int(torch.unique(torch.cat(cells)).numel()),
            "longest_walk": int(taken.max()) if taken.numel() else 0,
            "far_steps": far_steps, "warp_steps": warp_steps, "mixed_warp_steps": mixed}


def sdf_kernel_phase(pipeline, rays):
    """Each SDF kernel against its plain version and timed, at the shapes one chunk of the
    main path gives it: K11, the walk from the rays' entry, then at the rays' state after
    the walk and 4 sphere iterations a closing sphere step, K15's forward (the blend of the
    unfused sequence), the fused query and interpolation, and the sphere iteration with
    its step, the last two beside the unfused sequences they replace."""
    import torch
    from wisp_tpu_torch.accelstructs.octree_as import (aabb_intersect, free_space_distance,
                                                       free_space_distance_plain,
                                                       octree_query, octree_query_plain)
    from wisp_tpu_torch.models.grids.octree_grid import (_query_interp_fwd, octree_interp,
                                                         octree_interp_plain,
                                                         octree_query_interp,
                                                         octree_query_interp_plain)
    from wisp_tpu_torch.tracers.packed_sdf_tracer import (fused_field, sdf_walk,
                                                          sdf_walk_plain, sphere_iter,
                                                          sphere_iter_plain, sphere_step,
                                                          sphere_step_plain)
    nef, tracer = pipeline.nef, pipeline.tracer
    grid, blas = nef.grid, nef.grid.blas
    level, steps = blas.max_level, tracer.num_steps
    o, d = rays.origins, rays.dirs
    n = o.shape[0]
    rows = []

    def copies(*ts, iters=20):
        """Fresh inputs for each call of an in-place kernel, made before ``timed`` with
        ``iters`` starts: as many as it can make (3 warm-ups, the timed calls and every
        profiling session it may retry)."""
        count = 3 + iters * (1 + PROFILER_SESSIONS)
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
    add_launches_and_was(rows[-1], lambda: free_space_distance(occ, level),
                         OCTREE_V1 and (lambda: OCTREE_V1.free_space(occ, level)),
                         lambda: torch.equal(OCTREE_V1.free_space(occ, level), fp),
                         OCTREE_V1_DESIGN["free_space_distance"])
    k11_record(f"sdf render: K11 at level {level}", occ, level)

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
    work = walk_work(o, d, t0, a0, t_far, fk, level, steps)
    taken, walk_cells = work["steps_taken"], work["cells_read"]
    state, plain_state = copies(t0, a0), copies(t0, a0, iters=5)
    rows.append(kernel_row(
        "sdf_walk", "wisp_tpu_torch/csrc/sphere_trace.cu",
        "wisp_tpu/tracers/packed_sdf_tracer.py:121", 0.0, 0.0,
        timed(lambda: sdf_walk(o, d, *state(), t_far, fk, level, steps)),
        timed(lambda: sdf_walk_plain(o, d, *plain_state(), t_far, fk, level, steps),
              iters=5),
        nbytes=n * (24 + 4 + 1 + 4) + n * (4 + 1) + walk_cells * 4, ops=taken * 50))
    walk_args = (o, d, t0, a0, t_far, fk, level, steps)
    if SPHERE_TRACE_V1 is not None:
        walk_row_extras(rows[-1], "sdf_walk", walk_args, work)
    walk_record("sdf render chunk", "sdf_walk", walk_args)

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
    state, plain_state = copies(t, alive, hit), copies(t, alive, hit, iters=5)
    rows.append(kernel_row(
        "sphere_step", "wisp_tpu_torch/csrc/sphere_trace.cu",
        "wisp_tpu/tracers/packed_sdf_tracer.py:136", 0.0, 0.0,
        timed(lambda: sphere_step(o, d, *state(), t_far, dist, fk, level, tracer.step_size,
                                  tracer.min_dis)),
        timed(lambda: sphere_step_plain(o, d, *plain_state(), t_far, dist, fk, level,
                                        tracer.step_size, tracer.min_dis), iters=5),
        nbytes=n * (1 + 1) + live * (24 + 4 + 4 + 4 + 4) + live * (4 + 1 + 1),
        ops=live * 60))

    # K9 with parents, as OctreeGrid.interpolate asked before the fused query: K15's input
    # here (K9's row is held on the call that still reaches it, in the SDF train phase)
    routes = blas.query_routes
    qk = octree_query(coords, routes, level, True)
    require(torch.equal(qk, octree_query_plain(coords, routes, level, True)),
            "octree_query differs from the plain version")

    # K15 over the 6 LODs, 'sum' (no path launches it now: the fused query is its forward
    # with K9's lookups as the first loads; it is the unfused sequence's blend)
    lods = grid.num_lods
    args = (coords, qk, grid.base_lod, grid.trinkets, [f.detach() for f in grid.features],
            grid.active_lods, grid.multiscale_type)
    ik = octree_interp(*args)
    ip = octree_interp_plain(*args)
    f_dim = grid.feature_dim
    touched = interp_touched(grid, coords)
    interp_bytes = (touched["lod_cells_read"] * 4 + touched["trinket_rows"] * 32
                    + touched["feature_rows"] * f_dim * 4)
    interp_ops = touched["valid"] * (3 * 5 + 8 * (2 + 2 * f_dim))
    rows.append(kernel_row(
        "octree_interp", "wisp_tpu_torch/csrc/octree_grid.cu",
        "wisp_tpu/models/grids/octree_grid.py:115", float((ik - ip).abs().max()), 1e-6,
        timed(lambda: octree_interp(*args)), timed(lambda: octree_interp_plain(*args)),
        nbytes=n * 12 + n * lods * 4 + touched["trinket_rows"] * 32
        + touched["feature_rows"] * f_dim * 4 + n * f_dim * 4, ops=interp_ops))
    add_launches_and_was(rows[-1], lambda: octree_interp(*args),
                         OCTREE_V1 and (lambda: OCTREE_V1.interp(*args)),
                         lambda: float((OCTREE_V1.interp(*args) - ip).abs().max()) <= 1e-6,
                         OCTREE_V1_DESIGN["octree_interp"])
    k15_record("sdf render chunk (after the walk and 4 iterations)", *args)

    # the fused query and interpolation at the same points: the cells equal K9's columns
    qargs = (coords,) + fused_tables(grid)
    fused_k, cells_k = _query_interp_fwd(*qargs, with_cells=True)
    fused_p, cells_p = octree_query_interp_plain(*qargs)
    require(torch.equal(cells_k, cells_p) and torch.equal(cells_p, qk[:, grid.base_lod:]),
            "octree_query_interp's cells differ from K9's columns")

    def unfused_query_interp():
        pidx = octree_query(coords, routes, level, True)
        return octree_interp(coords, pidx, grid.base_lod, *args[3:])

    rows.append(kernel_row(
        "octree_query_interp", "wisp_tpu_torch/csrc/octree_grid.cu",
        "wisp_tpu/models/grids/octree_grid.py:115", float((fused_k - fused_p).abs().max()),
        1e-6, timed(lambda: octree_query_interp(*qargs)),
        timed(lambda: octree_query_interp_plain(*qargs)),
        nbytes=n * 12 + interp_bytes + n * f_dim * 4,
        ops=n * (3 * 4 + lods * 6) + interp_ops))
    add_launches_and_was(rows[-1], lambda: octree_query_interp(*qargs), unfused_query_interp,
                         lambda: float((unfused_query_interp() - fused_p).abs().max())
                         <= 1e-6,
                         UNFUSED_DESIGN["octree_query_interp"])
    rows[-1]["also_replaces"] = "wisp_tpu/accelstructs/octree_as.py:199"
    query_interp_record("sdf render chunk (after the walk and 4 iterations)", *qargs)

    # the sphere iteration with its step, from the state after 4 iterations and the field at
    # its points: t, alive and hit bit-equal to sphere_step's, the rows within 1e-6
    fused = fused_field(nef, lods - 1)
    require(fused is not None, "the SDF phase's field does not take the fused iteration")
    field = nef(channels="sdf", coords=coords)               # [N, 1]: the decoder's outputs
    sk, sp = (t.clone(), alive.clone(), hit.clone()), (t.clone(), alive.clone(), hit.clone())
    xk = sphere_iter(o, d, *sk, t_far, field, fk, level, tracer.step_size,
                     tracer.min_dis, *fused)
    xp = sphere_iter_plain(o, d, *sp, t_far, field, fk, level, tracer.step_size,
                           tracer.min_dis, *fused)
    require(all(torch.equal(a, b) for a, b in zip(sk, sp)),
            "sphere_iter's t, alive or hit differs from sphere_step's")
    iter_err = float((xk - xp).abs().max())
    live_after = sp[1]
    points_after = (o + sp[0][:, None] * d)[live_after].contiguous()
    touched_after = interp_touched(grid, points_after)
    steps_cells = int(torch.unique(fsd_cells(o[alive], d[alive], t[alive], level)).numel())
    state, plain_state = copies(t, alive, hit), copies(t, alive, hit, iters=20)
    unfused_state = copies(t, alive, hit, iters=30)

    def unfused_iter(t_, alive_, hit_):
        sphere_step(o, d, t_, alive_, hit_, t_far, field[:, 0].contiguous(), fk, level,
                    tracer.step_size, tracer.min_dis)
        pos = o + t_[:, None] * d
        pidx = octree_query(pos, routes, level, True)
        feats = octree_interp(pos, pidx, grid.base_lod, *args[3:])
        return torch.cat([feats, pos], dim=-1)

    cols = f_dim + 3
    rows.append(kernel_row(
        "sphere_iter", "wisp_tpu_torch/csrc/octree_grid.cu",
        "wisp_tpu/tracers/packed_sdf_tracer.py:136", iter_err, 1e-6,
        timed(lambda: sphere_iter(o, d, *state(), t_far, field, fk, level,
                                  tracer.step_size, tracer.min_dis, *fused)),
        timed(lambda: sphere_iter_plain(o, d, *plain_state(), t_far, field, fk, level,
                                        tracer.step_size, tracer.min_dis, *fused)),
        nbytes=n * (1 + 1) + live * (24 + 4 + 4 + 4 + 4) + live * (4 + 1 + 1)
        + steps_cells * 4 + touched_after["lod_cells_read"] * 4
        + touched_after["trinket_rows"] * 32 + touched_after["feature_rows"] * f_dim * 4
        + n * cols * 4,
        ops=live * 60 + int(live_after.sum()) * (3 * 4 + lods * 6)
        + touched_after["valid"] * (3 * 5 + 8 * (2 + 2 * f_dim))))
    pool = copies(t, alive, hit, iters=40)
    add_launches_and_was(
        rows[-1], lambda: sphere_iter(o, d, *pool(), t_far, field, fk, level,
                                      tracer.step_size, tracer.min_dis, *fused),
        lambda: unfused_iter(*unfused_state()),
        lambda: unfused_matches(unfused_iter, (t, alive, hit), sp, xp),
        UNFUSED_DESIGN["sphere_iter"])
    sphere_iter_record("sdf render chunk (after the walk and 4 iterations): sphere_iter", o,
                       d, t, alive, hit, t_far, field, fk, level, tracer.step_size,
                       tracer.min_dis, *fused)
    return rows, {"chunk_rays": n, "walk_steps_taken": taken, "walk_cells": walk_cells,
                  "live_rays_after_4_iterations": live, "interp_valid_lod_points":
                  touched["valid"], "interp_trinket_rows": touched["trinket_rows"],
                  "interp_feature_rows": touched["feature_rows"],
                  "fused_lod_cells_read": touched["lod_cells_read"],
                  "sphere_iter_live_after_step": int(live_after.sum()),
                  "sphere_iter_free_space_cells": steps_cells}


# the unfused sequences that the fused kernels replace: the "was" of their rows
UNFUSED_DESIGN = {
    "octree_query_interp": "K9 (octree_query, with parents) then K15 (octree_interp): two "
                           "launches, pidx through memory",
    "sphere_iter": "sphere_step, the point o + t*d, K9 with parents, K15 and the "
                   "concatenation [features | xyz], as the unfused loop makes them"}


def fused_tables(grid):
    """``octree_query_interp``'s arguments after the coordinates for all of ``grid``'s LODs,
    the features detached."""
    routes, trinkets, features, levels, multiscale = grid.query_interp_args(grid.num_lods - 1)
    return routes, trinkets, [f.detach() for f in features], levels, multiscale


def interp_touched(grid, coords) -> dict:
    """The blend's data-dependent reads at ``coords`` over all of ``grid``'s LODs: the
    (point, LOD) pairs in occupied cells, the distinct trinket and feature rows, and the
    distinct cells the fused query looks up at the LODs' levels (by the plain query)."""
    import torch
    from wisp_tpu_torch.accelstructs.octree_as import octree_query_plain
    from wisp_tpu_torch.ops.spc.core import quantize_points
    pidx = octree_query_plain(coords, grid.blas.query_routes, grid.active_lods[-1], True)
    top = grid.active_lods[-1]
    q = quantize_points(coords, top)
    inside = ((coords >= -1.0) & (coords <= 1.0)).all(-1)
    out = {"valid": 0, "trinket_rows": 0, "feature_rows": 0, "lod_cells_read": 0}
    for i, l in enumerate(grid.active_lods):
        p = pidx[:, l]
        p = p[p >= 0].long()
        out["valid"] += int(p.numel())
        out["trinket_rows"] += int(torch.unique(p).numel())
        out["feature_rows"] += int(torch.unique(grid.trinkets[i][p].reshape(-1)).numel())
        ql = q[inside] >> (top - l)
        out["lod_cells_read"] += int(torch.unique((ql[:, 0] * 2 ** l + ql[:, 1]) * 2 ** l
                                                  + ql[:, 2]).numel())
    return out


def fsd_cells(o, d, t, level: int):
    """The free-space field's cells that a sphere step at depth t reads (flat index; a
    point outside [-1, 1)^3 reads none)."""
    from wisp_tpu_torch.ops.spc.core import quantize_points
    res = 2 ** level
    p = o + t[:, None] * d
    q = quantize_points(p[((p >= -1.0) & (p < 1.0)).all(-1)], level)
    return (q[:, 0] * res + q[:, 1]) * res + q[:, 2]


def unfused_matches(unfused, state, want_state, want_rows) -> bool:
    """The unfused iteration from ``state`` gives the fused one's t, alive and hit exactly
    and its rows within 1e-6 where the ray is alive (the fused rows of the others are
    zeros)."""
    import torch
    st = tuple(x.clone() for x in state)
    rows_ = unfused(*st)
    live = want_state[1]
    return (all(torch.equal(a, b) for a, b in zip(st, want_state))
            and float((rows_[live] - want_rows[live]).abs().max()) <= 1e-6)


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
    # a chunk: K11, the walk, num_steps sphere iterations (the first without the step) and
    # one closing sphere_step, the normals' 6 taps through the fused query; no K9, no K15
    chunks = -(-RES * RES // renderer.render_batch)
    expected = {"octree_query_interp": chunks * SDF_FD_TAPS,
                "sphere_iter": chunks * tracer.num_steps, "free_space_distance": chunks,
                "sdf_walk": chunks, "sphere_step": chunks, "octree_query": 0,
                "octree_interp": 0}
    got = {k: launches[k] for k in expected}
    require(got == expected, f"SDF frame launches {got}, expected {expected}")
    others = {k: v for k, v in launches.items() if k not in expected and v}
    require(not others, f"the SDF frame launched other kernels: {others}")

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
        "launches": got, "expected_launches": expected,
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


SDF_TRAIN_SAMPLES = 500_000       # nglod_octree.yaml dataset: num_samples
SDF_TRAIN_PER_VOXEL = 32          # samples_per_voxel
SDF_TRAIN_MODES = ("rand", "near", "near", "trace", "trace")
SDF_TRAIN_BATCH = 512
SDF_TRAIN_STEPS_BEFORE_RESAMPLE = 200   # a 10-epoch run has ~4,400 steps an epoch
SDF_TRAIN_STEPS_AFTER_RESAMPLE = 20
SDF_TRAIN_KERNELS = ("octree_query", "octree_query_interp", "octree_interp_bwd", "mesh_sdf")
SDF_CHECK_POINTS = 65_536         # K16 against its plain version ([P, T] buffers)
# float32 arithmetic (add, subtract, multiply, divide, min, max) of one point-triangle
# pair in the plain version, terms of the triangle alone left out: the closest point 120
# (three clamped edge projections 51, the plane projection and its barycentrics 37, four
# squared distances 32), pass 1 129 with its distance and minimum, pass 2 158 with the
# vote's barycentrics and dot product
MESH_SDF_PAIR_OPS = 287
# K16's work as the function needs it, the basis of its bound (the one above counts both
# passes for every pair): one closest point and its d^2 a point-triangle pair
# (CLOSEST_PAIR_OPS), the vote only for the pairs in the band (the barycentrics of cp 23,
# three compares, p - cp, its dot product with the normal, the weight and the sum 10), and
# the triangle's own terms once a triangle (three edges 9, their clamped squared lengths 18,
# the normal and nn 15, d00, d01 and d11 15, denom 4)
MESH_VOTE_OPS = 36
MESH_TRIANGLE_OPS = 61


def mesh_sdf_ops(points: int, triangles: int, band_pairs: int) -> int:
    """K16's float32 operations on the basis above."""
    return (points * triangles * CLOSEST_PAIR_OPS + band_pairs * MESH_VOTE_OPS
            + triangles * MESH_TRIANGLE_OPS)


def mesh_band_sizes(points, tris, chunk: int = 16384):
    """[P] int64: the triangles in each point's band (d^2 <= d2min + (1e-8 + 1e-4 *
    d2min)), from the plain version's arithmetic in torch, not from the kernel."""
    import torch
    from wisp_tpu_torch.ops.mesh.ops import closest_point_on_triangle, dot3
    va, vb, vc = tris[:, 0:3], tris[:, 3:6], tris[:, 6:9]
    out = torch.empty((points.shape[0],), dtype=torch.int64, device=points.device)
    for i in range(0, points.shape[0], chunk):
        p = points[i:i + chunk]
        e = p[:, None] - closest_point_on_triangle(p[:, None], va[None], vb[None], vc[None])
        d2 = dot3(e, e)
        d2min = d2.amin(dim=-1)
        out[i:i + chunk] = (d2 <= (d2min + (1e-8 + 1e-4 * d2min))[:, None]).sum(dim=-1)
    return out


def winding_inside(points, tris, chunk: int = 8192):
    """[P] bool: the generalized winding number of the closed mesh at each point (Van
    Oosterom-Strackee solid angles, float64) is above 0.5: the point is inside."""
    import math
    import torch
    a, b, c = (tris[:, k:k + 3].double()[None] for k in (0, 3, 6))
    out = torch.empty((points.shape[0],), dtype=torch.bool, device=points.device)
    for i in range(0, points.shape[0], chunk):
        x = points[i:i + chunk].double()[:, None]
        ra, rb, rc = a - x, b - x, c - x
        la, lb, lc = ra.norm(dim=-1), rb.norm(dim=-1), rc.norm(dim=-1)
        num = (ra * torch.linalg.cross(rb, rc, dim=-1)).sum(-1)
        den = (la * lb * lc + (ra * rb).sum(-1) * lc + (ra * rc).sum(-1) * lb
               + (rb * rc).sum(-1) * la)
        out[i:i + chunk] = (2.0 * torch.atan2(num, den)).sum(-1) / (4.0 * math.pi) > 0.5
    return out


def sdf_mismatch(got, want):
    """(max abs err, sign flips, flips where |d| >= 1e-5) of a K16 result against the plain
    version's: the distance is held to 1e-5, and a sign may flip only where |d| < 1e-5."""
    flip = (got < 0) != (want < 0)
    err = float((got.abs() - want.abs()).abs().max())
    if bool((~flip).any()):
        err = max(err, float((got - want)[~flip].abs().max()))
    return err, int(flip.sum()), int((flip & (want.abs() >= 1e-5)).sum())


def closest_mismatch(got, want, points, tris):
    """(max abs err of the distance and the point, ties) of a K17 result against the plain
    version's; fails unless every triangle that differs ties within 2 ulp of d^2."""
    import torch
    from wisp_tpu_torch.ops.mesh.ops import closest_point_on_triangle, dot3
    err = max(float((got[0] - want[0]).abs().max()), float((got[1] - want[1]).abs().max()))
    differ = got[2] != want[2]
    ties = int(differ.sum())
    if ties:
        p = points[differ]

        def d2_to(t):
            cp = closest_point_on_triangle(p, tris[t, 0:3], tris[t, 3:6], tris[t, 6:9])
            return dot3(p - cp, p - cp)

        a, b = d2_to(got[2][differ]), d2_to(want[2][differ])
        require(bool(((a - b).abs() <= 2 * torch.finfo(torch.float32).eps * b).all()),
                "closest_point: a triangle differs from the plain version's off a tie")
    return err, ties


def nglod_trainer(device):
    """The trainer of app/nglod/configs/nglod_octree.yaml at full width on the same octree
    as the SDF render phase: OctreeGrid 16 x 6 LODs, 'sum', std 0.01 and a NeuralSDF of
    hidden 128, both from a seeded generator (the config's init, random decoder);
    OctreeSampledSDFDataset with the config's modes, 500,000 samples and 32 a voxel;
    SDFTrainer with batch 512, Adam lr 1e-3 eps 1e-15, grid lr weight 1.0, only the last
    LOD, resampling, AMP on (JAX's default)."""
    import torch
    from wisp_tpu_torch.datasets.formats.octree_sampled_sdf import OctreeSampledSDFDataset
    from wisp_tpu_torch.models.grids.octree_grid import OctreeGrid
    from wisp_tpu_torch.models.nefs.neural_sdf import NeuralSDF
    from wisp_tpu_torch.models.pipeline import Pipeline
    from wisp_tpu_torch.tracers.packed_sdf_tracer import PackedSDFTracer
    from wisp_tpu_torch.trainers.base_trainer import ConfigAdam
    from wisp_tpu_torch.trainers.sdf_trainer import ConfigSDFTrainer, SDFTrainer
    blas = sphere_octree(device)
    gen = torch.Generator().manual_seed(3)
    grid = OctreeGrid(blas=blas, feature_dim=16, num_lods=SDF_NUM_LODS,
                      interpolation_type="linear", multiscale_type="sum", feature_std=0.01,
                      generator=gen, device=device)
    nef = NeuralSDF(grid=grid, pos_embedder="none", position_input=True,
                    activation_type="relu", hidden_dim=128, num_layers=1, generator=gen,
                    device=device)
    dataset = OctreeSampledSDFDataset(sample_mode=list(SDF_TRAIN_MODES),
                                      num_samples=SDF_TRAIN_SAMPLES,
                                      samples_per_voxel=SDF_TRAIN_PER_VOXEL, blas=blas,
                                      device=device)
    cfg = ConfigSDFTrainer(optimizer=ConfigAdam(lr=1e-3, eps=1e-15), exp_name="nglod-octree",
                           max_epochs=10, batch_size=SDF_TRAIN_BATCH, grid_lr_weight=1.0,
                           only_last=True, resample=True)
    pipeline = Pipeline(nef=nef, tracer=PackedSDFTracer(num_steps=32, step_size=0.8))
    return SDFTrainer(cfg, pipeline, dataset, device=device)


@contextmanager
def resample_timer(times: dict):
    """Time the parts of OctreeSampledSDFDataset.resample into ``times`` (seconds): the
    host draws, the narrowband filter (upload and K9) and the exact distances (K16)."""
    import torch
    from wisp_tpu_torch.datasets.formats import octree_sampled_sdf as osd

    def timing(key, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            times[key] = times.get(key, 0.0) + time.perf_counter() - t0
            return out
        return wrapper

    cls = osd.OctreeSampledSDFDataset
    with mock.patch.object(cls, "draw", timing("host_sampling_s", cls.draw)), \
            mock.patch.object(cls, "narrowband", timing("k9_filter_s", cls.narrowband)), \
            mock.patch.object(osd, "compute_sdf", timing("k16_s", osd.compute_sdf)):
        yield times


def sdf_train_kernel_phase(trainer, coords):
    """K15 backward at the step's shapes (``coords``: a batch of the dataset, a seeded
    cotangent) and K16 at the resample's points, each against its plain version and timed;
    K16 is compared on SDF_CHECK_POINTS of them; K9 on validate()'s uniform points."""
    import numpy as np
    import torch
    from wisp_tpu_torch.models.grids.octree_grid import (octree_interp_bwd,
                                                         octree_interp_bwd_plain)
    from wisp_tpu_torch.ops.mesh.compute_sdf import (MESH_SDF_CANDIDATES, mesh_sdf,
                                                     mesh_sdf_plain, triangle_table)
    grid = trainer.pipeline.nef.grid
    blas = grid.blas
    rows = []
    n, f_dim, lods = coords.shape[0], grid.feature_dim, grid.num_lods
    g = torch.Generator(device=coords.device).manual_seed(8)
    pidx = blas.query(coords, grid.active_lods[-1], with_parents=True).pidx
    cot = torch.randn((n, f_dim), generator=g, device=coords.device)
    sizes = [f.shape[0] for f in grid.features]
    args = (coords, pidx, grid.base_lod, grid.trinkets, sizes, f_dim, grid.active_lods,
            grid.multiscale_type, cot)
    k15_record("sdf train batch", coords, pidx, grid.base_lod, grid.trinkets,
               list(grid.features), grid.active_lods, grid.multiscale_type)
    # the step's fused query, with its cells for K15's backward
    query_interp_record("sdf train batch (cells for the backward)", coords,
                        *fused_tables(grid), with_cells=True)
    bk = octree_interp_bwd(*args)
    bp = octree_interp_bwd_plain(*args)
    scale = max(float(b.abs().max()) for b in bp)
    err = max(float((a - b).abs().max()) for a, b in zip(bk, bp))
    # the library call: one index_add_ of the precomputed w * g rows into one table
    idx, vals, valid, trinket_rows, feature_rows = [], [], 0, 0, 0
    offset = 0
    for i in range(lods):
        p = pidx[:, grid.base_lod + i]
        keep = p >= 0
        corner_rows = grid.trinkets[i][p[keep].long()].long()                # [M, 8]
        res = 2 ** grid.active_lods[i]
        c = coords[keep]
        cell = torch.floor((c + 1.0) * (res / 2.0)).clamp(0, res - 1)
        frac = torch.clamp((c + 1.0) * (res / 2.0) - cell, 0.0, 1.0)
        bits = torch.tensor([[(k >> 2) & 1, (k >> 1) & 1, k & 1] for k in range(8)],
                            device=c.device, dtype=torch.bool)
        w = torch.where(bits[None], frac[:, None, :], 1.0 - frac[:, None, :]).prod(-1)
        vals.append((w[..., None] * cot[keep][:, None, :]).reshape(-1, f_dim))
        idx.append((corner_rows + offset).reshape(-1))
        offset += sizes[i]
        valid += int(keep.sum())
        trinket_rows += int(torch.unique(p[keep]).numel())
        feature_rows += int(torch.unique(corner_rows).numel())
    idx, vals = torch.cat(idx), torch.cat(vals)
    table = torch.zeros((offset, f_dim), dtype=torch.float32, device=coords.device)
    t0 = time.perf_counter()
    rows.append(kernel_row(
        "octree_interp_bwd", "wisp_tpu_torch/csrc/octree_grid.cu",
        "wisp_tpu/ops/grid.py:55", err, 1e-5 * scale,
        timed(lambda: octree_interp_bwd(*args)), timed(lambda: octree_interp_bwd_plain(*args)),
        nbytes=n * 12 + n * lods * 4 + n * f_dim * 4 + trinket_rows * 32
        + offset * f_dim * 4,
        ops=valid * (3 * 5 + 8 * (2 + 2 * f_dim)),
        library_ms=timed(lambda: table.index_add_(0, idx, vals))))
    rows[-1]["library_call"] = ("index_add_ of precomputed w*g rows into one [V, F] table "
                                "(over precomputed rows: not the same function)")
    add_launches_and_was(
        rows[-1], lambda: octree_interp_bwd(*args),
        MARCH_GRAD_V1 and (lambda: MARCH_GRAD_V1.interp_bwd(*args)),
        lambda: max(float((a - b).abs().max()) for a, b in
                    zip(MARCH_GRAD_V1.interp_bwd(*args), bp)) <= 1e-5 * scale,
        MARCH_GRAD_V1_DESIGN["octree_interp_bwd"])
    rows[-1]["by_lod"] = k15_bwd_counts(coords, pidx, grid.base_lod, grid.trinkets, sizes,
                                        f_dim, grid.active_lods)
    rows[-1]["check_s"] = time.perf_counter() - t0
    march_grad_record("sdf train batch: octree_interp_bwd", "octree_interp_bwd", args)

    # K9 where the path still launches it: validate()'s narrowband filter of its uniform
    # points (no parents, the max level)
    from wisp_tpu_torch.accelstructs.octree_as import octree_query, octree_query_plain
    from wisp_tpu_torch.ops.mesh.ops import sample_uniform
    from wisp_tpu_torch.ops.spc.core import quantize_points
    from wisp_tpu_torch.trainers import sdf_trainer
    pts = torch.from_numpy(sample_uniform(sdf_trainer.VALID_UNIFORM_POINTS, rng=np.random.
                                          default_rng(sdf_trainer.VALID_SEED)))
    pts = pts.to(coords.device).contiguous()
    routes, level = blas.query_routes, blas.max_level
    require(torch.equal(octree_query(pts, routes, level), octree_query_plain(pts, routes,
                                                                            level)),
            "octree_query differs from the plain version")
    q = quantize_points(pts, level)
    inside = ((pts >= -1.0) & (pts <= 1.0)).all(-1)
    q = q[inside]
    map_entries = int(torch.unique((q[:, 0] * 2 ** level + q[:, 1]) * 2 ** level
                                   + q[:, 2]).numel())
    m = pts.shape[0]
    rows.append(kernel_row(
        "octree_query", "wisp_tpu_torch/csrc/octree.cu",
        "wisp_tpu/accelstructs/octree_as.py:199", 0.0, 0.0,
        timed(lambda: octree_query(pts, routes, level)),
        timed(lambda: octree_query_plain(pts, routes, level)),
        nbytes=m * 12 + m * 4 + map_entries * 4, ops=m * (3 * 4 + 6)))
    rows[-1]["shape"] = (f"validate()'s narrowband filter: {m} uniform points, level {level}, "
                         f"no parents")

    # K16 at the resample's points
    t0 = time.perf_counter()
    extent = blas.extent
    points = trainer.train_dataset.coordinates
    tris = triangle_table(extent.vertices, extent.faces, points.device)
    sub = points[torch.randperm(points.shape[0], generator=g, device=points.device)
                 [:SDF_CHECK_POINTS]].contiguous()
    mp = mesh_sdf_plain(sub, tris)
    err, flips, far_flips = sdf_mismatch(mesh_sdf(sub, tris), mp)
    require(far_flips == 0, f"mesh_sdf: {far_flips} signs differ from the plain version off "
                            f"the surface")
    p_all, t_all = points.shape[0], tris.shape[0]
    sizes = mesh_band_sizes(points, tris)
    band_pairs = int(sizes.sum())
    nbytes = p_all * 12 + t_all * 15 * 4 + p_all * 4
    rows.append(kernel_row(
        "mesh_sdf", "wisp_tpu_torch/csrc/mesh_sdf.cu",
        "wisp_tpu/ops/mesh/compute_sdf.py:48", err, 1e-5,
        timed(lambda: mesh_sdf(points, tris), iters=5, warmup=1),
        events_only(lambda: mesh_sdf_plain(points, tris), iters=1, warmup=0),
        nbytes=nbytes, ops=mesh_sdf_ops(p_all, t_all, band_pairs)))

    def was_ok():
        was_err, _, was_far = sdf_mismatch(MESH_V1.mesh_sdf(sub, tris), mp)
        return was_err <= 1e-5 and was_far == 0

    add_launches_and_was(rows[-1], lambda: mesh_sdf(points, tris),
                         MESH_V1 and (lambda: MESH_V1.mesh_sdf(points, tris)), was_ok,
                         MESH_V1_DESIGN)
    rows[-1].update(
        check_s=time.perf_counter() - t0,
        plain_timed_by="CUDA events only (torch.profiler's host cost is ~30 s)",
        checked_points=int(sub.shape[0]), **{"sign_flips_within_1e-5": flips},
        bound_basis="a closest point a pair, the vote for the band's pairs, the triangle's "
                    "terms once a triangle",
        band_pairs=band_pairs, band_over_candidates=int((sizes > MESH_SDF_CANDIDATES).sum()),
        bound_ms_earlier_basis=bound(nbytes, p_all * t_all * MESH_SDF_PAIR_OPS)[0])
    return rows, {"k15_bwd_points": n, "k15_bwd_valid_lod_points": valid,
                  "k15_bwd_trinket_rows": trinket_rows, "k15_bwd_feature_rows": feature_rows,
                  "k16_points": p_all, "k16_triangles": t_all}


def sdf_train_phase(dev):
    """The NGLOD training path: the trainer (its dataset's first resample timed), counts
    from 0, 200 steps (the 200th profiled), the trainer's post_epoch (a resample), 20
    steps, validate(), counts read after. Then K15 backward and K16 against their plain
    versions."""
    import math
    import torch
    from wisp_tpu_torch import kernels
    first = {}
    t0 = time.perf_counter()
    with resample_timer(first):
        trainer = nglod_trainer(dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    dataset = trainer.train_dataset
    size_first = len(dataset)
    steps, resample = [], {}
    t_steps = time.perf_counter()
    kernels.reset_launches()
    total = SDF_TRAIN_STEPS_BEFORE_RESAMPLE + SDF_TRAIN_STEPS_AFTER_RESAMPLE
    for i in range(total):
        if i == SDF_TRAIN_STEPS_BEFORE_RESAMPLE:
            t0 = time.perf_counter()
            with resample_timer(resample), recording_mesh("sdf train resample"):
                trainer.post_epoch()             # the epoch's end: log, then resample
            resample["total_s"] = time.perf_counter() - t0
        if i == SDF_TRAIN_STEPS_BEFORE_RESAMPLE - 1:
            profiled = profile_step(trainer)     # step 200 runs under the profiler
            ms = profiled["profile_step_ms"]
        else:
            t0 = time.perf_counter()
            trainer.iterate()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        steps.append({"step": i + 1, "ms": ms, "loss": trainer.last_loss})
    steps_s = time.perf_counter() - t_steps
    t0 = time.perf_counter()
    with recording_mesh("sdf train validate"):
        metrics = trainer.validate()
    torch.cuda.synchronize()
    validate_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    size = len(dataset)
    chunks = -(-size // 65536)
    # the fused query and K15's backward once a step; the fused query once a validate chunk
    # and once at its uniform points; K9 (no parents) in the resample's narrowband filter
    # and in validate()'s; K16 once a resample and once a validation
    expected = {"octree_query": 2, "octree_query_interp": total + chunks + 1,
                "octree_interp_bwd": total, "mesh_sdf": 2}
    got = {k: launches[k] for k in SDF_TRAIN_KERNELS}
    require(got == expected, f"SDF training launches {got}, expected {expected}")
    others = {k: v for k, v in launches.items() if k not in SDF_TRAIN_KERNELS and v}
    require(not others, f"SDF training launched other kernels: {others}")
    losses = [st["loss"] for st in steps]
    require(all(math.isfinite(x) for x in losses), "non-finite SDF training loss")
    first_20 = sum(losses[:20]) / 20
    last_20 = sum(losses[-SDF_TRAIN_STEPS_AFTER_RESAMPLE:]) / SDF_TRAIN_STEPS_AFTER_RESAMPLE
    require(last_20 < first_20, f"the SDF loss did not fall: {first_20} -> {last_20}")
    require(all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in metrics.values())
            and set(metrics) == {"iou", "volumetric_iou"}, f"bad IoUs {metrics}")
    batch = dataset[trainer._batch_rng.integers(0, size, size=(SDF_TRAIN_BATCH,))]
    t0 = time.perf_counter()
    rows, shape_info = sdf_train_kernel_phase(trainer, batch.coords.contiguous())
    checks_s = time.perf_counter() - t0
    for row_ in rows:
        row_["launches"] = launches[row_["name"]]
    steady = sorted(st["ms"] for st in steps[1:SDF_TRAIN_STEPS_BEFORE_RESAMPLE])
    median = steady[len(steady) // 2]
    info = {
        "sdf_train_path": f"SDFTrainer.iterate ({SDF_TRAIN_STEPS_BEFORE_RESAMPLE} steps, "
                          f"post_epoch resample, {SDF_TRAIN_STEPS_AFTER_RESAMPLE} steps), "
                          f"validate(); nglod_octree.yaml width",
        "setup_s": setup_s, "first_resample": first, "dataset_size_first": size_first,
        "resample": resample, "dataset_size": size,
        "step_ms_median_2_200": median, "points_per_s": SDF_TRAIN_BATCH / median * 1e3,
        "loss_steps_1_20": first_20, "loss_steps_201_220": last_20,
        "steps_and_resample_s": steps_s, "validate_s": validate_s,
        "kernel_checks_s": checks_s, "metrics": metrics, "launches": got,
        "expected_launches": expected, "steps": [st["ms"] for st in steps],
        "kernel_phase_shapes": shape_info,
    }
    info.update(profiled)
    return rows, info


OCTREE_CONFIG = "app/nerf/configs/nerf_octree_lego_proxy.yaml"
# the depth cut: 4 views (the config has 100), 25 steps of a 100-epoch run; checkpoints and
# snapshots are not ported, validation runs once below on a small split
OCTREE_OVERRIDES = ("--dataset.num-views", "4", "--trainer.save-every", "-1",
                    "--trainer.render-every", "-1", "--trainer.valid-every", "-1")
OCTREE_STEPS = 25
OCTREE_PROFILED_STEP = 20
OCTREE_VALID_VIEWS, OCTREE_VALID_RES = 2, 256
# launches a step and a chunk: the field's query and blend are one fused launch (no K9)
OCTREE_STEP_KERNELS = {"raymarch_voxel": 1, "compact": 1, "octree_query_interp": 1,
                       "octree_interp_bwd": 1, "scatter_back": 2, "scatter_back_bwd": 1,
                       "integrate_fwd": 1, "integrate_bwd": 1}
OCTREE_FRAME_KERNELS = {"raymarch_voxel": 1, "compact": 1, "octree_query_interp": 1,
                        "scatter_back": 2, "integrate_fwd": 1}


def octree_app(dev):
    """nerf_octree_lego_proxy.yaml through the port's own front end: ``parse_args`` (the
    app's ``parse_config`` and its refusals) and ``main_nerf.build()``."""
    from wisp_tpu_torch.app.nerf import main_nerf
    cfg = main_nerf.parse_args(["--config", OCTREE_CONFIG, *OCTREE_OVERRIDES,
                                "--device", str(dev)])
    return cfg, main_nerf.build(cfg)


def octree_stats(trainer) -> dict:
    grid = trainer.pipeline.nef.grid
    blas = grid.blas
    return {"pointcloud_points": int(trainer.train_dataset.scene_pointcloud().shape[0]),
            "level_counts": list(blas.level_counts),
            "leaves": int(blas.level_counts[-1]),
            "active_lods": list(grid.active_lods),
            "dual_vertex_rows": [int(f.shape[0]) for f in grid.features],
            "feature_mb": sum(f.numel() * 4 for f in grid.features) / 1e6,
            "occupied_fraction": blas.level_counts[-1] / 8 ** blas.max_level}


def voxel_cells_read(rays, blas, level: int) -> int:
    """Distinct cells of the density field that the coarse segments inside the box read."""
    import torch
    from wisp_tpu_torch.accelstructs.octree_as import aabb_intersect, num_coarse_segments
    from wisp_tpu_torch.ops.spc.core import quantize_points
    o, d = rays.origins, rays.dirs
    voxel = 2.0 / 2 ** level
    t_near, _ = aabb_intersect(o, d, rays.dist_min, rays.dist_max)
    tc = t_near.clamp(min=0.0)[:, None] + (torch.arange(num_coarse_segments(level),
                                                        device=o.device) + 0.5) * voxel
    c = (o[:, None, :] + d[:, None, :] * tc[..., None]).reshape(-1, 3)
    c = c[((c >= -1.0) & (c < 1.0)).all(-1)]
    q = quantize_points(c, blas.max_level)
    res = 2 ** blas.max_level
    return int(torch.unique((q[:, 0] * res + q[:, 1]) * res + q[:, 2]).numel())


def voxel_check(rays, level, s, budget, occ, field, max_level, jitter=None, early_stop=0.0):
    """K7 against its plain version on the card, in the branch that ``occ`` and ``field``
    select (a density field; the bool occupancy alone; neither, a dense octree): mask,
    depths, samples, density and the overflow count equal. Returns (the kernel's result,
    max abs error)."""
    import torch
    from wisp_tpu_torch.accelstructs.octree_as import raymarch_voxel, raymarch_voxel_plain
    args = (rays.origins, rays.dirs, rays.dist_min, rays.dist_max, s, level, budget,
            occ, field, max_level, jitter, early_stop)
    got, want = raymarch_voxel(*args), raymarch_voxel_plain(*args)
    require(torch.equal(got.mask, want.mask), "raymarch_voxel: mask differs")
    require(float(got.num_overflow) == float(want.num_overflow),
            "raymarch_voxel: num_overflow differs")
    require((got.cell_density is None) == (want.cell_density is None) == (field is None),
            "raymarch_voxel: density returned in the wrong branch")
    pairs = [(got.depth_samples, want.depth_samples), (got.samples, want.samples),
             (got.deltas, want.deltas)]
    if field is not None:
        pairs.append((got.cell_density, want.cell_density))
    err = max(float((a - b).abs().max()) for a, b in pairs)
    require(err <= 1e-6, f"raymarch_voxel: error {err} above 1e-6")
    return got, err


def octree_kernel_phase(trainer, chunk):
    """K7 against its plain version and timed at a step's shapes (the last step's rays, a
    jitter) and a render chunk's, in all its branches; K15 forward and backward at F = 5 on
    the step's kept samples."""
    import torch
    from wisp_tpu_torch.accelstructs.octree_as import (raymarch_voxel, raymarch_voxel_plain,
                                                       voxel_slots)
    from wisp_tpu_torch.core.rays import Rays
    from wisp_tpu_torch.models.grids.octree_grid import (octree_interp, octree_interp_bwd,
                                                         octree_interp_bwd_plain,
                                                         octree_interp_plain)
    from wisp_tpu_torch.ops.compaction import compact, compaction_budget
    pipeline = trainer.pipeline
    nef, tracer = pipeline.nef, pipeline.tracer
    grid, blas = nef.grid, nef.grid.blas
    level, s, budget = grid.base_lod, tracer.num_steps, tracer.march_budget
    k = voxel_slots(s, budget, level)
    view = trainer.train_dataset.data["rays"][0]
    g = torch.Generator(device=view.origins.device).manual_seed(9)
    n = trainer.train_dataset.transform.num_samples
    pick = torch.randint(0, view.origins.shape[0], (n,), generator=g, device=view.origins.device)
    o, d = view.origins[pick].contiguous(), view.dirs[pick].contiguous()
    step_rays = Rays(o, d, view.dist_min, view.dist_max)
    jitter = torch.rand((n, k, s), generator=g, device=o.device)
    rng_field = torch.where(blas.occ_grid, torch.rand(blas.occ_grid.shape, generator=g,
                                                      device=o.device) * 20.0,
                            torch.full_like(blas.cell_density, -1.0))
    occ, dens, top = blas.occ_grid, blas.cell_density, blas.max_level
    checks = {}
    mr, err_step = voxel_check(step_rays, level, s, budget, occ, dens, top, jitter)
    checks["step"] = {"rays": n, "err": err_step, "overflow": float(mr.num_overflow)}
    mc, err_chunk = voxel_check(chunk, level, s, budget, occ, dens, top)
    checks["render_chunk"] = {"rays": chunk.origins.shape[0], "err": err_chunk,
                              "overflow": float(mc.num_overflow)}
    culled, err = voxel_check(step_rays, level, s, budget, occ, rng_field, top, jitter,
                              early_stop=0.01)
    checks["density_early_stop_0.01"] = {"err": err, "overflow": float(culled.num_overflow),
                                         "valid": int(culled.mask.sum())}
    small, err = voxel_check(step_rays, level, s, 64, occ, dens, top)
    require(float(small.num_overflow) > 0, "a budget of 64 should overflow")
    checks["budget_64"] = {"err": err, "overflow": float(small.num_overflow)}
    # the two branches the path does not take: the bool occupancy alone, and a dense octree
    occ_only, err = voxel_check(step_rays, level, s, budget, occ, None, top, jitter)
    checks["occ_grid_only"] = {"err": err, "overflow": float(occ_only.num_overflow),
                               "valid": int(occ_only.mask.sum())}
    occ_small, err = voxel_check(step_rays, level, s, 64, occ, None, top)
    require(float(occ_small.num_overflow) > 0, "a budget of 64 should overflow")
    checks["occ_grid_only_budget_64"] = {"err": err, "overflow": float(occ_small.num_overflow)}
    dense, err = voxel_check(step_rays, level, s, budget, None, None, top, jitter)
    checks["dense"] = {"err": err, "overflow": float(dense.num_overflow),
                       "valid": int(dense.mask.sum())}
    rows = []
    for name, rays, u in (("step", step_rays, jitter), ("render_chunk", chunk, None)):
        r = rays.origins.shape[0]
        args = (rays.origins, rays.dirs, rays.dist_min, rays.dist_max, s, level, budget,
                blas.occ_grid, blas.cell_density, blas.max_level, u, 0.0)
        nbytes = (r * 24 + (r * k * s * 4 if u is not None else 0)
                  + voxel_cells_read(rays, blas, level) * 4
                  + r * k * s * (12 + 4 + 1 + 4) + r * 4 + 4)
        row = kernel_row("raymarch_voxel", "wisp_tpu_torch/csrc/raymarch.cu",
                         "wisp_tpu/accelstructs/octree_as.py:512", max(err_step, err_chunk),
                         1e-6, timed(lambda: raymarch_voxel(*args)),
                         timed(lambda: raymarch_voxel_plain(*args), iters=5),
                         nbytes=nbytes, ops=r * k * s * 10 + r * 29 * 30)
        row["shape"] = f"{name}: {r} rays x {k * s} slots"
        rows.append(row)
    # K15 at F = 5, 4 LODs, on the step's kept samples
    cbudget = compaction_budget(n, k * s, tracer.compaction)
    _, cflat, _, count = compact(mr.mask, mr.samples, d, cbudget)
    kept = min(int(count), cbudget)
    coords = cflat[:kept]
    pidx = blas.query(coords, grid.active_lods[-1], with_parents=True).pidx
    feats = [f.detach() for f in grid.features]
    iargs = (coords, pidx, grid.base_lod, grid.trinkets, feats, grid.active_lods, "sum")
    fwd_err = float((octree_interp(*iargs) - octree_interp_plain(*iargs)).abs().max())
    cot = torch.randn((kept, grid.feature_dim), generator=g, device=o.device)
    bargs = (coords, pidx, grid.base_lod, grid.trinkets, [f.shape[0] for f in feats],
             grid.feature_dim, grid.active_lods, "sum", cot)
    bk, bp = octree_interp_bwd(*bargs), octree_interp_bwd_plain(*bargs)
    scale = max(float(b.abs().max()) for b in bp)
    bwd_err = max(float((a - b).abs().max()) for a, b in zip(bk, bp))
    require(fwd_err <= 1e-6, f"octree_interp at F = 5: error {fwd_err}")
    require(bwd_err <= 1e-5 * scale, f"octree_interp_bwd at F = 5: error {bwd_err}")
    k15_record("octree nerf step (F = 5)", *iargs)
    query_interp_record("octree nerf step (F = 5)", coords, *fused_tables(grid))
    march_grad_record("octree nerf kernel phase (F = 5): octree_interp_bwd",
                      "octree_interp_bwd", bargs)
    # the bounds, counted as the SDF rows count them: each touched trinket and feature row
    # read once (forward), each whole gradient table written once (backward)
    f_dim, lods = grid.feature_dim, grid.num_lods
    trinket_rows = feature_rows = valid = 0
    for i in range(lods):
        p = pidx[:, grid.base_lod + i]
        p = p[p >= 0].long()
        valid += int(p.numel())
        trinket_rows += int(torch.unique(p).numel())
        feature_rows += int(torch.unique(grid.trinkets[i][p].reshape(-1)).numel())
    ops = valid * (3 * 5 + 8 * (2 + 2 * f_dim))
    k15 = {"points": kept, "fwd_err": fwd_err, "fwd_tol": 1e-6, "bwd_err": bwd_err,
           "bwd_tol": 1e-5 * scale,
           "fwd_ms": timed(lambda: octree_interp(*iargs)),
           "bwd_ms": timed(lambda: octree_interp_bwd(*bargs)),
           "fwd_bound_ms": bound(kept * 12 + kept * lods * 4 + trinket_rows * 32
                                 + feature_rows * f_dim * 4 + kept * f_dim * 4, ops),
           "bwd_bound_ms": bound(kept * 12 + kept * lods * 4 + kept * f_dim * 4
                                 + trinket_rows * 32 + sum(bargs[4]) * f_dim * 4, ops),
           "valid_lod_points": valid, "trinket_rows": trinket_rows,
           "feature_rows": feature_rows}
    return rows, {"k7_checks": checks, "k15_f5": k15}


def octree_phase(dev):
    """The octree-grid NeRF from its yaml: parse and build through the app, the octree's
    sizes, counts from 0, 25 ``iterate()`` steps (one profiled), counts read; validate()
    on a small split; a warm-up frame, counts from 0, one 512x512 voxel frame, counts read;
    the frame's checks and one chunk against the plain versions; K7 and K15 at F = 5."""
    import math
    import numpy as np
    import torch
    from wisp_tpu_torch import kernels
    from wisp_tpu_torch.accelstructs.octree_as import voxel_slots
    from wisp_tpu_torch.core.camera import Camera
    from wisp_tpu_torch.core.rays import Rays
    from wisp_tpu_torch.datasets.random_view_dataset import RandomViewDataset
    from wisp_tpu_torch.ops.raygen.raygen import generate_pinhole_rays
    t0 = time.perf_counter()
    cfg, (pipeline, trainer, renderer) = octree_app(dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    stats = octree_stats(trainer)
    print(json.dumps({"octree_nerf": stats, "setup_s": setup_s}), flush=True)
    tracer = pipeline.tracer
    # the march's slots a ray, K x num_steps (464 at this config); the trainer's adaptive
    # rays and compaction count num_steps, as JAX does
    slots = voxel_slots(tracer.num_steps, tracer.march_budget,
                        pipeline.nef.grid.base_lod) * tracer.num_steps

    # -- training: counts from 0, 25 steps, counts read right after ------------------------
    steps = []
    kernels.reset_launches()
    with recording_march_grad("octree nerf step 25"):
        for i in range(OCTREE_STEPS):
            rays = trainer.train_dataset.transform.num_samples
            budget = tracer.compaction
            if i == OCTREE_PROFILED_STEP - 1:
                profiled = profile_step(trainer)
                ms = profiled["profile_step_ms"]
            else:
                t1 = time.perf_counter()
                trainer.iterate()
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t1) * 1e3
            steps.append({"step": i + 1, "ms": ms, "rays": rays, "budget": budget,
                          "slots_per_ray": slots,
                          "valid_share": trainer._prev_num_samples / (rays * slots),
                          "num_overflow": trainer.last_num_overflow,
                          "loss": trainer.last_loss})
    train_launches = dict(kernels.LAUNCHES)
    want = {k: v * OCTREE_STEPS for k, v in OCTREE_STEP_KERNELS.items()}
    got = {k: train_launches[k] for k in want}
    require(got == want, f"octree training launches {got}, expected {want}")
    others = {k: v for k, v in train_launches.items() if k not in want and v}
    require(not others, f"octree training launched other kernels: {others}")
    losses = [st["loss"] for st in steps]
    require(all(math.isfinite(x) for x in losses), f"non-finite octree loss: {losses}")
    first, late = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    require(late < first, f"the octree loss did not fall: {first} -> {late}")
    require(all(st["num_overflow"] == 0.0 for st in steps), "a training ray overflowed")

    # -- validate() on a small split --------------------------------------------------------
    t1 = time.perf_counter()
    trainer.validation_dataset = RandomViewDataset(
        num_views=OCTREE_VALID_VIEWS, height=OCTREE_VALID_RES, width=OCTREE_VALID_RES,
        split="test", scene="lego_proxy", device=dev)
    metrics = trainer.validate()
    torch.cuda.synchronize()
    validate_s = time.perf_counter() - t1
    require(math.isfinite(metrics["psnr"]), f"bad validation PSNR {metrics}")

    # -- the frame: counts from 0, one 512x512 voxel frame, counts read right after --------
    renderer.render_lookat(pipeline, f=EYE)          # warm-up
    torch.cuda.synchronize()
    chunk_valid = []
    trace = tracer.trace

    @functools.wraps(trace)
    def recording_trace(*args, **kwargs):
        rb_ = trace(*args, **kwargs)
        chunk_valid.append(tracer.prev_num_samples)
        return rb_

    tracer.trace = recording_trace
    kernels.reset_launches()
    t1 = time.perf_counter()
    rb = renderer.render_lookat(pipeline, f=EYE)
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t1) * 1e3
    frame_launches = dict(kernels.LAUNCHES)
    del tracer.trace
    chunks = len(chunk_valid)
    # a chunk whose rays keep no sample asks the field for nothing: no query, no blend
    field_chunks = sum(1 for v in chunk_valid if v > 0)
    want = {k: v * (field_chunks if k == "octree_query_interp" else chunks)
            for k, v in OCTREE_FRAME_KERNELS.items()}
    got = {k: frame_launches[k] for k in want}
    require(got == want, f"octree frame launches {got}, expected {want}")
    others = {k: v for k, v in frame_launches.items() if k not in want and v}
    require(not others, f"the octree frame launched other kernels: {others}")
    rgb, alpha = rb.rgb, rb.alpha
    require(tuple(rgb.shape) == (RES, RES, 3) and tuple(alpha.shape) == (RES, RES, 1),
            f"bad octree frame shapes {rb}")
    finite = all(bool(torch.isfinite(t).all()) for t in (rgb, alpha, rb.depth))
    require(finite, "non-finite octree frame")
    require(float(alpha.min()) >= 0.0 and float(alpha.max()) <= 1.0 + 1e-5,
            "octree alpha outside [0, 1]")
    hit_frac = float(rb.hit.float().mean())
    require(0.0 < hit_frac < 1.0, f"octree hit fraction {hit_frac}")
    require(float(rb.num_overflow) == 0.0, "a frame ray overflowed")

    # -- one chunk against the plain versions -----------------------------------------------
    cam = Camera.from_args(eye=EYE, at=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0), width=RES,
                           height=RES, fov=np.radians(30.0), near=0.0, far=10.0)
    all_rays = generate_pinhole_rays(cam, device=dev)
    n_chunk = renderer.render_batch
    sl = slice(CHUNK_INDEX * n_chunk, (CHUNK_INDEX + 1) * n_chunk)
    chunk = Rays(all_rays.origins[sl].contiguous(), all_rays.dirs[sl].contiguous(),
                 all_rays.dist_min, all_rays.dist_max)
    with torch.no_grad():
        a = pipeline(rays=chunk)
        before = dict(kernels.LAUNCHES)
        with plain_versions():
            b = pipeline(rays=chunk)
        require(dict(kernels.LAUNCHES) == before, "a plain-version trace launched a kernel")
    chunk_err = {k: float((a.channels[k] - b.channels[k]).abs().max())
                 for k in ("rgb", "alpha", "depth")}
    require(all(e <= 1e-3 for e in chunk_err.values()),
            f"octree chunk differs from the plain versions: {chunk_err}")
    require(float(a.num_valid_samples) == float(b.num_valid_samples),
            "octree chunk valid-sample counts differ")
    require(float((rgb.reshape(-1, 3)[sl] - a.rgb).abs().max()) <= 1e-6,
            "octree chunk re-trace differs from the frame")

    with torch.no_grad():
        rows, shape_info = octree_kernel_phase(trainer, chunk)
    for row_ in rows:
        row_["launches"] = train_launches["raymarch_voxel"] if row_["shape"].startswith(
            "step") else frame_launches["raymarch_voxel"]
    # steps 2-24 without the profiled one
    steady = sorted(st["ms"] for st in steps[1:OCTREE_STEPS - 1]
                    if st["step"] != OCTREE_PROFILED_STEP)
    info = {
        "octree_path": "main_nerf.parse_args + build (nerf_octree_lego_proxy.yaml, 4 views), "
                       f"MultiviewTrainer.iterate x {OCTREE_STEPS}, validate(), "
                       f"render_lookat {RES}x{RES} voxel",
        "setup_s": setup_s, "octree": stats, "step_ms_median": steady[len(steady) // 2],
        "loss_steps_1_5": first, "loss_steps_21_25": late,
        "rays_per_step": [st["rays"] for st in steps],
        "budget_per_step": [st["budget"] for st in steps],
        "valid_share_per_step": [st["valid_share"] for st in steps],
        "num_overflow_max": max(st["num_overflow"] for st in steps),
        "steps_ms": [st["ms"] for st in steps], "train_launches": train_launches,
        "validate": {"views": OCTREE_VALID_VIEWS, "res": OCTREE_VALID_RES,
                     "psnr": metrics["psnr"], "s": validate_s},
        "frame_ms": frame_ms, "frame_launches": frame_launches, "hit_fraction": hit_frac,
        "frame_chunk_valid": chunk_valid,
        "chunk_max_abs_err_vs_plain": chunk_err, "chunk_tol": 1e-3,
    }
    info.update(profiled)
    info.update(shape_info)
    info.update({f"frame_{k}": v for k, v in profile_frame(renderer, pipeline).items()})
    return rows, info


STOCH_CONFIG = "app/nerf/configs/nerf_hash_lego_proxy_stoch.yaml"
# the depth cut: 4 views (the config has 100), 25 steps of a 50-epoch run (20, the trainer's
# prune, 5), then 5 steps of the original and of a trainer resumed from its train state
STOCH_VIEWS = 4
STOCH_STEPS_BEFORE_PRUNE = 20
STOCH_STEPS_AFTER_PRUNE = 5
STOCH_RESUME_STEPS = 5
STOCH_DRAWS = 256              # injected-uniform draws of the unbiasedness check
STOCH_FLIP_SHARE_MAX = 1e-4
# the resumed codebook may part from the original's in at most this many times the entries
# in which two resumed trainers part, plus this share of its entries (on the H100, by
# chip_resume_drift.py: a sound resume parts in 0-21 of the 10,435,874 entries over 8 runs,
# one that loses the random stream or the optimizer's state in 2.8 or 6.7 million)
STOCH_DRIFT_RATIO = 4
STOCH_DRIFT_SHARE = 1e-4


def stoch_app(dev, log_dir: str, *extra):
    """nerf_hash_lego_proxy_stoch.yaml through the port's front end as shipped, but for the
    number of views and a temporary log dir (the app runs on the card by default)."""
    from wisp_tpu_torch.app.nerf import main_nerf
    cfg = main_nerf.parse_args(["--config", STOCH_CONFIG, "--dataset.num-views",
                                str(STOCH_VIEWS), "--tracker.log-dir", log_dir, *extra])
    require(cfg.device == "cuda" and cfg.grid.stoch_grad and cfg.trainer.save_every == 50,
            f"the stoch yaml did not parse as shipped: {cfg.device}, {cfg.grid}")
    return cfg, main_nerf.build(cfg)


@contextmanager
def recording_stoch_bwd(masks: list, last: dict):
    """Keep the LOD flags of each launch of the stochastic backward on the training path,
    and the inputs of the last launch that had samples."""
    from wisp_tpu_torch.ops import grid as grid_ops
    real = grid_ops._hashgrid_bwd

    def recording(coords, grad_out, geometry, grad, stoch_mask=None, u0=None, u0_out=None):
        if stoch_mask is not None:
            masks.append((tuple(bool(m) for m in stoch_mask), geometry[2], coords.shape[0]))
            if coords.shape[0] > 0:
                last.update(coords=coords.detach().clone(), grad_out=grad_out.clone(),
                            mask=masks[-1][0], n_lods=geometry[2], out_lods=geometry[3],
                            launch=len(masks))
        return real(coords, grad_out, geometry, grad, stoch_mask, u0, u0_out)

    with mock.patch.object(grid_ops, "_hashgrid_bwd", recording):
        yield


def state_differences(a, b, key: str = "") -> list:
    """The keys at which two trainer states (``BaseTrainer.state_dict()``) differ, bit for
    bit: tensors by dtype, shape and value, containers key by key, the rest by ``==``."""
    import numpy as np
    import torch
    if isinstance(a, dict) and isinstance(b, dict):
        if a.keys() != b.keys():
            return [f"{key} (keys {sorted(map(str, a.keys() ^ b.keys()))})"]
        return [d for k in a for d in state_differences(a[k], b[k], f"{key}.{k}")]
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return [key]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in state_differences(x, y, f"{key}[{i}]")]
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        same = (a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.detach().cpu(), b.detach().cpu()))
        return [] if same else [key]
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return [] if np.array_equal(a, b) else [key]
    return [] if type(a) is type(b) and a == b else [key]


def drift_entries(a, b, tol: float) -> int:
    """The number of entries in which two tensors differ by more than ``tol``."""
    return int(((a - b).detach().abs() > tol).sum())


def ks_distance(u) -> float:
    """Kolmogorov-Smirnov distance of the samples ``u`` to U(0, 1)."""
    import torch
    s = torch.sort(u.double()).values
    n = s.numel()
    i = torch.arange(n, device=s.device, dtype=torch.float64)
    return max(float(((i + 1) / n - s).max()), float((s - i / n).max()))


def stoch_parity(coords, g, args, mask, u0, out_lods, bwd=None) -> dict:
    """K1's stochastic backward against its plain version with the injected uniforms ``u0``.
    The flips are counted exactly: with a unit cotangent on the stochastic LODs each table
    row holds the number of draws that chose it (an integer, exact in float32 in any order
    of the atomics), so the two differ by one in each of two rows for every draw that fell
    the other way. A flip is allowed only on the rows of a draw within 4 ulps of a running
    weight sum. On the step's own cotangent ``g``, every other row agrees to 1e-5 of the
    largest entry of the table gradient (the atomics' order). ``bwd`` is the backward held,
    ``grid.hashgrid_bwd`` by default."""
    import torch
    from wisp_tpu_torch.ops import grid as grid_ops
    bwd = grid_ops.hashgrid_bwd if bwd is None else bwd
    n, n_lods = coords.shape[0], args[2] + 1
    f_dim = g.shape[1] // out_lods
    tie_rows, ties = grid_ops.stoch_tie_rows(coords, args[0], args[1], n_lods - 1, args[4],
                                             mask, u0)
    ones = torch.zeros_like(g)
    for i in range(n_lods):
        if mask[i]:
            ones[:, i * f_dim:(i + 1) * f_dim] = 1.0
    counts_k = bwd(coords, ones, *args, out_lods=out_lods, stoch_mask=mask, u0=u0)
    counts_p = grid_ops.hashgrid_bwd_plain(coords, ones, *args, out_lods=out_lods,
                                           stoch_mask=mask, u0=u0)
    moved = (counts_k - counts_p)[:, 0]
    off = moved != 0
    off[tie_rows] = False
    got = bwd(coords, g, *args, out_lods=out_lods, stoch_mask=mask, u0=u0)
    want = grid_ops.hashgrid_bwd_plain(coords, g, *args, out_lods=out_lods, stoch_mask=mask,
                                       u0=u0)
    scale = float(want.abs().max())
    elsewhere = (got - want).abs().max(dim=1).values
    elsewhere[tie_rows] = 0.0
    out = {"flips": float(moved.abs().sum()) / 2, "flips_outside_ties": int(off.sum()),
           "tie_draws": ties, "draws": n * sum(mask[:n_lods]), "err": float(elsewhere.max()),
           "tol": 1e-5 * scale, "scale": scale}
    out["held"] = (out["flips_outside_ties"] == 0 and out["flips"] <= ties
                   and out["flips"] / max(out["draws"], 1) < STOCH_FLIP_SHARE_MAX
                   and out["err"] <= out["tol"])
    return out


def stoch_kernel_phase(trainer, rec):
    """K1's stochastic backward on a training step's own coordinates and cotangents:
    against its plain version with injected uniforms (flips counted where a draw sits within
    4 ulps of a cumulative boundary), the kernel's sin hash (uniform), the mean of
    STOCH_DRAWS draws against the exact backward (unbiased), and the times."""
    import torch
    from wisp_tpu_torch.ops import grid as grid_ops
    grid = trainer.pipeline.nef.grid
    coords, g, mask = rec["coords"], rec["grad_out"], rec["mask"]
    n, n_lods, out_lods = coords.shape[0], rec["n_lods"], rec["out_lods"]
    f_dim = grid.feature_dim
    args = (grid.codebook.resolutions, grid.codebook_bitwidth, n_lods - 1,
            grid.codebook.total_feats, grid.codebook.begin_idxes, grid.codebook.num_feats)
    gen = torch.Generator(device=coords.device).manual_seed(11)
    u0 = torch.rand((n,), generator=gen, device=coords.device)
    parity = stoch_parity(coords, g, args, mask, u0, out_lods)
    err, tol, ties, draws = parity["err"], parity["tol"], parity["tie_draws"], parity["draws"]
    flip_share = parity["flips"] / max(draws, 1)
    require(parity["held"], f"hashgrid_bwd_stoch against its plain version: {parity}")

    # the kernel's own hash over the step's samples
    u0_kernel = torch.empty((n,), device=coords.device)
    hashed = grid_ops.hashgrid_bwd(coords, g, *args, out_lods=out_lods, stoch_mask=mask,
                                   u0_out=u0_kernel)
    u0_mean, u0_ks = float(u0_kernel.mean()), ks_distance(u0_kernel)
    require(abs(u0_mean - 0.5) < 0.01 and u0_ks < 0.01,
            f"the kernel's sin hash is not uniform: mean {u0_mean}, KS {u0_ks}")
    # unbiased: the mean of STOCH_DRAWS draws against the exact backward, entry by entry in
    # units of its Monte-Carlo error (a draw's sd is at most sqrt(sum w g^2))
    exact = grid_ops.hashgrid_bwd(coords, g, *args, out_lods=out_lods)
    spread = grid_ops.hashgrid_bwd(coords, g * g, *args, out_lods=out_lods).sqrt()
    mean = torch.zeros_like(exact)
    for _ in range(STOCH_DRAWS):
        u = torch.rand((n,), generator=gen, device=coords.device)
        mean += grid_ops.hashgrid_bwd(coords, g, *args, out_lods=out_lods, stoch_mask=mask,
                                      u0=u)
    mean /= STOCH_DRAWS
    touched = spread > 0
    z = (mean - exact)[touched] / (spread[touched] / STOCH_DRAWS ** 0.5)
    z_rms, z_over = float((z ** 2).mean().sqrt()), float((z.abs() > 4.0).float().mean())
    require(z_rms <= 1.0 and z_over < 1e-3,
            f"the stochastic backward looks biased: rms z {z_rms}, share over 4 sd {z_over}")

    rows_written = int((hashed != 0).any(dim=1).sum())
    # the coords and the computed LODs' cotangent read once, the whole table gradient written
    nbytes = n * 12 + n * n_lods * f_dim * 4 + args[3] * f_dim * 4
    # a (sample, LOD): the cell (9), 8 corner weights (16), their running sum and the draw
    # (16), the hash and its fold (~8)
    ops = n * n_lods * 49
    row = kernel_row(
        "hashgrid_bwd_stoch", "wisp_tpu_torch/csrc/hashgrid.cu", "wisp_tpu/ops/grid.py:66",
        err, tol,
        timed(lambda: grid_ops.hashgrid_bwd(coords, g, *args, out_lods=out_lods,
                                            stoch_mask=mask)),
        timed(lambda: grid_ops.hashgrid_bwd_plain(coords, g, *args, out_lods=out_lods,
                                                  stoch_mask=mask), iters=3),
        nbytes, ops)
    add_launches_and_was(
        row, lambda: grid_ops.hashgrid_bwd(coords, g, *args, out_lods=out_lods, stoch_mask=mask),
        HASHGRID_V1 and (lambda: HASHGRID_V1.hashgrid_bwd(coords, g, *args, out_lods=out_lods,
                                                          stoch_mask=mask)),
        lambda: stoch_parity(coords, g, args, mask, u0, out_lods,
                             HASHGRID_V1.hashgrid_bwd)["held"], HASHGRID_V1_DESIGN)
    k1_record("stoch step 25 (injected uniforms): bwd", coords,
              k1_geometry(coords, hashed, args, out_lods), grad_out=g, table_rows=args[3],
              stoch_mask=mask, u0=u0)
    exact_ms = timed(lambda: grid_ops.hashgrid_bwd(coords, g, *args, out_lods=out_lods))
    row.update({"exact_bwd_ms": exact_ms[0], "exact_bwd_event_ms": exact_ms[1],
                "flip_share": flip_share, "flips": parity["flips"], "tie_draws": ties,
                "draws": draws, "err_scale": parity["scale"],
                "u0_mean": u0_mean, "u0_ks": u0_ks, "unbiased_z_rms": z_rms,
                "unbiased_z_over_4_share": z_over, "rows_written": rows_written})
    return row, {"samples": n, "trained_lods": n_lods, "stoch_mask": list(mask)}


def stoch_phase(dev):
    """The stochastic-backward hash NeRF from its yaml: parse and build as shipped (4
    views), counts from 0, 20 steps, the trainer's prune, 5 steps, counts read; K1's
    stochastic backward on step 25's inputs; the pipeline saved ('full') and reloaded, the
    train state saved and resumed twice (the state restored bit for bit, 5 steps of each
    and of the original); one render snapshot."""
    import math
    import shutil
    import tempfile
    import warnings
    import numpy as np
    import torch
    from wisp_tpu_torch import kernels
    from wisp_tpu_torch.core.camera import Camera
    from wisp_tpu_torch.core.rays import Rays
    from wisp_tpu_torch.ops import grid as grid_ops
    from wisp_tpu_torch.ops.compaction import compaction_budget
    from wisp_tpu_torch.ops.raygen.raygen import generate_pinhole_rays
    from wisp_tpu_torch.trainers.base_trainer import load_pipeline
    log_dir = tempfile.mkdtemp(prefix="wisp_stoch_")
    try:
        t0 = time.perf_counter()
        try:
            import torch.utils.tensorboard  # noqa: F401
            has_tensorboard = True
        except ImportError:
            has_tensorboard = False
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("default")
            cfg, (pipeline, trainer, renderer) = stoch_app(dev, log_dir)
        tb_warnings = [str(w.message) for w in caught if "tensorboard" in str(w.message)]
        require(len(tb_warnings) == (0 if has_tensorboard else 1),
                f"TensorBoard warnings {tb_warnings} (installed: {has_tensorboard})")
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        grid, tracer = pipeline.nef.grid, pipeline.tracer

        # -- training: counts from 0, 20 steps, prune, 5 steps, counts read right after --
        steps, masks, last = [], [], {}
        kernels.reset_launches()
        with recording_stoch_bwd(masks, last), recording_march_grad("stoch step 25"):
            for i in range(STOCH_STEPS_BEFORE_PRUNE + STOCH_STEPS_AFTER_PRUNE):
                if i == STOCH_STEPS_BEFORE_PRUNE:
                    t1 = time.perf_counter()
                    trainer.prune()
                    torch.cuda.synchronize()
                    prune_ms = (time.perf_counter() - t1) * 1e3
                rays = trainer.train_dataset.transform.num_samples
                budget = tracer.compaction
                t1 = time.perf_counter()
                trainer.iterate()
                torch.cuda.synchronize()
                steps.append({"step": i + 1, "ms": (time.perf_counter() - t1) * 1e3,
                              "rays": rays, "budget": budget,
                              "rule_rows": compaction_budget(rays, tracer.num_steps, budget),
                              "loss": trainer.last_loss})
        launches = dict(kernels.LAUNCHES)
        n_steps = len(steps)
        # once a step; a step whose rays keep no sample has no backward to run
        with_samples = sum(1 for _, _, n in masks if n > 0)
        require(len(masks) == n_steps and launches["hashgrid_bwd_stoch"] == with_samples
                and with_samples >= STOCH_STEPS_BEFORE_PRUNE,
                f"hashgrid_bwd_stoch launched {launches['hashgrid_bwd_stoch']} times in "
                f"{n_steps} steps ({with_samples} with samples)")
        require(launches["hashgrid_bwd"] == 0,
                "the exact K1 backward ran: one launch covers the mixed LOD set")
        missing = [k for k in TRAIN_KERNELS if k != "hashgrid_bwd" and launches[k] <= 0]
        require(not missing, f"kernels not launched on the stoch training path: {missing}")
        for st, (mask, n_lods, samples) in zip(steps, masks):
            st["samples"] = samples
            want = grid_ops.stoch_lods(grid.resolutions[:n_lods], grid.codebook_bitwidth, 3,
                                       st["rule_rows"], grid.dense_lod_matmul)
            require(mask == want, f"step {st['step']}: LOD mask {mask}, the rule at "
                                  f"{st['rule_rows']} rows gives {want}")
            st["stoch_mask"] = "".join("s" if m else "e" for m in mask)
        print(json.dumps({"stoch_rule": [(st["step"], st["rule_rows"], st["stoch_mask"])
                                         for st in steps]}), flush=True)
        losses = [st["loss"] for st in steps]
        require(all(math.isfinite(x) for x in losses), f"non-finite stoch loss: {losses}")
        first, late = sum(losses[:5]) / 5, sum(losses[15:20]) / 5
        require(late < first, f"the stoch loss did not fall: {first} -> {late}")

        # -- the kernel on the last step's own inputs (the last that kept a sample) ---------
        require(bool(last), "no training step kept a sample")
        row, shape_info = stoch_kernel_phase(trainer, last)
        shape_info["step"] = last.pop("launch")
        row["launches"] = launches["hashgrid_bwd_stoch"]
        last.clear()

        # -- the pipeline checkpoint ('full', the yaml's format) and its reload -------------
        cam = Camera.from_args(eye=EYE, at=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0), width=RES,
                               height=RES, fov=np.radians(30.0), near=0.0, far=10.0)
        all_rays = generate_pinhole_rays(cam, device=dev)
        n_chunk = renderer.render_batch
        sl = slice(CHUNK_INDEX * n_chunk, (CHUNK_INDEX + 1) * n_chunk)
        chunk = Rays(all_rays.origins[sl].contiguous(), all_rays.dirs[sl].contiguous(),
                     all_rays.dist_min, all_rays.dist_max)
        model_path = trainer.save_model()
        loaded = load_pipeline(model_path, device=dev)
        with torch.no_grad():
            a, b = pipeline(rays=chunk), loaded(rays=chunk)
        reload_err = max(float((a.channels[k] - b.channels[k]).abs().max())
                         for k in ("rgb", "alpha", "depth"))
        require(reload_err <= 1e-6, f"the reloaded pipeline renders otherwise: {reload_err}")
        require(not loaded.nef.grid.blas.dense, "the reloaded pipeline lost the prune")
        del loaded

        # -- the train state; two trainers resumed from it, restored bit for bit; 5 steps of
        # each and of the original. The card's atomics add in no fixed order, and Adam (eps
        # 1e-16, the grid's lr 0.5) turns a gradient entry that sums to about 0 into a step
        # of either sign, so the codebooks of any two runs from one state part in a few
        # entries: the second resumed trainer measures that in this run, and the original
        # must stay as close to the first as the two resumed ones stay to each other.
        state_path = trainer.save_training_state()
        saved = trainer.state_dict()
        resumed = [stoch_app(dev, log_dir, "--trainer.resume", state_path)[1][1]
                   for _ in range(2)]
        for r in resumed:
            r.begin_training()
            diffs = state_differences(saved, r.state_dict())
            require(not diffs, f"the resumed trainer's state differs at {diffs[:8]}")
        del saved
        pairs = []
        for _ in range(STOCH_RESUME_STEPS):
            trainer.iterate()
            for r in resumed:
                r.iterate()
            pairs.append((trainer.last_loss, resumed[0].last_loss, resumed[1].last_loss))
        loss_rel = max(abs(x - y) / max(abs(x), 1e-30) for x, y, _ in pairs)
        require(loss_rel <= 1e-4, f"the resumed run's losses drift: {pairs}")
        cb = grid.codebook.feats
        cb_a, cb_b = (r.pipeline.nef.grid.codebook.feats for r in resumed)
        cb_tol = 1e-5 * float(cb.detach().abs().max())
        cb_err = float((cb - cb_a).detach().abs().max())
        control_err = float((cb_a - cb_b).detach().abs().max())
        drifted, control = drift_entries(cb, cb_a, cb_tol), drift_entries(cb_a, cb_b, cb_tol)
        require(drifted <= STOCH_DRIFT_RATIO * control + STOCH_DRIFT_SHARE * cb.numel(),
                f"the resumed codebook drifts: {drifted} entries beyond {cb_tol} (largest "
                f"{cb_err}), against {control} (largest {control_err}) between the two "
                f"resumed trainers")
        for r in resumed:
            require(r.epoch == trainer.epoch and r.iteration == trainer.iteration
                    and r.pipeline.tracer.compaction == tracer.compaction,
                    "the resumed trainer's counters or budget differ")
        del resumed, cb_a, cb_b

        # -- one render snapshot through the tracker's visualizer ---------------------------
        images = []
        log_image = trainer.tracker.log_image
        trainer.tracker.log_image = lambda name, image, step: (
            images.append((name, tuple(image.shape))), log_image(name, image, step))
        kernels.reset_launches()
        t1 = time.perf_counter()
        trainer.render_snapshot()
        torch.cuda.synchronize()
        snapshot_ms = (time.perf_counter() - t1) * 1e3
        snap_launches = dict(kernels.LAUNCHES)
        require(all(snap_launches[k] > 0 for k in RENDER_KERNELS)
                and snap_launches["hashgrid_bwd_stoch"] == 0,
                f"render snapshot launches {snap_launches}")
        require(("rgb", (renderer.height, renderer.width, 3)) in images,
                f"snapshot images {images}")
        steady = sorted(st["ms"] for st in steps[1:STOCH_STEPS_BEFORE_PRUNE])
        info = {
            "stoch_path": "main_nerf.parse_args + build (nerf_hash_lego_proxy_stoch.yaml as "
                          f"shipped, {STOCH_VIEWS} views), MultiviewTrainer.iterate x "
                          f"{n_steps} (a prune after {STOCH_STEPS_BEFORE_PRUNE}), "
                          "save_model + load_pipeline, save_training_state + resume, "
                          "render_snapshot",
            "setup_s": setup_s, "step_ms_median": steady[len(steady) // 2],
            "prune_ms": prune_ms, "loss_steps_1_5": first, "loss_steps_16_20": late,
            "steps": steps, "launches": launches, "tensorboard_installed": has_tensorboard,
            "tensorboard_warnings": tb_warnings, "reload_max_abs_err": reload_err,
            "resume_losses": pairs, "resume_loss_max_rel": loss_rel,
            "resume_codebook_max_abs_err": cb_err, "resume_codebook_tol": cb_tol,
            "resume_codebook_drift_entries": drifted, "resume_codebook_entries": cb.numel(),
            "resume_control_max_abs_err": control_err,
            "resume_control_drift_entries": control,
            "snapshot_ms": snapshot_ms, "snapshot_launches": snap_launches,
            "snapshot_images": images, "kernel_phase_shapes": shape_info,
        }
        return [row], info
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)


SEG_EPS = 1e-3
SEG_COUNT = 4
SEG_STEPS_BEFORE_PRUNE = 20
SEG_STEPS_AFTER_PRUNE = 5
SEG_KERNELS = ("raymarch_ray", "compact_live", "scatter_back", "hashgrid_fwd",
               "integrate_seg_fwd", "hashgrid_bwd", "scatter_back_bwd", "integrate_seg_bwd",
               "scatter_max_acc")
SEG_CHECK_SEGMENT = 1          # the kernels are held and timed on this segment's inputs
SEG_DENSITY_BIAS = 30.0        # added to the render field's density for the chunk check


@contextmanager
def recording_segments(calls: list):
    """Record the inputs of the segmented trace's compaction, composite and accumulated
    scatter-max calls (the calls themselves go on unchanged, and count their launches)."""
    from wisp_tpu_torch.tracers import packed_rf_tracer as tr
    compact, integrate_segment, k5 = tr.compact, tr.integrate_segment, tr.scatter_max_points

    def rec_compact(mask, samples, dirs, budget, acc_tau=None, tau_cap=None):
        calls.append({"compact": (mask, samples, dirs, budget, acc_tau.clone(), tau_cap)})
        return compact(mask, samples, dirs, budget, acc_tau, tau_cap)

    def rec_integrate(density, deltas, depths, mask, color, acc_tau, **kw):
        calls[-1]["integrate"] = tuple(t.detach() for t in (density, deltas.reshape(-1),
                                                            depths, mask, color, acc_tau))
        return integrate_segment(density, deltas, depths, mask, color, acc_tau, **kw)

    def rec_scatter_max(points, density, level, out=None, keep=None):
        calls[-1]["scatter_max"] = (points, density, level, out.clone(), keep)
        return k5(points, density, level, out=out, keep=keep)

    with mock.patch.object(tr, "compact", rec_compact), \
            mock.patch.object(tr, "integrate_segment", rec_integrate), \
            mock.patch.object(tr, "scatter_max_points", rec_scatter_max):
        yield


SEG_FWD_TOL = 1e-4             # K6b: rgb, alpha, depth and extras, absolute (K4's)
SEG_ACC_REL_TOL = 1e-5         # K6b: acc_tau out, relative


def seg_fwd_errors(got, want):
    """K6b's errors against the plain version: the largest absolute error of rgb, alpha,
    depth and the extras, and the largest relative error of acc_tau out."""
    err = max([float((got[k] - want[k]).abs().max()) for k in want
               if k != "acc_tau" and want[k].numel()] + [0.0])
    acc = want["acc_tau"]
    rel = (float(((got["acc_tau"] - acc).abs() / acc.abs().clamp(min=1e-30)).max())
           if acc.numel() else 0.0)
    return err, rel


def seg_fwd_within(got, want) -> bool:
    err, rel = seg_fwd_errors(got, want)
    return set(got) == set(want) and err <= SEG_FWD_TOL and rel <= SEG_ACC_REL_TOL


def seg_kernel_phase(calls):
    """K6a, K6b, K6c and K5 accumulated against their plain versions and timed, on one
    segment's inputs of the last step: K6a exactly on every segment (kept slots and count),
    K6b within K4's 1e-4 (acc_tau out 1e-5 relative), K6c within 1e-5 of the largest entry
    of each gradient (dL/dA too), K5 accumulated exactly on every segment."""
    import torch
    from wisp_tpu_torch.ops.compaction import compact, compact_plain
    from wisp_tpu_torch.ops.integration import (integrate_segment, integrate_segment_bwd,
                                                integrate_segment_bwd_plain,
                                                integrate_segment_plain)
    for i, c in enumerate(calls):
        mask, samples, dirs, budget, acc, cap = c["compact"]
        got = compact(mask, samples, dirs, budget, acc, cap)
        want = compact_plain(mask, samples, dirs, budget, acc, cap)
        kept = min(int(want[3]), budget)
        require(torch.equal(got[3], want[3]) and torch.equal(got[0][:kept], want[0][:kept])
                and torch.equal(got[1][:kept], want[1][:kept])
                and torch.equal(got[2][:kept], want[2][:kept]),
                f"compact_live differs from its plain version on segment {i}")
        new, plain, _ = feedback_calls(c["scatter_max"])
        require(grid_equal(new(), plain()), f"scatter_max_acc differs on segment {i}")
    c = calls[SEG_CHECK_SEGMENT]
    mask, samples, dirs, budget, acc, cap = c["compact"]
    r, s = mask.shape
    # the step's carry culls no ray while the field is still transparent: hold the kernel
    # once more with a seeded carry that culls about half of the rays
    g = torch.Generator(device=mask.device).manual_seed(17)
    acc_cull = acc + torch.rand((r,), generator=g, device=mask.device) * (2.0 * cap)
    got = compact(mask, samples, dirs, budget, acc_cull, cap)
    want = compact_plain(mask, samples, dirs, budget, acc_cull, cap)
    kept_cull = min(int(want[3]), budget)
    require(torch.equal(got[3], want[3])
            and all(torch.equal(a[:kept_cull], b[:kept_cull])
                    for a, b in zip(got[:3], want[:3])),
            "compact_live differs from its plain version with a culling carry")
    culled_rays = float((acc_cull >= cap).float().mean())
    live = mask & (acc < cap)[:, None]
    valid = int(live.sum())
    kept = min(valid, budget)
    rows = [kernel_row(
        "compact_live", "wisp_tpu_torch/csrc/compaction.cu",
        "wisp_tpu/tracers/packed_rf_tracer.py:340", 0.0, 0.0,
        timed(lambda: compact(mask, samples, dirs, budget, acc, cap)),
        timed(lambda: compact_plain(mask, samples, dirs, budget, acc, cap), iters=5),
        nbytes=r * s + r * 4 + kept * (12 + 8 + 24) + 8, ops=0.0,
        library_ms=timed(lambda: torch.nonzero((mask & (acc < cap)[:, None]).T)))]
    rows[-1].update(culling_carry_rays_culled=culled_rays, culling_carry_valid=int(want[3]),
                    library_call="torch.nonzero((mask & (acc < cap)[:, None]).T)")
    want = compact_plain(mask, samples, dirs, budget, acc, cap)
    add_launches_and_was(
        rows[-1], lambda: compact(mask, samples, dirs, budget, acc, cap),
        THREEPASS and (lambda: THREEPASS.compact(mask, samples, dirs, budget, acc, cap)),
        lambda: compact_equal(THREEPASS.compact(mask, samples, dirs, budget, acc, cap), want,
                              budget))

    density, deltas, depths, smask, color, acc_in = c["integrate"]
    # K6b on every segment of step 25 and, on the checked segment, with the culling carry
    segs = [(f"segment {i}", cc["integrate"]) for i, cc in enumerate(calls)]
    segs.append((f"segment {SEG_CHECK_SEGMENT}, culling carry",
                 (density, deltas, depths, smask, color, acc_cull)))
    SCATTER_SEG_CALLS.update(segments=segs, tau_cap=cap)
    errs = [seg_fwd_errors(integrate_segment(*a), integrate_segment_plain(*a)) for _, a in segs]
    err, acc_rel = max(e for e, _ in errs), max(e for _, e in errs)
    require(acc_rel <= SEG_ACC_REL_TOL,
            f"integrate_seg_fwd: acc_tau out {acc_rel} relative > {SEG_ACC_REL_TOL}")
    rows.append(kernel_row(
        "integrate_seg_fwd", "wisp_tpu_torch/csrc/integrate.cu",
        "wisp_tpu/tracers/packed_rf_tracer.py:362", err, SEG_FWD_TOL,
        timed(lambda: integrate_segment(density, deltas, depths, smask, color, acc_in)),
        timed(lambda: integrate_segment_plain(density, deltas, depths, smask, color,
                                              acc_in)),
        nbytes=r * s * (4 + 4 + 1 + 12) + r * 4 + r * (12 + 4 + 4) + r * 8, ops=r * s * 16))
    rows[-1].update(acc_tau_rel_err=acc_rel,
                    checked_on=f"the {len(calls)} segments of step 25 and segment "
                               f"{SEG_CHECK_SEGMENT} with the culling carry; timed on "
                               f"segment {SEG_CHECK_SEGMENT}")
    seg_args = (density, deltas, depths, smask, color, acc_in)
    add_launches_and_was(
        rows[-1], lambda: integrate_segment(*seg_args),
        SCATTER_SEG_V1 and (lambda: SCATTER_SEG_V1.integrate_segment(*seg_args)),
        lambda: seg_fwd_within(SCATTER_SEG_V1.integrate_segment(*seg_args),
                               integrate_segment_plain(*seg_args)),
        design=SCATTER_SEG_V1_DESIGN["integrate_seg_fwd"])

    g_rgb = torch.randn((r, 3), generator=g, device=density.device) / r
    g_alpha = torch.randn((r, 1), generator=g, device=density.device) / r
    g_acc = torch.randn((r,), generator=g, device=density.device) / r
    bk = integrate_segment_bwd(density, deltas, depths, smask, color, acc_in, g_rgb, g_alpha,
                               None, g_acc)
    bp = integrate_segment_bwd_plain(density, deltas, depths, smask, color, acc_in, g_rgb,
                                     g_alpha, None, g_acc)
    errs = [float((a - b).abs().max()) for a, b in zip(bk, bp)]
    scales = [max(float(b.abs().max()), 1e-30) for b in bp]
    for name, e, sc in zip(("density", "color", "acc_tau"), errs, scales):
        require(e <= 1e-5 * sc, f"integrate_seg_bwd: d{name} error {e} > 1e-5 x {sc}")
    rows.append(kernel_row(
        "integrate_seg_bwd", "wisp_tpu_torch/csrc/integrate.cu",
        "wisp_tpu/tracers/packed_rf_tracer.py:362", max(errs), 1e-5 * max(scales),
        timed(lambda: integrate_segment_bwd(density, deltas, depths, smask, color, acc_in,
                                            g_rgb, g_alpha, None, g_acc)),
        timed(lambda: integrate_segment_bwd_plain(density, deltas, depths, smask, color,
                                                  acc_in, g_rgb, g_alpha, None, g_acc)),
        nbytes=r * s * (4 + 1 + 12) + r * (4 + 12) + r * s * (4 + 12) + r * 12,
        ops=r * s * 40))
    rows[-1]["errs_density_color_acc"] = errs
    rows[-1]["scales_density_color_acc"] = scales

    rows.append(feedback_row("scatter_max_acc", "wisp_tpu/tracers/packed_rf_tracer.py:383",
                             c["scatter_max"]))
    return rows, {"segment": SEG_CHECK_SEGMENT, "rays": r, "steps": s, "budget": budget,
                  "valid": valid, "marched": int(mask.sum()), "kept": kept,
                  "cells_touched": rows[-1]["cells_touched"]}


def seg_chunk_check(dev):
    """The segmented trace against the unsegmented one on one 16,384-ray chunk of the
    render phase's carved field (its density raised by SEG_DENSITY_BIAS), both at
    compaction 1.0 (no segment's budget overflows where
    the whole ray's would not): eps 1e-20 within 1e-3 with the same valid count; eps
    SEG_EPS within SEG_EPS + 1e-4 in rgb (a culled ray's remaining weight is at most eps);
    then one 512x512 frame with the cull and one without, at the config's compaction."""
    import numpy as np
    import torch
    from wisp_tpu_torch.core.camera import Camera
    from wisp_tpu_torch.core.rays import Rays
    from wisp_tpu_torch.ops.raygen.raygen import generate_pinhole_rays
    from wisp_tpu_torch.trainers.tracker.offline_renderer import OfflineRenderer
    pipeline, _ = flagship_pipeline(dev)
    # the random field is nearly transparent: raise its density so that rays saturate
    # inside the carved balls and the cull has samples to drop
    with torch.no_grad():
        pipeline.nef.decoder_density.lout.bias[0] += SEG_DENSITY_BIAS
    tracer = pipeline.tracer
    renderer = OfflineRenderer(render_res=(RES, RES), device=dev)
    cam = Camera.from_args(eye=EYE, at=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0), width=RES,
                           height=RES, fov=np.radians(30.0), near=0.0, far=10.0)
    all_rays = generate_pinhole_rays(cam, device=dev)
    n_chunk = renderer.render_batch
    sl = slice(CHUNK_INDEX * n_chunk, (CHUNK_INDEX + 1) * n_chunk)
    chunk = Rays(all_rays.origins[sl].contiguous(), all_rays.dirs[sl].contiguous(),
                 all_rays.dist_min, all_rays.dist_max)
    compaction = tracer.compaction

    def trace(eps, comp):
        tracer.seg_early_stop, tracer.seg_count, tracer.compaction = eps, SEG_COUNT, comp
        with torch.no_grad():
            return pipeline(rays=chunk)

    ref = trace(0.0, 1.0)
    tiny = trace(1e-20, 1.0)
    real = trace(SEG_EPS, 1.0)
    err = {k: float((tiny.channels[k] - ref.channels[k]).abs().max())
           for k in ("rgb", "alpha", "depth")}
    require(all(e <= 1e-3 for e in err.values()),
            f"segmented trace at eps 1e-20 differs from the unsegmented one: {err}")
    require(float(tiny.num_valid_samples) == float(ref.num_valid_samples),
            "segmented trace at eps 1e-20: valid count differs")
    real_err = float((real.rgb - ref.rgb).abs().max())
    require(real_err <= SEG_EPS + 1e-4, f"segmented trace at eps {SEG_EPS}: rgb {real_err}")
    marched = float(ref.num_valid_samples)
    share = 1.0 - float(real.num_valid_samples) / marched if marched else 0.0
    frames = {}
    for name, eps in (("cull", SEG_EPS), ("no_cull", 0.0)):
        tracer.seg_early_stop, tracer.compaction = eps, compaction
        renderer.render_lookat(pipeline, f=EYE)         # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        renderer.render_lookat(pipeline, f=EYE)
        torch.cuda.synchronize()
        frames[name] = (time.perf_counter() - t0) * 1e3
    return {"chunk_err_eps_1e-20": err, "chunk_rgb_err_eps": real_err,
            "chunk_valid_marched": marched, "chunk_valid_culled": float(real.num_valid_samples),
            "chunk_cull_share": share, "chunk_seg_frac_max": float(real.seg_frac_max),
            "frame_ms_cull": frames["cull"], "frame_ms_no_cull": frames["no_cull"]}


def seg_phase(dev):
    """The flagship trainer with the segmented cull (seg_early_stop SEG_EPS, SEG_COUNT
    segments) at full width: counts from 0, 20 steps (the 20th profiled), the trainer's
    prune, 5 steps (the last one's segment inputs recorded), counts read; the new kernels against their plain versions
    on step 25's inputs; the segmented trace against the unsegmented one on a render chunk."""
    import math
    import torch
    from wisp_tpu_torch import kernels
    t0 = time.perf_counter()
    trainer = flagship_trainer(dev)
    tracer = trainer.pipeline.tracer
    tracer.seg_early_stop, tracer.seg_count = SEG_EPS, SEG_COUNT
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    steps, calls = [], []
    kernels.reset_launches()
    for i in range(SEG_STEPS_BEFORE_PRUNE + SEG_STEPS_AFTER_PRUNE):
        if i == SEG_STEPS_BEFORE_PRUNE:
            trainer.prune()
        rays, budget = trainer.train_dataset.transform.num_samples, tracer.compaction
        last = i == SEG_STEPS_BEFORE_PRUNE + SEG_STEPS_AFTER_PRUNE - 1
        t0 = time.perf_counter()
        if i == SEG_STEPS_BEFORE_PRUNE - 1:
            profiled = profile_step(trainer)     # step 20 runs under the profiler
        elif last:
            with recording_segments(calls), recording_k1("seg step 25"), \
                    recording_march_grad("seg step 25"), \
                    recording_feedback_gather("seg step 25"):
                trainer.iterate()
        else:
            trainer.iterate()
        torch.cuda.synchronize()
        steps.append({"step": i + 1, "ms": (time.perf_counter() - t0) * 1e3, "rays": rays,
                      "budget": budget, "valid": trainer._prev_num_samples,
                      "seg_frac_max": trainer._prev_seg_frac_max,
                      "overflow": trainer.last_num_overflow, "loss": trainer.last_loss})
    launches = dict(kernels.LAUNCHES)
    missing = [k for k in SEG_KERNELS if launches[k] <= 0]
    require(not missing, f"kernels not launched on the segmented training path: {missing}")
    SCATTER_SEG_CALLS["seg launches"] = {"steps": len(steps),
                                         "integrate_seg_fwd": launches["integrate_seg_fwd"]}
    FEEDBACK_GATHER_CALLS["seg step"] = step_kernels(profiled, launches, len(steps))
    require(launches["integrate_fwd"] == 0 and launches["compact"] == 0,
            "the segmented path launched the unsegmented compaction or composite")
    require(len(calls) == SEG_COUNT, f"step 25 traced {len(calls)} segments")
    losses = [st["loss"] for st in steps]
    require(all(math.isfinite(x) for x in losses), f"non-finite training loss: {losses}")
    rows, shape_info = seg_kernel_phase(calls)
    for row_ in rows:
        row_["launches"] = launches[row_["name"]]
    chunk = seg_chunk_check(dev)
    steady = sorted(st["ms"] for st in steps[1:SEG_STEPS_BEFORE_PRUNE - 1])
    info = {"seg_path": f"MultiviewTrainer.iterate with seg_early_stop {SEG_EPS}, "
                        f"seg_count {SEG_COUNT} (20 steps, prune, 5 steps), flagship width",
            "setup_s": setup_s, "step_ms_median_2_19": steady[len(steady) // 2],
            "steps": steps, "launches": launches, "kernel_phase_shapes": shape_info}
    info.update(profiled)
    info.update(chunk)
    return rows, info


NGLOD_CONFIG = "app/nglod/configs/nglod_octree.yaml"
# the depth cut: one epoch of the yaml's 10 (~4,400 steps of batch 512); the model saved
# ('full') at its end; no TensorBoard (the card's machine has none)
NGLOD_ARGS = ("--trainer.max-epochs", "1", "--trainer.save-every", "1",
              "--trainer.model-format", "full", "--tracker.tensorboard", "false")
NGLOD_EXTRA = ()               # appended to every parse (a CPU rehearsal shrinks here)
NGLOD_TEX = ("--dataset.constructor", "MeshSampledSDFDataset", "--dataset.sample-tex",
             "true", "--nef.constructor", "NeuralSDFTex")
NGLOD_FRAME_RES = 512          # the app's renderer: OfflineRenderer(render_res=(512, 512))
NGLOD_CHUNK = 65536            # tools/sdf_render_bench.py --chunk
NGLOD_COMPACTION = 0.55        # ... --compaction 0.55 --mid-compaction 0.3 --shuffle
NGLOD_MID_COMPACTION = 0.3
NGLOD_MID_AT = 0.5
NGLOD_L8_LEVEL = 8             # above the pidx maps (PIDX_MAP_MAX_LEVEL 7): the search
NGLOD_L8_STEPS = 50
NGLOD_TEX_STEPS = 50
NGLOD_K17_POINTS = 65_536
NGLOD_TRAIN_KERNELS = ("octree_query", "octree_query_interp", "octree_interp_bwd",
                       "mesh_sdf")
NGLOD_FRAME_KERNELS = ("octree_query_interp", "sphere_iter", "sdf_walk", "sphere_step",
                       "compact_rays", "compact_rays_mid", "scatter_rays", "scatter_rays_mid")
# level 8, counted from the app's build: K9's search in the dataset's narrowband filter
NGLOD_L8_KERNELS = ("octree_query_search", "octree_query_interp", "octree_interp_bwd",
                    "free_space_distance", "sdf_walk", "sphere_iter", "sphere_step")
NGLOD_TEX_KERNELS = ("mesh_sdf", "closest_point", "octree_query_interp", "octree_interp_bwd")
# float32 operations of one point-triangle pair in K17 (the plain version's arithmetic):
# the closest point 120, its squared distance 8 and the compare 1 (MESH_SDF_PAIR_OPS's pass
# 1, terms of the triangle alone left out)
CLOSEST_PAIR_OPS = 129


def nglod_app(*extra):
    """(cfg, pipeline, trainer) of nglod_octree.yaml through the port's main_nglod front
    end (parse_args, build), with the depth cut and ``extra`` flags."""
    from wisp_tpu_torch.app.nglod import main_nglod
    cfg = main_nglod.parse_args(["--config", NGLOD_CONFIG, *NGLOD_ARGS, *NGLOD_EXTRA,
                                 *extra])
    return (cfg,) + main_nglod.build(cfg)


@contextmanager
def recording_ray_compaction(calls: list):
    """Record the arguments and results of the SDF tracer's ray compactions."""
    from wisp_tpu_torch.tracers import packed_sdf_tracer
    original = packed_sdf_tracer.compact_rays

    def recording(mask, budget, o, d, t, tf, mid=False):
        out = original(mask, budget, o, d, t, tf, mid=mid)
        calls.append({"mid": mid, "args": (mask.clone(), budget, o.clone(), d.clone(),
                                           t.clone(), tf.clone()), "count": out[5]})
        return out

    with mock.patch.object(packed_sdf_tracer, "compact_rays", recording):
        yield calls


# the calls of the "scatter and segment" step: "scatter" and "scatter mid" (the trained
# NGLOD frame's last compacted chunk's scatter-back of every channel, and its mid pass's:
# the slots and each channel's rows and base, cloned before the call), "segments" ([(key,
# integrate_segment's arguments)]: the seg phase's step 25 and a culling carry) and the
# paths' launches ("frame launches", "seg launches")
SCATTER_SEG_CALLS = {}
SCATTER_NAMES = {False: ("t", "xyz", "hit", "normal"), True: ("t", "hit")}


@contextmanager
def recording_scatters():
    """Keep the SDF tracer's last ``scatter_rows_many`` call of each pass in
    SCATTER_SEG_CALLS."""
    from wisp_tpu_torch.tracers import packed_sdf_tracer
    original = packed_sdf_tracer.scatter_rows_many

    def recording(idx, pairs, mid=False):
        pairs = list(pairs)
        names = SCATTER_NAMES[mid] + tuple(f"extra {i}" for i in
                                           range(len(pairs) - len(SCATTER_NAMES[mid])))
        SCATTER_SEG_CALLS["scatter mid" if mid else "scatter"] = {
            "idx": idx.clone(), "pairs": [(v.clone(), out.clone()) for v, out in pairs],
            "names": names}
        return original(idx, pairs, mid=mid)

    with mock.patch.object(packed_sdf_tracer, "scatter_rows_many", recording):
        yield


def scatter_pairs(rec):
    """A recorded scatter-back's (rows, base) pairs, with fresh copies of the bases."""
    return [(v, out.clone()) for v, out in rec["pairs"]]


def scatter_equal(got, want) -> bool:
    import torch
    return all(bool(torch.equal(a, b)) for a, b in zip(got, want))


def scatter_sizes(rec) -> dict:
    """A recorded scatter-back's slots, rays, kept slots and channels' row bytes."""
    import math
    (v, out), idx = rec["pairs"][0], rec["idx"]
    return {"slots": v.shape[0], "rays": out.shape[0],
            "kept": int((idx[:v.shape[0]] < out.shape[0]).sum()),
            "row_bytes": [math.prod(v.shape[1:]) * v.element_size() for v, _ in rec["pairs"]]}


def scatter_bytes(rec, sizes) -> int:
    """The compulsory bytes of a scatter-back: each slot's index, each kept row read and
    written."""
    return rec["idx"].shape[0] * 8 + sizes["kept"] * 2 * sum(sizes["row_bytes"])


def scatter_row(name, rec):
    """K12's scatter-back row (first pass or mid pass) on a recorded call of every channel:
    bit-equal to the plain version, timed beside the plain version, the library's
    ``index_copy_`` a channel in sequence and the earlier design's launch a channel."""
    import torch
    from wisp_tpu_torch.ops.compaction import scatter_rows_many, scatter_rows_many_plain
    mid = name.endswith("mid")
    idx, pairs = rec["idx"], rec["pairs"]
    want = scatter_rows_many_plain(idx, scatter_pairs(rec))
    require(scatter_equal(scatter_rows_many(idx, scatter_pairs(rec), mid=mid), want),
            f"{name} differs from the plain version")
    sizes = scatter_sizes(rec)
    k, p = sizes["slots"], sizes["rays"]
    work = scatter_pairs(rec)
    padded = [torch.zeros((p + 1,) + tuple(v.shape[1:]), dtype=v.dtype, device=v.device)
              for v, _ in pairs]

    def library():
        for buf, (v, _) in zip(padded, pairs):
            buf.index_copy_(0, idx[:k], v)

    row = kernel_row(
        name, "wisp_tpu_torch/csrc/compaction.cu",
        "wisp_tpu/tracers/packed_sdf_tracer.py:206-207" if mid
        else "wisp_tpu/tracers/packed_sdf_tracer.py:211-217", 0.0, 0.0,
        timed(lambda: scatter_rows_many(idx, work, mid=mid)),
        timed(lambda: scatter_rows_many_plain(idx, work)),
        nbytes=scatter_bytes(rec, sizes), ops=0, library_ms=timed(library))
    row.update(library_call="a sequence: one index_copy_ a channel into P+1 rows (the empty "
                            "slots' row P)",
               checked_on=(f"every channel of the {'mid pass' if mid else 'last compacted chunk'}"
                           f" of the trained frame: " + ", ".join(
                               f"{n} ({b} bytes a row)" for n, b in zip(rec["names"],
                                                                         sizes["row_bytes"]))))
    add_launches_and_was(
        row, lambda: scatter_rows_many(idx, work, mid=mid),
        SCATTER_SEG_V1 and (lambda: SCATTER_SEG_V1.scatter_rows_many(idx, work)),
        lambda: scatter_equal(SCATTER_SEG_V1.scatter_rows_many(idx, scatter_pairs(rec)),
                              want), design=SCATTER_SEG_V1_DESIGN["scatter_rows"])
    return row, {**sizes, "channels": list(rec["names"])}


def trace_chunks(nef, tracer, rays, chunk: int):
    """The tracer's RenderBuffer of each ``chunk`` rays of ``rays`` (no gradient)."""
    import torch
    from wisp_tpu_torch.core.rays import Rays
    n = rays.origins.shape[0]
    with torch.no_grad():
        return [tracer(nef, Rays(rays.origins[i:i + chunk], rays.dirs[i:i + chunk],
                                 rays.dist_min, rays.dist_max)) for i in range(0, n, chunk)]


def compare_traces(nef, base, other, min_dis, strict: bool) -> dict:
    """A compacted trace against the uncompacted one, chunk by chunk: where the chunk
    dropped no ray, the same hits, and depth and normal on the common hits; where it
    dropped rays, no hit that the uncompacted trace lacks. A hit may differ only where the
    field at either trace's final point lies within SDF_HIT_MARGIN of min_dis. ``strict``
    requires that and the depth and normal tolerances (SDF_DEPTH_TOL, SDF_NORMAL_TOL);
    otherwise the counts are only reported."""
    import torch
    out = {"differ": 0, "invented": 0, "beyond_margin": 0, "depth_err": 0.0,
           "normal_err": 0.0, "overflow_chunks": 0}
    for a, b in zip(base, other):
        ha, hb = a.hit[:, 0], b.hit[:, 0]
        with torch.no_grad():
            margin = torch.minimum(
                (nef(channels="sdf", coords=a.xyz)[:, 0].float().abs() - min_dis).abs(),
                (nef(channels="sdf", coords=b.xyz)[:, 0].float().abs() - min_dis).abs())
        if float(b.num_overflow) > 0:
            out["overflow_chunks"] += 1
            bad = hb & ~ha
            out["invented"] += int(bad.sum())
        else:
            bad = ha != hb
            out["differ"] += int(bad.sum())
            both = ha & hb
            if bool(both.any()):
                out["depth_err"] = max(out["depth_err"],
                                       float((a.depth - b.depth)[both].abs().max()))
                out["normal_err"] = max(out["normal_err"],
                                        float((a.normal - b.normal)[both].abs().max()))
        out["beyond_margin"] += int((bad & (margin > SDF_HIT_MARGIN)).sum())
    if strict:
        require(out["beyond_margin"] == 0 and out["depth_err"] <= SDF_DEPTH_TOL
                and out["normal_err"] <= SDF_NORMAL_TOL,
                f"a compacted trace differs from the uncompacted one: {out}")
    return out


@contextmanager
def float32_decoders(pipeline):
    """The pipeline's decoders in float32 (a trained pipeline carries the bf16 compute type
    of AMP training, whose GEMM results round differently with the batch's rows)."""
    from wisp_tpu_torch.models.decoders.basic_decoders import BasicDecoder
    decoders = [m for m in pipeline.modules() if isinstance(m, BasicDecoder)]
    saved = [d.compute_dtype for d in decoders]
    for d in decoders:
        d.compute_dtype = None
    try:
        yield
    finally:
        for d, dtype in zip(decoders, saved):
            d.compute_dtype = dtype


def nglod_frame(dev, pipeline, tracker):
    """The trained field's frame as tools/sdf_render_bench.py --compaction 0.55
    --mid-compaction 0.3 --shuffle takes it: the app renderer's 512x512 rays (the
    tracker's snapshot camera), permuted by default_rng(0), traced in chunks of 65,536 by
    the yaml's PackedSDFTracer (its free-space field held) uncompacted, compacted and with
    the mid-loop pass; counts from 0 before the three timed frames, read after."""
    import copy
    import numpy as np
    import torch
    from wisp_tpu_torch import kernels
    from wisp_tpu_torch.core.camera import Camera
    from wisp_tpu_torch.core.rays import Rays
    from wisp_tpu_torch.ops.raygen.raygen import generate_pinhole_rays
    nef = pipeline.nef
    vis = tracker.cfg.vis_camera
    cam = Camera.from_args(eye=tuple(vis.camera_origin), at=tuple(vis.camera_lookat),
                           up=(0.0, 1.0, 0.0), width=NGLOD_FRAME_RES,
                           height=NGLOD_FRAME_RES, fov=np.radians(vis.camera_fov),
                           near=vis.camera_clamp[0], far=vis.camera_clamp[1])
    rays = generate_pinhole_rays(cam, device=dev)
    n = rays.origins.shape[0]
    perm = torch.from_numpy(np.random.default_rng(0).permutation(n)).to(dev)
    rays = Rays(rays.origins.reshape(-1, 3)[perm].contiguous(),
                rays.dirs.reshape(-1, 3)[perm].contiguous(), rays.dist_min, rays.dist_max)
    base = pipeline.tracer.with_free_dist(nef.grid.blas)
    variants = {"uncompacted": {}, "compacted": {"compaction": NGLOD_COMPACTION},
                "mid": {"compaction": NGLOD_COMPACTION,
                        "mid_compaction": NGLOD_MID_COMPACTION, "mid_at": NGLOD_MID_AT}}
    tracers = {}
    for name, kw in variants.items():
        tracers[name] = copy.copy(base)
        for k, v in kw.items():
            setattr(tracers[name], k, v)
        trace_chunks(nef, tracers[name], rays, NGLOD_CHUNK)        # warm-up
    torch.cuda.synchronize()
    kernels.reset_launches()
    frames = {}
    for name, tracer in tracers.items():
        t0 = time.perf_counter()
        outs = trace_chunks(nef, tracer, rays, NGLOD_CHUNK)
        torch.cuda.synchronize()
        frames[name] = {"ms": (time.perf_counter() - t0) * 1e3, "outs": outs}
    launches = dict(kernels.LAUNCHES)
    missing = [k for k in NGLOD_FRAME_KERNELS if launches[k] <= 0]
    require(not missing, f"kernels not launched on the trained-field frame: {missing}")
    # a chunk: num_steps sphere iterations and a closing sphere_step a loop (two loops
    # with the mid pass), the normals' 6 taps through the fused query; no K9, no K15
    chunks = -(-n // NGLOD_CHUNK)
    loops = sum(1 if t.mid_compaction is None else 2 for t in tracers.values())
    # and one scatter-back a compacted chunk, one more a mid pass (every channel in it)
    want = {"sphere_iter": chunks * base.num_steps * len(tracers),
            "sphere_step": chunks * loops, "octree_query_interp":
            chunks * SDF_FD_TAPS * len(tracers), "octree_query": 0, "octree_interp": 0,
            "scatter_rays": chunks * sum(t.compaction is not None for t in tracers.values()),
            "scatter_rays_mid": chunks * sum(t.mid_compaction is not None
                                             for t in tracers.values())}
    got = {k: launches[k] for k in want}
    require(got == want, f"trained-field frame launches {got}, expected {want}")
    calls = []
    with recording_ray_compaction(calls), recording_scatters():
        trace_chunks(nef, tracers["mid"], rays, NGLOD_CHUNK)
    SCATTER_SEG_CALLS["frame launches"] = {
        "frames": len(tracers), "chunks_a_frame": chunks,
        **{k: launches[k] for k in ("scatter_rays", "scatter_rays_mid")}}
    first = [c for c in calls if not c["mid"]]
    mids = [c for c in calls if c["mid"]]
    info = {"frame_rays": n, "chunk": NGLOD_CHUNK,
            "live_share_after_walk": sum(int(c["count"]) for c in first) / n,
            "alive_share_at_mid_at": sum(int(c["count"]) for c in mids) / n,
            "budget": first[0]["args"][1], "mid_budget": mids[0]["args"][1]}
    # the checks: the frames as rendered (the decoders' AMP compute type), counted, and
    # the same traces with float32 decoders, held to the rules of compare_traces
    f32 = {}
    with float32_decoders(pipeline):
        for name, tracer in tracers.items():
            label = "uncompacted, a chunk of permuted rays" if name == "uncompacted" else name
            with recording_octree_grid(f"nglod frame: {label}"), \
                    recording_walks("nglod frame" if name == "uncompacted" else None):
                f32[name] = trace_chunks(nef, tracer, rays, NGLOD_CHUNK)
    base_outs = frames["uncompacted"]["outs"]
    for name, fr in frames.items():
        outs = fr["outs"]
        hits = sum(int(o.hit.sum()) for o in outs)
        info[name] = {"frame_ms": fr["ms"], "rays_per_s": n / (fr["ms"] / 1e3),
                      "hit_share": hits / n,
                      "overflow": sum(float(o.num_overflow) for o in outs)}
        finite = all(bool(torch.isfinite(o.depth).all() and torch.isfinite(o.normal).all())
                     for o in outs)
        require(finite, f"non-finite channels in the {name} frame")
        if name != "uncompacted":
            info[name]["vs_uncompacted_as_rendered"] = compare_traces(
                nef, base_outs, outs, base.min_dis, strict=False)
            with float32_decoders(pipeline):
                info[name]["vs_uncompacted_float32"] = compare_traces(
                    nef, f32["uncompacted"], f32[name], base.min_dis, strict=True)
    require(info["uncompacted"]["hit_share"] > 0.2,
            f"the trained field's frame hits {info['uncompacted']['hit_share']} of its rays")
    info["launches"] = {k: launches[k] for k in NGLOD_FRAME_KERNELS}
    info["expected_launches"] = want
    # one compacted chunk under the profiler
    chunk = Rays(rays.origins[:NGLOD_CHUNK], rays.dirs[:NGLOD_CHUNK], rays.dist_min,
                 rays.dist_max)

    def trace_chunk():
        with torch.no_grad():
            tracers["mid"](nef, chunk)

    wall_ms, busy_ms, top_kernels, _ = profile_call(trace_chunk)
    info["profile_chunk"] = {"ms": wall_ms, "device_busy_ms": busy_ms,
                             "device_idle_share": idle_share(busy_ms, wall_ms),
                             "top_device_kernels": top_kernels}
    return info, launches, calls


def ray_compaction_rows(calls, launches):
    """K12's compaction (first and mid-loop pass) and its scatter-back against their plain
    versions on the recorded last chunk's inputs, exactly, and timed."""
    import torch
    from wisp_tpu_torch.ops.compaction import compact_rays, compact_rays_plain
    rows, shapes = [], {}
    for name, call in (("compact_rays", [c for c in calls if not c["mid"]][-1]),
                       ("compact_rays_mid", [c for c in calls if c["mid"]][-1])):
        mask, budget, o, d, t, tf = call["args"]
        mid = name.endswith("mid")
        got = compact_rays(mask, budget, o, d, t, tf, mid=mid)
        want = compact_rays_plain(mask, budget, o, d, t, tf)
        require(all(torch.equal(a, b) for a, b in zip(got, want)),
                f"{name} differs from the plain version")
        r, kept = mask.shape[0], min(int(want[5]), budget)
        rows.append(kernel_row(
            name, "wisp_tpu_torch/csrc/compaction.cu",
            "wisp_tpu/tracers/packed_sdf_tracer.py:182" if not mid
            else "wisp_tpu/tracers/packed_sdf_tracer.py:196", 0.0, 0.0,
            timed(lambda: compact_rays(mask, budget, o, d, t, tf, mid=mid)),
            timed(lambda: compact_rays_plain(mask, budget, o, d, t, tf)),
            nbytes=r + 8 + kept * (32 + 8 + 32) + (budget - kept) * (8 + 32) + 32,
            ops=r * 2, library_ms=timed(lambda: torch.nonzero(mask))))
        rows[-1]["library_call"] = "torch.nonzero(mask)"
        add_launches_and_was(
            rows[-1], lambda: compact_rays(mask, budget, o, d, t, tf, mid=mid),
            THREEPASS and (lambda: THREEPASS.compact_rays(mask, budget, o, d, t, tf)),
            lambda: rays_equal(THREEPASS.compact_rays(mask, budget, o, d, t, tf), want))
        shapes[name] = {"rays": r, "budget": budget, "count": int(want[5])}
    # the scatter-back of every channel of the last compacted chunk and of its mid pass,
    # as the tracer called it
    for name, key in (("scatter_rays", "scatter"), ("scatter_rays_mid", "scatter mid")):
        row, shapes[name] = scatter_row(name, SCATTER_SEG_CALLS[key])
        rows.append(row)
    for row_ in rows:
        row_["launches"] = launches[row_["name"]]
    return rows, shapes


def search_row(coords, blas, launches):
    """K9's binary search at level 8 against its plain version on a training batch's
    points, with and without the ancestor chain (exactly), timed with the chain (as
    OctreeGrid.interpolate asks)."""
    import torch
    from wisp_tpu_torch.accelstructs.octree_as import octree_query, octree_query_plain
    from wisp_tpu_torch.ops.spc.core import morton3d, quantize_points
    level, routes = blas.max_level, blas.query_routes
    for wp in (False, True):
        got = octree_query(coords, routes, level, wp)
        want = octree_query_plain(coords, routes, level, wp)
        require(torch.equal(got, want), f"octree_query (search, with_parents={wp}) differs "
                                        f"from the plain version")
    n = coords.shape[0]
    q = quantize_points(coords, level)
    entries = 0
    for l in range(level + 1):
        ql = q >> (level - l)
        if routes[l].kind == "map":
            entries += int(torch.unique((ql[:, 0] * 2 ** l + ql[:, 1]) * 2 ** l
                                        + ql[:, 2]).numel())
        else:      # the table entries the searches end on
            i = torch.searchsorted(routes[l].table, morton3d(ql).to(torch.int32))
            entries += int(torch.unique(i).numel())
    table = routes[level].table
    row = kernel_row(
        "octree_query_search", "wisp_tpu_torch/csrc/octree.cu",
        "wisp_tpu/accelstructs/octree_as.py:228", 0.0, 0.0,
        timed(lambda: octree_query(coords, routes, level, True)),
        timed(lambda: octree_query_plain(coords, routes, level, True)),
        nbytes=n * 12 + n * (level + 1) * 4 + entries * 4,
        ops=n * (3 * 4 + (level + 1) * 6 + 5 * int(table.shape[0]).bit_length()))
    row["launches"] = launches["octree_query_search"]
    return row, {"points": n, "level": level, "table_rows": int(table.shape[0]),
                 "entries_read": entries}


def closest_point_row(points, vertices, faces, launches):
    """K17 against its plain version on NGLOD_K17_POINTS of the texture dataset's points:
    the triangle equal except where two triangles lie within 2 ulp of the least squared
    distance, distance and point within 1e-6; timed on all the dataset's points, beside the
    earlier design."""
    from wisp_tpu_torch.ops.mesh.compute_sdf import (closest_point, closest_point_plain,
                                                     triangle_table)
    tris = triangle_table(vertices, faces, points.device)
    sub = points[:NGLOD_K17_POINTS].contiguous()
    want = closest_point_plain(sub, tris)
    err, ties = closest_mismatch(closest_point(sub, tris), want, sub, tris)
    p_all, t_all = points.shape[0], tris.shape[0]
    row = kernel_row(
        "closest_point", "wisp_tpu_torch/csrc/mesh_sdf.cu",
        "wisp_tpu/ops/mesh/compute_sdf.py:144", err, 1e-6,
        timed(lambda: closest_point(points, tris), iters=5, warmup=1),
        events_only(lambda: closest_point_plain(points, tris), iters=1, warmup=1),
        nbytes=p_all * 12 + t_all * 9 * 4 + p_all * (4 + 12 + 8),
        ops=p_all * t_all * CLOSEST_PAIR_OPS + t_all * MESH_TRIANGLE_OPS)

    def was_ok():
        return closest_mismatch(MESH_V1.closest_point(sub, tris), want, sub, tris)[0] <= 1e-6

    add_launches_and_was(row, lambda: closest_point(points, tris),
                         MESH_V1 and (lambda: MESH_V1.closest_point(points, tris)), was_ok,
                         MESH_V1_DESIGN)
    row["launches"] = launches["closest_point"]
    row["plain_timed_by"] = "CUDA events only"
    row["checked_points"] = int(sub.shape[0])
    row["ties"] = ties
    return row, {"k17_points": p_all, "k17_triangles": t_all}


def nglod_phase(dev):
    """The NGLOD app from its yaml: train one epoch (counts from 0, read after) and save,
    reload with --pretrained --valid-only, render the trained field three ways, a level-8
    octree (50 steps and a render chunk), the texture SDF (a resample and 50 steps), then
    the new kernels against their plain versions."""
    import math
    import os
    import shutil
    import tempfile
    import torch
    from wisp_tpu_torch import kernels
    from wisp_tpu_torch.ops.mesh.compute_sdf import mesh_sdf, triangle_table
    log_dir = tempfile.mkdtemp(prefix="wisp_nglod_")
    info, rows = {}, []
    try:
        # -- 1. train one epoch, validate, save ---------------------------------------------
        t0 = time.perf_counter()
        cfg, pipeline, trainer = nglod_app("--tracker.log-dir", log_dir,
                                           "--tracker.run-name", "train")
        torch.cuda.synchronize()
        info["setup_s"] = time.perf_counter() - t0
        require(cfg.device == "cuda" and cfg.blas_level == 7 and cfg.grid.num_lods == 6
                and cfg.trainer.batch_size == 512, f"the yaml did not parse as shipped: {cfg}")
        steps, resample = [], {}
        kernels.reset_launches()
        t_train = time.perf_counter()
        with resample_timer(resample), recording_march_grad("nglod app step"):
            while trainer.is_optimization_running:
                t0 = time.perf_counter()
                trainer.iterate()
                steps.append((time.perf_counter() - t0) * 1e3)
            metrics = trainer.validate()
        torch.cuda.synchronize()
        info["train_s"] = time.perf_counter() - t_train
        launches = dict(kernels.LAUNCHES)
        missing = [k for k in NGLOD_TRAIN_KERNELS if launches[k] <= 0]
        require(not missing, f"kernels not launched training the NGLOD app: {missing}")
        require(launches["octree_query_search"] == 0, "a level-7 octree took the search")
        require(all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in metrics.values()),
                f"bad IoUs {metrics}")
        steady = sorted(steps[1:-2])
        info.update(steps=len(steps), step_ms_median=steady[len(steady) // 2],
                    step_ms_mean=sum(steady) / len(steady), epoch_step_ms=steps[-1],
                    resample_s=resample, metrics=metrics,
                    l2_loss=trainer.return_dict.get("l2_loss"),
                    train_launches={k: launches[k] for k in NGLOD_TRAIN_KERNELS},
                    dataset_size=len(trainer.train_dataset))
        print(json.dumps({"nglod_train": {k: info[k] for k in (
            "setup_s", "train_s", "steps", "step_ms_median", "resample_s", "metrics")}}),
              flush=True)

        # -- 2. reload with --pretrained --valid-only --------------------------------------
        model = os.path.join(trainer.tracker.log_dir, "model.ckpt")
        require(os.path.exists(model), f"no model saved at {model}")
        _, reloaded, again = nglod_app("--tracker.log-dir", log_dir, "--tracker.run-name",
                                       "reload", "--pretrained", model, "--valid-only",
                                       "true")
        m2 = again.validate()
        require(m2["volumetric_iou"] == metrics["volumetric_iou"],
                f"the reloaded model's volumetric IoU {m2} differs from {metrics}")
        trainer.train_dataset = again.train_dataset      # the same weights on the same data
        m1 = trainer.validate()
        require(m1 == m2, f"the reloaded model's IoUs {m2} differ from the trained {m1}")
        info["reload_metrics"] = m2

        # -- 3. the trained field, three ways --------------------------------------------
        frame, frame_launches, calls = nglod_frame(dev, reloaded, again.tracker)
        info["frame"] = frame
        print(json.dumps({"nglod_frame": {k: v for k, v in frame.items()
                                          if k != "profile_chunk"}}), flush=True)
        compaction_rows, shapes = ray_compaction_rows(calls, frame_launches)
        rows += compaction_rows
        info["kernel_phase_shapes"] = shapes
        del pipeline, trainer, reloaded, again, calls
        torch.cuda.empty_cache()

        # -- 4. a level-8 octree (counts from 0 before the build: its dataset's narrowband
        # filter is the path's K9 search) ---------------------------------------------------
        kernels.reset_launches()
        t0 = time.perf_counter()
        _, pipe8, tr8 = nglod_app("--tracker.log-dir", log_dir, "--tracker.run-name", "l8",
                                  "--blas-level", str(NGLOD_L8_LEVEL))
        torch.cuda.synchronize()
        l8 = {"setup_s": time.perf_counter() - t0,
              "level_counts": list(pipe8.nef.grid.blas.level_counts),
              "dataset_size": len(tr8.train_dataset)}
        require(pipe8.nef.grid.blas.query_routes[NGLOD_L8_LEVEL].kind == "search",
                "the level-8 octree's max level is not binary-searched")
        ms = []
        with recording_march_grad("nglod level 8 step"):
            for i in range(NGLOD_L8_STEPS):
                if i == NGLOD_L8_STEPS - 1:
                    l8.update(profile_step(tr8))
                    continue
                t0 = time.perf_counter()
                tr8.iterate()
                ms.append((time.perf_counter() - t0) * 1e3)
        tracer8 = pipe8.tracer
        from wisp_tpu_torch.core.rays import Rays
        g = torch.Generator(device="cpu").manual_seed(31)
        o = torch.tensor([[0.0, 0.6, -3.0]]).expand(NGLOD_CHUNK, 3)
        target = (torch.rand(NGLOD_CHUNK, 3, generator=g) * 1.6 - 0.8)
        d = torch.nn.functional.normalize(target - o, dim=-1)
        t0 = time.perf_counter()
        with torch.no_grad(), recording_octree_grid("nglod level 8 chunk"), \
                recording_walks("nglod level 8 chunk"):
            rb8 = tracer8(pipe8.nef, Rays(o.contiguous().to(dev), d.to(dev), 0.0, 10.0))
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        missing = [k for k in NGLOD_L8_KERNELS if launches[k] <= 0]
        require(not missing, f"kernels not launched at level 8: {missing}")
        require(bool(torch.isfinite(rb8.depth).all()), "non-finite level-8 chunk")
        l8.update(step_ms_median=sorted(ms[1:])[len(ms) // 2], chunk_ms=(time.perf_counter()
                  - t0) * 1e3, chunk_hit_share=float(rb8.hit.float().mean()),
                  loss=tr8.last_loss, launches={k: launches[k] for k in NGLOD_L8_KERNELS})
        require(math.isfinite(tr8.last_loss), "non-finite level-8 loss")
        data8 = tr8.train_dataset
        idx = torch.from_numpy(tr8._batch_rng.integers(0, len(data8), size=(512,)))
        batch = data8[idx.to(dev)].coords.contiguous()
        row, l8["search_shapes"] = search_row(batch, pipe8.nef.grid.blas, launches)
        rows.append(row)
        info["level8"] = l8
        print(json.dumps({"nglod_level8": {k: v for k, v in l8.items()
                                           if not k.startswith("step_top")}}), flush=True)
        del pipe8, tr8, data8, rb8
        torch.cuda.empty_cache()

        # -- 5. the texture SDF --------------------------------------------------------------
        t0 = time.perf_counter()
        _, pipet, trt = nglod_app("--tracker.log-dir", log_dir, "--tracker.run-name", "tex",
                                  *NGLOD_TEX)
        torch.cuda.synchronize()
        tex = {"setup_s": time.perf_counter() - t0, "nef": type(pipet.nef).__name__,
               "dataset": type(trt.train_dataset).__name__}
        kernels.reset_launches()
        t0 = time.perf_counter()
        with recording_mesh("nglod texture resample"):
            trt.train_dataset.resample()
        torch.cuda.synchronize()
        tex["resample_s"] = time.perf_counter() - t0
        losses = []
        for _ in range(NGLOD_TEX_STEPS):
            trt.iterate()
            losses.append(trt.last_loss)
        launches = dict(kernels.LAUNCHES)
        missing = [k for k in NGLOD_TEX_KERNELS if launches[k] <= 0]
        require(not missing, f"kernels not launched on the texture path: {missing}")
        require(all(math.isfinite(x) for x in losses), "non-finite texture loss")
        data = trt.train_dataset
        require(data.rgb_data is not None and tuple(data.rgb_data.shape) == (len(data), 3),
                "the texture dataset carries no colours")
        tex.update(loss_first=losses[0], loss_last=losses[-1],
                   rgb_mean=data.rgb_data.mean(0).tolist(), dataset_size=len(data),
                   launches={k: launches[k] for k in NGLOD_TEX_KERNELS})
        row, tex["k17_shapes"] = closest_point_row(data.coordinates, data.vertices,
                                                   data.faces, launches)
        rows.append(row)
        tris = triangle_table(data.vertices, data.faces, dev)
        tex["k16_ms"] = timed(lambda: mesh_sdf(data.coordinates, tris), iters=5, warmup=1)
        band_pairs = int(mesh_band_sizes(data.coordinates, tris).sum())
        tex["k16_bound_ms"] = bound(len(data) * 16 + tris.shape[0] * 60,
                                    mesh_sdf_ops(len(data), tris.shape[0], band_pairs))
        tex["k17_ms"], tex["k17_bound_ms"] = (row["ms"], row["event_ms"]), (row["bound_ms"],
                                                                            row["bound_by"])
        info["texture"] = tex
        print(json.dumps({"nglod_texture": tex}), flush=True)
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    info["nglod_path"] = (f"main_nglod parse_args/build of {NGLOD_CONFIG}: one epoch, a save "
                          f"and a --pretrained --valid-only reload, the trained field at "
                          f"{NGLOD_FRAME_RES}x{NGLOD_FRAME_RES} three ways, level 8, texture")
    return rows, info


# -- the SPC browser (K13 first-hit walk, K10 DDA raytrace) --------------------------------
SPC_LEVEL = 7                  # tools/spc_render_bench.py: a level-7 coloured SPC
SPC_SAMPLES = 1_000_000        # ... of 1,000,000 surface samples
SPC_RADIUS, SPC_SUBDIV = 0.7, 4  # ... of a radius-0.7, subdivision-4 icosphere
SPC_SIDE = 512                 # 512x512 orthographic rays
SPC_CHUNK = 65_536
SPC_STEPS = 64                 # the walk's budget
SPC_CHECK_CHUNK = 1            # the chunk the kernels are held and timed on
SPC_FRAMES = 3
SPC_DEPTH_NUDGE = 2e-2         # of a voxel: JAX's first-hit equivalence (test_tracers_spc.py)


def spc_rays(dev):
    """The bench's orthographic frame: x, y over linspace(-0.95, 0.95), z = -3, along +z."""
    import numpy as np
    import torch
    from wisp_tpu_torch.core.rays import Rays
    xs = np.linspace(-0.95, 0.95, SPC_SIDE, dtype=np.float32)
    xx, yy = np.meshgrid(xs, xs, indexing="ij")
    n = SPC_SIDE * SPC_SIDE
    origins = np.stack([xx.ravel(), yy.ravel(), np.full(n, -3.0, np.float32)], axis=-1)
    dirs = np.zeros_like(origins)
    dirs[:, 2] = 1.0
    return Rays(torch.from_numpy(origins).to(dev), torch.from_numpy(dirs).to(dev), 0.0, 10.0)


def first_hit_check(rb, rt, blas, rays) -> dict:
    """The walk's first hit against the DDA's first interval on the same rays (JAX's
    equivalence, tests/core/test_tracers_spc.py): the same hit set, depth within the
    boundary nudge, and the same first cell except for ties at a cell corner (under 1%)."""
    import torch
    voxel = 2.0 / 2 ** blas.max_level
    hit = rb.hit[:, 0]
    ref_hit = rt.mask.any(dim=-1)
    first = rt.mask.to(torch.int64).argmax(dim=-1, keepdim=True)
    ref_t = rt.t_entry.gather(1, first)[:, 0]
    ref_pidx = rt.pidx.gather(1, first)[:, 0]
    pidx = blas.query(rays.origins + rb.depth * rays.dirs).pidx
    out = {"rays": int(hit.numel()), "hits": int(hit.sum()),
           "hit_set_differs": int((hit != ref_hit).sum()),
           "dda_overflow": int(rt.overflow.sum()),
           "max_depth_diff_in_voxels": float((rb.depth[:, 0] - ref_t)[hit].abs().max()) / voxel,
           "pidx_differs": int((pidx != ref_pidx)[hit].sum())}
    require(out["dda_overflow"] == 0, f"the DDA overflowed its capacity: {out}")
    require(out["hit_set_differs"] == 0, f"the walk's hits are not the DDA's: {out}")
    require(out["max_depth_diff_in_voxels"] <= SPC_DEPTH_NUDGE,
            f"the walk's depth is not the DDA's entry: {out}")
    require(out["pidx_differs"] <= 0.01 * out["hits"], f"first cells differ: {out}")
    return out


def spc_kernel_rows(blas, tracer, rays, launches) -> list:
    """K13 and K10 against their plain versions on one chunk, exactly, and timed."""
    import torch
    from wisp_tpu_torch.accelstructs.octree_as import aabb_intersect, raytrace, raytrace_plain
    from wisp_tpu_torch.tracers.packed_spc_tracer import spc_trace, spc_trace_plain
    level = blas.max_level
    o, d = rays.origins, rays.dirs
    n = o.shape[0]
    route = blas.query_routes[level]
    args = (o, d, rays.dist_min, rays.dist_max, tracer.free_dist, blas.occ_grid, route, level,
            SPC_STEPS)
    got, want = spc_trace(*args), spc_trace_plain(*args)
    require(all(torch.equal(a, b) for a, b in zip(got, want)),
            "spc_trace differs from the plain version")
    t_near, t_far = aabb_intersect(o, d, rays.dist_min, rays.dist_max)
    t0 = t_near.clamp(min=0.0) + 1e-6
    work = walk_work(o, d, t0, t_far > t0, t_far, tracer.free_dist, level, SPC_STEPS)
    taken, walk_cells = work["steps_taken"], work["cells_read"]
    hits = int(got[1].sum())
    rows = [kernel_row(
        "spc_trace", "wisp_tpu_torch/csrc/sphere_trace.cu",
        "wisp_tpu/tracers/packed_spc_tracer.py:50", 0.0, 0.0,
        timed(lambda: spc_trace(*args)), timed(lambda: spc_trace_plain(*args), iters=3),
        nbytes=n * 24 + walk_cells * 4 + n * (4 + 1 + 4) + hits * (1 + 4),
        ops=taken * 50 + n * 30)]
    rows[-1]["launches"] = launches["spc_trace"]
    if SPHERE_TRACE_V1 is not None:
        walk_row_extras(rows[-1], "spc_trace", args, work)
    capacity, steps = min(3 * 2 ** level + 2, 512), 3 * 2 ** level + 2
    rargs = (o, d, rays.dist_min, rays.dist_max, route, level, capacity, steps)
    rk, rp = raytrace(*rargs), raytrace_plain(*rargs)
    for key in ("pidx", "t_entry", "t_exit", "mask", "overflow"):
        require(torch.equal(getattr(rk, key), getattr(rp, key)),
                f"raytrace: {key} differs from the plain version")
    rows.append(kernel_row(
        "raytrace", "wisp_tpu_torch/csrc/octree.cu",
        "wisp_tpu/accelstructs/octree_as.py:308", 0.0, 0.0,
        timed(lambda: raytrace(*rargs)), events_only(lambda: raytrace_plain(*rargs), iters=2,
                                                     warmup=1),
        nbytes=n * 24 + n * capacity * 13 + n, ops=0.0))
    rows[-1]["launches"] = launches["raytrace"]
    rows[-1]["intervals"] = int(rk.mask.sum())
    return rows


def spc_phase(dev):
    """The SPC browser at tools/spc_render_bench.py's width: build the coloured SPC, counts
    from 0, the free-space field once and one frame through OfflineRenderer.render in
    chunks, counts read; the frame's checks; SPCField's raytrace of one chunk (counts from
    0: K10) held to the walk's first hit; K13 and K10 against their plain versions; the
    frame timed and profiled; main_spc_browser.main at its defaults timed."""
    import os
    import shutil
    import tempfile
    import numpy as np
    import torch
    from wisp_tpu_torch import kernels
    from wisp_tpu_torch.accelstructs.octree_as import OctreeAS
    from wisp_tpu_torch.core.rays import Rays
    from wisp_tpu_torch.examples.spc_browser import main_spc_browser
    from wisp_tpu_torch.models.nefs.spc_field import SPCField
    from wisp_tpu_torch.models.pipeline import Pipeline
    from wisp_tpu_torch.ops.mesh.io import make_sphere_mesh
    from wisp_tpu_torch.ops.mesh.ops import sample_surface
    from wisp_tpu_torch.ops.spc.conversions import pointcloud_to_octree
    from wisp_tpu_torch.tracers.packed_spc_tracer import PackedSPCTracer
    from wisp_tpu_torch.trainers.tracker.offline_renderer import OfflineRenderer
    info = {}
    t0 = time.perf_counter()
    v, f = make_sphere_mesh(radius=SPC_RADIUS, subdivisions=SPC_SUBDIV)
    samples = sample_surface(v, f, SPC_SAMPLES)
    codes, cell_colors = pointcloud_to_octree(samples, SPC_LEVEL,
                                              attributes=(samples + 1.0) / 2.0)
    blas = OctreeAS.from_codes(codes, device=dev)
    nef = SPCField(blas=blas, colors=cell_colors, device=dev)
    torch.cuda.synchronize()
    info["build_s"] = time.perf_counter() - t0
    info["leaves"] = int(blas.level_counts[-1])
    info["level_counts"] = list(blas.level_counts)
    print(json.dumps({"spc_scene": {"leaves": info["leaves"], "build_s": info["build_s"]}}),
          flush=True)
    rays = spc_rays(dev)
    renderer = OfflineRenderer(render_batch=SPC_CHUNK, device=dev)
    chunks = -(-rays.origins.shape[0] // SPC_CHUNK)

    # -- the main path: counts from 0, the free-space field once, one frame ---------------
    kernels.reset_launches()
    t0 = time.perf_counter()
    pipeline = Pipeline(nef=nef, tracer=PackedSPCTracer(num_steps=SPC_STEPS)
                        .with_free_dist(blas))
    rb = renderer.render(pipeline, rays)
    torch.cuda.synchronize()
    info["first_frame_ms"] = (time.perf_counter() - t0) * 1e3
    launches = dict(kernels.LAUNCHES)
    want = {"free_space_distance": 1, "spc_trace": chunks}
    require({k: launches[k] for k in want} == want
            and not any(n for k, n in launches.items() if k not in want),
            f"spc frame launches {launches}, expected exactly {want}")
    depth, rgb, alpha, hit = rb.depth, rb.rgb, rb.alpha, rb.hit
    n = rays.origins.shape[0]
    require(tuple(depth.shape) == (n, 1) and tuple(rgb.shape) == (n, 3)
            and tuple(hit.shape) == (n, 1), f"bad spc frame shapes {rb}")
    require(all(bool(torch.isfinite(t).all()) for t in (depth, rgb, alpha)),
            "non-finite spc frame")
    require(torch.equal(alpha, hit.to(alpha.dtype)), "alpha is not the hit mask")
    hit_share = float(hit.float().mean())
    # the sphere covers pi 0.7^2 / 1.9^2 = 0.426 of the frame
    require(0.35 < hit_share < 0.5, f"hit share {hit_share}: not the sphere's 0.43")
    require(float((rgb[~hit[:, 0]]).abs().max()) == 0.0
            and float(rgb[hit[:, 0]].min()) > 0.0, "rgb is not the hit cells' colours")
    info.update(hit_share=hit_share, num_overflow=float(rb.num_overflow),
                launches=launches, chunks=chunks)
    frames = []
    for _ in range(SPC_FRAMES):
        t0 = time.perf_counter()
        renderer.render(pipeline, rays)
        torch.cuda.synchronize()
        frames.append((time.perf_counter() - t0) * 1e3)
    info["frame_ms"] = frames
    info["rays_per_s"] = n / (sorted(frames)[len(frames) // 2] / 1e3)
    wall, busy, top, _ = profile_call(lambda: renderer.render(pipeline, rays))
    info.update(profile_frame_ms=wall, device_busy_ms=busy,
                device_idle_share=idle_share(busy, wall), top_device_kernels=top)
    with recording_walks("spc frame"):
        renderer.render(pipeline, rays)

    # -- SPCField's raytrace of one chunk (K10): counts from 0, held to the first hit ------
    sl = slice(SPC_CHECK_CHUNK * SPC_CHUNK, (SPC_CHECK_CHUNK + 1) * SPC_CHUNK)
    chunk = Rays(rays.origins[sl].contiguous(), rays.dirs[sl].contiguous(), rays.dist_min,
                 rays.dist_max)
    kernels.reset_launches()
    rt = nef.grid.raytrace(chunk)
    torch.cuda.synchronize()
    rt_launches = dict(kernels.LAUNCHES)
    require(rt_launches["raytrace"] == 1 and sum(rt_launches.values()) == 1,
            f"SPCField.raytrace launches {rt_launches}")
    info["first_hit_vs_raytrace"] = first_hit_check(rb[sl], rt, blas, chunk)
    rows = spc_kernel_rows(blas, pipeline.tracer, chunk,
                           dict(launches, raytrace=rt_launches["raytrace"]))

    # -- the browser's entry point at its defaults (level 6, 256x256) --------------------
    out_dir = tempfile.mkdtemp(prefix="wisp_spc_")
    try:
        t0 = time.perf_counter()
        main_rb = main_spc_browser.main(out_path=os.path.join(out_dir, "spc.png"))
        torch.cuda.synchronize()
        info["browser_main_s"] = time.perf_counter() - t0
        require(os.path.getsize(os.path.join(out_dir, "spc.png")) > 0, "no browser PNG")
        info["browser_hit_share"] = float(main_rb.hit.float().mean())
        require(0.3 < info["browser_hit_share"] < 0.9,
                f"the browser's frame hit share {info['browser_hit_share']}")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    info["spc_path"] = (f"OfflineRenderer.render of a level-{SPC_LEVEL} SPC of "
                        f"{SPC_SAMPLES} sphere samples, {SPC_SIDE}x{SPC_SIDE} rays in chunks "
                        f"of {SPC_CHUNK}, {SPC_STEPS} walk steps")
    return rows, info


# -- the 'uniform' march (K8) and hashgrid_query (K14) on the flagship ---------------------
FLAGSHIP_CONFIG = "app/nerf/configs/nerf_hash_lego_proxy.yaml"
UNIFORM_STEPS = 20
UNIFORM_OVERRIDES = ("--tracer.raymarch-type", "uniform", "--dataset.num-views", "4",
                     "--trainer.save-every", "-1", "--trainer.render-every", "-1",
                     "--trainer.valid-every", "-1")


def uniform_app(dev, log_dir: str):
    """The flagship yaml with the 'uniform' march through main_nerf's front end (4 views,
    checkpoints, snapshots and validation off)."""
    from wisp_tpu_torch.app.nerf import main_nerf
    cfg = main_nerf.parse_args(["--config", FLAGSHIP_CONFIG, *UNIFORM_OVERRIDES,
                                "--tracker.log-dir", log_dir, "--device", str(dev)])
    require(cfg.tracer.raymarch_type == "uniform" and cfg.grid.num_lods == 16
            and cfg.grid.codebook_bitwidth == 19 and cfg.tracer.num_steps == 512
            and cfg.tracer.march_stride == 2 and cfg.tracer.compaction == 0.25,
            f"the flagship yaml did not parse at full width: {cfg.tracer}, {cfg.grid}")
    return cfg, main_nerf.build(cfg)


def uniform_rows(pipeline, rays, launches) -> list:
    """K8 against its plain version on a render chunk, unjittered and jittered, on the
    trained octree and on the render path's carved field (stride 2), and timed there."""
    import torch
    from wisp_tpu_torch.accelstructs.octree_as import (raymarch_uniform,
                                                       raymarch_uniform_plain, uniform_step)
    tracer, blas = pipeline.tracer, pipeline.nef.grid.blas
    o, d = rays.origins, rays.dirs
    r, s, stride, level = o.shape[0], tracer.num_steps, tracer.march_stride, blas.max_level
    occ = torch.from_numpy(carved_occupancy(level, OCCUPANCY, seed=0)).to(o.device)
    carved = torch.where(occ, 0.0, -1.0).to(torch.float32)
    own = None if blas.dense else blas.cell_density
    gen = torch.Generator(device=o.device).manual_seed(1)
    jitter = torch.rand((r, s), generator=gen, device=o.device)
    for field in (own, carved):
        for u in (None, jitter):
            args = (o, d, rays.dist_min, rays.dist_max, s, stride, field, level, u)
            mk, mp = raymarch_uniform(*args), raymarch_uniform_plain(*args)
            for key in ("samples", "depth_samples", "deltas", "mask"):
                require(torch.equal(getattr(mk, key), getattr(mp, key)),
                        f"raymarch_uniform: {key} differs from the plain version")
            require(field is None or torch.equal(mk.cell_density, mp.cell_density),
                    "raymarch_uniform: cell density differs from the plain version")
    args = (o, d, rays.dist_min, rays.dist_max, s, stride, carved, level)
    mp = raymarch_uniform_plain(*args)
    nc = -(-s // stride)
    row = kernel_row(
        "raymarch_uniform", "wisp_tpu_torch/csrc/raymarch.cu",
        "wisp_tpu/accelstructs/octree_as.py:612", 0.0, 0.0,
        timed(lambda: raymarch_uniform(*args)),
        timed(lambda: raymarch_uniform_plain(*args), iters=5),
        nbytes=r * 24 + field_cells_touched(mp.samples, stride, level) * 4
        + r * s * (12 + 4 + 1 + 4) + r * 4,
        ops=r * s * 12 + r * nc * 2 * 9)
    row["launches"] = launches["raymarch_uniform"]
    row["valid_share_carved"] = float(mp.mask.float().mean())
    vargs = args + (None, uniform_step(s))
    add_launches_and_was(row, lambda: raymarch_uniform(*args),
                         MARCH_GRAD_V1 and (lambda: MARCH_GRAD_V1.march(*vargs)),
                         lambda: march_equal(MARCH_GRAD_V1.march(*vargs), mp),
                         MARCH_GRAD_V1_DESIGN["march"])
    return [row]


QUERY_SMALL = 65_536            # K14's short call: the chunk's first kept samples


def query_equal(got, want) -> bool:
    """K14's contract: the same NaNs, and every other entry equal."""
    import torch
    return (got.shape == want.shape and torch.equal(got.isnan(), want.isnan())
            and torch.equal(got.nan_to_num(0.0), want.nan_to_num(0.0)))


def query_shape(grid, coords, args, plain_iters: int) -> dict:
    """K14 at one shape: held to its plain version exactly and to the earlier design bit
    for bit, then timed beside both and beside index_select of the precomputed rows (the
    plain version by events alone); its bound and the events again after the profiler."""
    import torch
    from wisp_tpu_torch.ops import grid as grid_ops
    table = args[3]
    got = grid_ops.hashgrid_query(coords, *args)
    want = grid_ops.hashgrid_query_plain(coords, *args)
    require(query_equal(got, want), "hashgrid_query differs from the plain version")
    if HASHGRID_QUERY_V1 is not None:
        was = HASHGRID_QUERY_V1.query(coords, *args)
        require(torch.equal(got.view(torch.int32), was.view(torch.int32)),
                f"hashgrid_query differs from the earlier design "
                f"({HASHGRID_QUERY_V1_DESIGN}) at {coords.shape[0]} points")
        del was
    nan_entries = int(got.isnan().sum())
    del got, want
    n, n_lods, f_dim = coords.shape[0], grid.num_lods, grid.feature_dim
    offsets = torch.as_tensor(grid_ops.corner_offsets(3), device=coords.device)
    rows = []
    for i in range(n_lods):
        res = grid.resolutions[i]
        x = torch.clamp((coords + 1.0) / 2.0 * res, 0.0, res - 1 - 1e-5)
        corners = torch.floor(x).to(torch.int64)[:, None, :] + offsets[None]
        rows.append(grid_ops.hash_index(corners, res, grid.codebook_size)
                    + grid.codebook.begin_idxes[i])
    rows = torch.stack(rows, dim=1).reshape(-1)
    distinct = int(torch.unique(rows).numel())

    def run():
        return grid_ops.hashgrid_query(coords, *args)

    ms = timed(run)
    out = {"points": n, "lods": n_lods, "distinct_rows": distinct, "nan_entries": nan_entries,
           "ms": ms[0], "event_ms": ms[1], "event_ms_after_profiler": cuda_ms(run),
           "plain_ms": events_only(lambda: grid_ops.hashgrid_query_plain(coords, *args),
                                   iters=plain_iters, warmup=1)[0],
           "bytes": n * 12 + distinct * f_dim * 4 + n * n_lods * 8 * f_dim * 4,
           "ops": n * n_lods * (3 * 4 + 8 * 6)}
    out["bound_ms"], out["bound_by"] = bound(out["bytes"], out["ops"])
    out["library_ms"], out["library_event_ms"] = timed(lambda: torch.index_select(table, 0,
                                                                                 rows))
    if HASHGRID_QUERY_V1 is not None:
        was_run = functools.partial(HASHGRID_QUERY_V1.query, coords, *args)
        was = timed(was_run)
        out.update(was_ms=was[0], was_event_ms=was[1],
                   was_event_ms_after_profiler=cuda_ms(was_run))
    return out


def query_row(grid, coords) -> tuple:
    """K14 on the flagship codebook at one render chunk's kept samples: counts from 0, one
    call, counts read; then at that shape and at the chunk's first ``QUERY_SMALL`` kept
    samples (``query_shape``: held to the plain version and the earlier design, timed). The
    row is the chunk's; the short call's numbers go under ``small``."""
    import torch
    from wisp_tpu_torch import kernels
    from wisp_tpu_torch.ops import grid as grid_ops
    table = grid.codebook.feats.detach()
    args = (grid.codebook.resolutions, grid.codebook_bitwidth, grid.num_lods - 1, table,
            grid.codebook.begin_idxes, grid.codebook.num_feats)
    kernels.reset_launches()
    grid_ops.hashgrid_query(coords, *args)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    require(launches["hashgrid_query"] == 1 and sum(launches.values()) == 1,
            f"hashgrid_query launches {launches}")
    chunk = query_shape(grid, coords, args, plain_iters=3)
    small = query_shape(grid, coords[:QUERY_SMALL].contiguous(), args, plain_iters=5)
    row = kernel_row(
        "hashgrid_query", "wisp_tpu_torch/csrc/hashgrid.cu", "wisp_tpu/ops/grid.py:369",
        0.0, 0.0, (chunk["ms"], chunk["event_ms"]), (chunk["plain_ms"], chunk["plain_ms"]),
        nbytes=chunk["bytes"], ops=chunk["ops"],
        library_ms=(chunk["library_ms"], chunk["library_event_ms"]))
    row["launches"] = launches["hashgrid_query"]
    row["library_call"] = ("index_select of the precomputed corner rows (over precomputed "
                           "rows: not the same function)")
    row["event_ms_after_profiler"] = chunk["event_ms_after_profiler"]
    if "was_ms" in chunk:
        row.update(was_ms=chunk["was_ms"], was_event_ms=chunk["was_event_ms"],
                   was_event_ms_after_profiler=chunk["was_event_ms_after_profiler"],
                   was_design=HASHGRID_QUERY_V1_DESIGN)
    row["small"] = {k: v for k, v in small.items() if k not in ("bytes", "ops")}
    return row, {"points": chunk["points"], "lods": chunk["lods"],
                 "distinct_rows": chunk["distinct_rows"], "nan_entries": chunk["nan_entries"],
                 "small": row["small"]}


def uniform_phase(dev):
    """The flagship yaml with --tracer.raymarch-type uniform through main_nerf: counts
    from 0, 20 steps and one 512x512 frame, counts read (K8 launched, K2 never); the frame
    and one chunk of it against the plain versions; K8 against its plain version; K14 on
    the trained codebook at the chunk's kept samples."""
    import math
    import shutil
    import tempfile
    import numpy as np
    import torch
    from wisp_tpu_torch import kernels
    from wisp_tpu_torch.core.camera import Camera
    from wisp_tpu_torch.core.rays import Rays
    from wisp_tpu_torch.ops.compaction import compact, compaction_budget
    from wisp_tpu_torch.ops.raygen.raygen import generate_pinhole_rays
    from wisp_tpu_torch.trainers.tracker.offline_renderer import OfflineRenderer
    log_dir = tempfile.mkdtemp(prefix="wisp_uniform_")
    try:
        t0 = time.perf_counter()
        cfg, (pipeline, trainer, _) = uniform_app(dev, log_dir)
        torch.cuda.synchronize()
        info = {"setup_s": time.perf_counter() - t0}
        renderer = OfflineRenderer(render_res=(RES, RES), device=dev)
        tracer = pipeline.tracer

        # -- the path: counts from 0, 20 steps, one frame, counts read right after ---------
        steps = []
        kernels.reset_launches()
        with recording_march_grad("uniform step 20"):
            for i in range(UNIFORM_STEPS):
                rays_n = trainer.train_dataset.transform.num_samples
                t1 = time.perf_counter()
                trainer.iterate()
                torch.cuda.synchronize()
                steps.append({"step": i + 1, "ms": (time.perf_counter() - t1) * 1e3,
                              "rays": rays_n, "loss": trainer.last_loss,
                              "valid_fraction": trainer._prev_num_samples
                              / (rays_n * tracer.num_steps)})
        t1 = time.perf_counter()
        rb = renderer.render_lookat(pipeline, f=EYE)
        torch.cuda.synchronize()
        info["frame_ms"] = (time.perf_counter() - t1) * 1e3
        launches = dict(kernels.LAUNCHES)
        frame_chunks = -(-RES * RES // renderer.render_batch)
        require(launches["raymarch_uniform"] == UNIFORM_STEPS + frame_chunks
                and launches["raymarch_ray"] == 0,
                f"uniform path launches {launches}: K8 must run once a step and a chunk, "
                f"K2 never")
        missing = [k for k in TRAIN_KERNELS if k != "raymarch_ray" and launches[k] <= 0]
        require(not missing, f"kernels not launched on the uniform path: {missing}")
        losses = [st["loss"] for st in steps]
        require(all(math.isfinite(x) for x in losses), f"non-finite uniform loss: {losses}")
        first, late = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
        require(late < first, f"the uniform loss did not fall: {first} -> {late}")
        rgb, alpha = rb.rgb, rb.alpha
        require(tuple(rgb.shape) == (RES, RES, 3)
                and all(bool(torch.isfinite(t).all()) for t in (rgb, alpha, rb.depth)),
                "bad uniform frame")
        steady = sorted(st["ms"] for st in steps[1:])
        info.update(step_ms_median=steady[len(steady) // 2], loss_steps_1_5=first,
                    loss_steps_16_20=late, steps=steps, launches=launches,
                    hit_share=float(rb.hit.float().mean()),
                    valid_sample_fraction=float(rb.num_valid_samples)
                    / (RES * RES * tracer.num_steps))

        # -- one chunk of the frame against the plain versions ----------------------------
        cam = Camera.from_args(eye=EYE, at=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0), width=RES,
                               height=RES, fov=np.radians(30.0), near=0.0, far=10.0)
        all_rays = generate_pinhole_rays(cam, device=dev)
        n_chunk = renderer.render_batch
        sl = slice(CHUNK_INDEX * n_chunk, (CHUNK_INDEX + 1) * n_chunk)
        chunk = Rays(all_rays.origins[sl].contiguous(), all_rays.dirs[sl].contiguous(),
                     all_rays.dist_min, all_rays.dist_max)
        with torch.no_grad():
            with recording_k1("uniform chunk"), recording_march_grad("uniform chunk"):
                a = pipeline(rays=chunk)
            with plain_versions():
                b = pipeline(rays=chunk)
        chunk_err = {k: float((a.channels[k] - b.channels[k]).abs().max())
                     for k in ("rgb", "alpha", "depth")}
        require(all(e <= 1e-3 for e in chunk_err.values())
                and float(a.num_valid_samples) == float(b.num_valid_samples),
                f"uniform chunk differs from the plain versions: {chunk_err}")
        info["chunk_max_abs_err_vs_plain"] = chunk_err
        rows = uniform_rows(pipeline, chunk, launches)

        # -- K14 on the trained codebook at the chunk's kept samples -----------------------
        with torch.no_grad():
            mr = pipeline.nef.grid.raymarch(chunk, raymarch_type="uniform",
                                            num_samples=tracer.num_steps,
                                            stride=tracer.march_stride)
            budget = compaction_budget(n_chunk, tracer.num_steps, tracer.compaction)
            _, cflat, _, count = compact(mr.mask, mr.samples, chunk.dirs, budget)
        kept = min(int(count), budget)
        row, info["hashgrid_query_shapes"] = query_row(pipeline.nef.grid,
                                                       cflat[:kept].contiguous())
        rows.append(row)
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    info["uniform_path"] = (f"main_nerf parse_args/build of {FLAGSHIP_CONFIG} with "
                            f"--tracer.raymarch-type uniform: {UNIFORM_STEPS} steps, one "
                            f"{RES}x{RES} frame; hashgrid_query on one chunk's kept samples")
    return rows, info


# -- slice 10: the triplanar and the VQAD codebook NeRFs through main_nerf ---------------------
TRIPLANAR_CONFIG = "app/nerf/configs/nerf_triplanar_lego_proxy.yaml"
CODEBOOK_CONFIG = "app/nerf/configs/nerf_codebook_lego_proxy.yaml"
# the depth cut of both: the octree phase's (4 views, 25 steps, no snapshots or checkpoints;
# validation once below on a small split)
NEW_GRID_STEPS = 25
NEW_GRID_PROFILED_STEP = 20
TRIPLANAR_STEP_KERNELS = {"raymarch_ray": 1, "compact": 1, "triplane_fwd": 1,
                          "triplane_bwd": 1, "scatter_back": 2, "scatter_back_bwd": 1,
                          "integrate_fwd": 1, "integrate_bwd": 1}
TRIPLANAR_FRAME_KERNELS = {"raymarch_ray": 1, "compact": 1, "triplane_fwd": 1,
                           "scatter_back": 2, "integrate_fwd": 1}
CODEBOOK_STEP_KERNELS = {"raymarch_voxel": 1, "compact": 1, "codebook_resolve": 1,
                         "octree_query_interp": 1, "octree_interp_bwd": 1,
                         "codebook_bwd": 1, "scatter_back": 2, "scatter_back_bwd": 1,
                         "integrate_fwd": 1, "integrate_bwd": 1}
# a frame's chunk resolves the codebook whether or not it keeps a sample; the field's
# kernels with points (the fused query, K18) run only on chunks that keep one
CODEBOOK_FRAME_KERNELS = {"raymarch_voxel": 1, "compact": 1, "codebook_resolve": 1,
                          "octree_query_interp": 1, "scatter_back": 2, "integrate_fwd": 1}
FIELD_POINT_KERNELS = ("triplane_fwd", "octree_query_interp")
# the recorded K18 and K19 calls of each phase's last step: (phase, kernel) -> inputs
NEW_GRID_CALLS = {}


@contextmanager
def recording_new_grid_calls(phase: str):
    """Keep (cloned) the inputs of the K18 and K19 calls made inside, by phase."""
    from wisp_tpu_torch.ops import codebook, triplane
    fwd, bwd = triplane._sample_fwd, triplane.triplane_sample_bwd
    resolve, resolve_bwd = codebook._resolve, codebook.codebook_resolve_bwd

    def rec_fwd(coords, flat_planes, multiscale_type, out_lods):
        NEW_GRID_CALLS[phase, "triplane_fwd"] = (
            coords.clone(), [p.detach().clone() for p in flat_planes], multiscale_type,
            out_lods)
        return fwd(coords, flat_planes, multiscale_type, out_lods)

    def rec_bwd(coords, shapes, multiscale_type, grad_out):
        NEW_GRID_CALLS[phase, "triplane_bwd"] = (coords.clone(), list(shapes),
                                                 multiscale_type, grad_out.clone())
        return bwd(coords, shapes, multiscale_type, grad_out)

    def rec_resolve(logits, dictionaries, mode, buffer):
        NEW_GRID_CALLS[phase, "codebook_resolve"] = (
            [t.detach().clone() for t in logits], [t.detach().clone() for t in dictionaries],
            mode)
        return resolve(logits, dictionaries, mode, buffer)

    def rec_resolve_bwd(logits, dictionaries, arg, mode, grad_e):
        NEW_GRID_CALLS[phase, "codebook_bwd"] = (
            [t.detach().clone() for t in logits], [t.detach().clone() for t in dictionaries],
            arg.clone(), mode, [g.clone() for g in grad_e])
        return resolve_bwd(logits, dictionaries, arg, mode, grad_e)

    with mock.patch.object(triplane, "_sample_fwd", rec_fwd), \
            mock.patch.object(triplane, "triplane_sample_bwd", rec_bwd), \
            mock.patch.object(codebook, "_resolve", rec_resolve), \
            mock.patch.object(codebook, "codebook_resolve_bwd", rec_resolve_bwd):
        yield


def codebook_resolve_plain_all(logits, dictionaries, mode="train", buffer=None):
    """``codebook_resolve`` by its plain version a LOD (the chunk check's route)."""
    import torch
    from wisp_tpu_torch.ops.codebook import codebook_resolve_plain
    outs = [codebook_resolve_plain(lg, d, mode) for lg, d in zip(logits, dictionaries)]
    return [o[0] for o in outs], torch.cat([o[1] for o in outs])


def triplane_rows(coords, planes) -> list:
    """Distinct rows of each plane (fmx, fmy, fmz a LOD) that K18's corners at ``coords``
    touch: its data-dependent reads (forward) or the rows its adds reach (backward)."""
    import torch
    from wisp_tpu_torch.ops.triplane import reflect
    x, y, z = (reflect(coords[:, i]) for i in range(3))
    out = []
    for lod in planes:
        w = lod[0].shape[0]
        for u, v in ((y, z), (x, z), (x, y)):
            cu = ((u + 1.0) * 0.5 * (w - 1)).floor().long().clamp(0, w - 1)
            cv = ((v + 1.0) * 0.5 * (w - 1)).floor().long().clamp(0, w - 1)
            rows = torch.cat([cv * w + cu, cv * w + (cu + 1).clamp(max=w - 1),
                              (cv + 1).clamp(max=w - 1) * w + cu,
                              (cv + 1).clamp(max=w - 1) * w + (cu + 1).clamp(max=w - 1)])
            out.append(int(torch.unique(rows).numel()))
    return out


def triplane_rows_and_checks(phase: str, launches: dict) -> list:
    """K18 forward and backward against their plain versions at the phase's recorded
    calls (the last training step's), timed, with their bounds."""
    import torch
    from wisp_tpu_torch.ops import triplane
    coords, flat, multiscale, out_lods = NEW_GRID_CALLS[phase, "triplane_fwd"]
    planes = [tuple(flat[3 * i:3 * i + 3]) for i in range(len(flat) // 3)]
    n, f_dim, lods = coords.shape[0], flat[0].shape[2], len(planes)
    got = triplane._sample_fwd(coords, flat, multiscale, out_lods)
    want = triplane.triplane_sample_plain(coords, planes, multiscale, out_lods)
    fwd_err = float((got - want).abs().max())
    rows = triplane_rows(coords, planes)
    width = got.shape[1]
    ops_point = 3 * lods * (40 + 11 * f_dim) + (3 * f_dim * (lods - 1) if multiscale == "sum"
                                                else 0)
    fwd = kernel_row("triplane_fwd", "wisp_tpu_torch/csrc/triplane.cu",
                     "wisp_tpu/models/grids/triplanar_grid.py:29", fwd_err, 1e-6,
                     timed(lambda: triplane._sample_fwd(coords, flat, multiscale, out_lods)),
                     timed(lambda: triplane.triplane_sample_plain(coords, planes, multiscale,
                                                                  out_lods), iters=5),
                     nbytes=n * 12 + n * width * 4 + sum(rows) * f_dim * 4,
                     ops=n * ops_point)
    bcoords, shapes, bmulti, grad_out = NEW_GRID_CALLS[phase, "triplane_bwd"]
    gk = triplane.triplane_sample_bwd(bcoords, shapes, bmulti, grad_out)
    gp = triplane.triplane_sample_bwd_plain(bcoords, shapes, bmulti, grad_out)
    scale = max(float(g.abs().max()) for g in gp)
    bwd_err = max(float((a - b).abs().max()) for a, b in zip(gk, gp))
    nb = bcoords.shape[0]
    table_bytes = sum(a * b * c for a, b, c in shapes) * 4
    bwd = kernel_row("triplane_bwd", "wisp_tpu_torch/csrc/triplane.cu",
                     "wisp_tpu/ops/grid.py:55", bwd_err, 1e-5 * scale,
                     timed(lambda: triplane.triplane_sample_bwd(bcoords, shapes, bmulti,
                                                                grad_out)),
                     timed(lambda: triplane.triplane_sample_bwd_plain(bcoords, shapes, bmulti,
                                                                      grad_out), iters=3),
                     nbytes=nb * 12 + grad_out.numel() * 4 + table_bytes,
                     ops=nb * len(shapes) * (40 + 12 * f_dim))
    fwd.update(shape=f"{phase} step {NEW_GRID_STEPS}: {n} samples, {lods} LODs, F = {f_dim}, "
                     f"{multiscale}", launches=launches["triplane_fwd"], rows_touched=rows)
    bwd.update(shape=f"{phase} step {NEW_GRID_STEPS}: {nb} samples",
               launches=launches["triplane_bwd"],
               adds_16_bytes=nb * len(shapes) * 4 * max(1, f_dim // 4),
               hottest_rows=[a * b for a, b, _ in shapes[:3]])
    return [fwd, bwd]


def codebook_ties(logits, mode) -> list:
    """A bool [V_l] a LOD: the vertices whose two largest values (softmax in training, the
    logits in eval) lie within an ulp of each other, where two orders of summation may pick
    two indices."""
    import torch
    from wisp_tpu_torch.ops.codebook import softmax_plain
    out = []
    for lg in logits:
        if mode == "baked" or lg.shape[0] == 0:
            out.append(torch.zeros(lg.shape[0], dtype=torch.bool, device=lg.device))
            continue
        v = softmax_plain(lg) if mode == "train" else lg
        top = torch.topk(v, 2, dim=-1).values
        ulp = torch.nextafter(top[:, 0], torch.full_like(top[:, 0], float("inf"))) - top[:, 0]
        out.append(top[:, 0] - top[:, 1] <= ulp)
    return out


def codebook_rows_and_checks(phase: str, launches: dict) -> list:
    """K19's resolve and backward against their plain versions at the phase's recorded
    calls (the last training step's), timed, with their bounds; the near-tie vertices are
    counted and left out of the equality of a."""
    import torch
    from wisp_tpu_torch.ops import codebook
    logits, dicts, mode = NEW_GRID_CALLS[phase, "codebook_resolve"]
    rows = [lg.shape[0] for lg in logits]
    k, f_dim = dicts[0].shape
    buffer = codebook.resolve_buffer(rows, f_dim, None, dicts[0].device)
    tables, arg = codebook._resolve(logits, dicts, mode, buffer)
    ties = codebook_ties(logits, mode)
    err, start, differ = 0.0, 0, 0
    for lg, d, e, tie in zip(logits, dicts, tables, ties):
        want, want_arg = codebook.codebook_resolve_plain(lg, d, mode)
        a = arg[start:start + lg.shape[0]]
        start += lg.shape[0]
        keep = ~tie
        differ += int((a[keep] != want_arg[keep]).sum())
        if bool(keep.any()):
            err = max(err, float((e[keep] - want[keep]).abs().max()))
    require(differ == 0, f"codebook_resolve: {differ} indices differ off the near ties")
    n_ties = sum(int(t.sum()) for t in ties)
    v = sum(rows)
    res = kernel_row("codebook_resolve", "wisp_tpu_torch/csrc/codebook.cu",
                     "wisp_tpu/models/grids/codebook_grid.py:71", err, 1e-6,
                     timed(lambda: codebook._resolve(logits, dicts, mode, buffer)),
                     timed(lambda: codebook_resolve_plain_all(logits, dicts, mode), iters=5),
                     nbytes=v * (k * 4 + f_dim * 4 + 4) + len(rows) * k * f_dim * 4,
                     ops=v * (5 * k + f_dim + 3))
    res.update(shape=f"{phase} step {NEW_GRID_STEPS}: {v} vertices {rows}, 2^bw = {k}, "
                     f"F = {f_dim}, {mode}", launches=launches["codebook_resolve"],
               near_ties=n_ties)
    blogits, bdicts, barg, bmode, grad_e = NEW_GRID_CALLS[phase, "codebook_bwd"]
    dl_k, dd_k = codebook.codebook_resolve_bwd(blogits, bdicts, barg, bmode, grad_e)
    dl_p, dd_p, start = [], [], 0
    for lg, d, g in zip(blogits, bdicts, grad_e):
        a = barg[start:start + lg.shape[0]]
        start += lg.shape[0]
        p = codebook.codebook_resolve_bwd_plain(lg, d, a, bmode, g)
        dl_p.append(p[0])
        dd_p.append(p[1])
    scale_l = max(float(t.abs().max()) for t in dl_p)
    scale_d = max(float(t.abs().max()) for t in dd_p)
    err_l = max(float((a - b).abs().max()) for a, b in zip(dl_k, dl_p))
    err_d = max(float((a - b).abs().max()) for a, b in zip(dd_k, dd_p))
    require(err_d <= 1e-5 * scale_d, f"codebook_bwd: d dictionary error {err_d} above "
                                     f"{1e-5 * scale_d}")

    def plain_bwd():
        start = 0
        for lg, d, g in zip(blogits, bdicts, grad_e):
            codebook.codebook_resolve_bwd_plain(lg, d, barg[start:start + lg.shape[0]],
                                                bmode, g)
            start += lg.shape[0]

    bwd = kernel_row("codebook_bwd", "wisp_tpu_torch/csrc/codebook.cu",
                     "wisp_tpu/models/grids/codebook_grid.py:84", err_l, 1e-5 * scale_l,
                     timed(lambda: codebook.codebook_resolve_bwd(blogits, bdicts, barg, bmode,
                                                                 grad_e)),
                     timed(plain_bwd, iters=5),
                     nbytes=v * (k * 8 + f_dim * 4 + 4) + 2 * len(rows) * k * f_dim * 4,
                     ops=v * (k * (6 + 2 * f_dim) + 2 * f_dim))
    bwd.update(shape=f"{phase} step {NEW_GRID_STEPS}: {v} vertices, {bmode}",
               launches=launches["codebook_bwd"], d_dictionary_err=err_d,
               d_dictionary_tol=1e-5 * scale_d,
               shared_sums=int(len(rows) * k * f_dim * 4 <= codebook.BWD_SHARED_BYTES))
    return [res, bwd]


def new_grid_phase(dev, phase: str, config: str, step_kernels: dict, frame_kernels: dict):
    """A shipped yaml through main_nerf at full width: parse and build, counts from 0,
    ``NEW_GRID_STEPS`` steps (one profiled, the last recorded), counts read; validate() on a
    small split; a warm-up frame, counts from 0, one 512x512 frame, counts read; the frame's
    checks and one chunk against the plain versions; the phase's new kernels held to their
    plain versions at the last step's calls and timed."""
    import math
    import numpy as np
    import torch
    from wisp_tpu_torch import kernels
    from wisp_tpu_torch.app.nerf import main_nerf
    from wisp_tpu_torch.core.camera import Camera
    from wisp_tpu_torch.core.rays import Rays
    from wisp_tpu_torch.datasets.random_view_dataset import RandomViewDataset
    from wisp_tpu_torch.models.grids import codebook_grid, triplanar_grid
    from wisp_tpu_torch.ops.raygen.raygen import generate_pinhole_rays
    from wisp_tpu_torch.ops.triplane import triplane_sample_plain
    t0 = time.perf_counter()
    cfg = main_nerf.parse_args(["--config", config, *OCTREE_OVERRIDES, "--device", str(dev)])
    pipeline, trainer, renderer = main_nerf.build(cfg)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    grid, tracer = pipeline.nef.grid, pipeline.tracer
    stats = {"grid": type(grid).__name__, "active_lods": list(grid.active_lods),
             "feature_dim": grid.feature_dim, "blas_level": grid.blas.max_level,
             "blas_dense": grid.blas.dense,
             "table_shapes": [list(p.shape) for name, p in grid.named_parameters()],
             "parameters_mb": sum(p.numel() * 4 for p in grid.parameters()) / 1e6}
    print(json.dumps({f"{phase}_nerf": stats, "setup_s": setup_s}), flush=True)

    # -- training: counts from 0, the steps, counts read right after ----------------------
    steps = []
    kernels.reset_launches()
    for i in range(NEW_GRID_STEPS):
        rays = trainer.train_dataset.transform.num_samples
        budget = tracer.compaction
        if i == NEW_GRID_PROFILED_STEP - 1:
            profiled = profile_step(trainer)
            ms = profiled["profile_step_ms"]
        else:
            t1 = time.perf_counter()
            if i == NEW_GRID_STEPS - 1:
                with recording_new_grid_calls(phase):
                    trainer.iterate()
            else:
                trainer.iterate()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t1) * 1e3
        steps.append({"step": i + 1, "ms": ms, "rays": rays, "budget": budget,
                      "valid": trainer._prev_num_samples, "loss": trainer.last_loss})
    train_launches = dict(kernels.LAUNCHES)
    want = {k: v * NEW_GRID_STEPS for k, v in step_kernels.items()}
    got = {k: train_launches[k] for k in want}
    require(got == want, f"{phase} training launches {got}, expected {want}")
    others = {k: v for k, v in train_launches.items() if k not in want and v}
    require(not others, f"{phase} training launched other kernels: {others}")
    losses = [st["loss"] for st in steps]
    require(all(math.isfinite(x) for x in losses), f"non-finite {phase} loss: {losses}")
    first, late = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    require(late < first, f"the {phase} loss did not fall: {first} -> {late}")

    # -- validate() on a small split ------------------------------------------------------
    t1 = time.perf_counter()
    trainer.validation_dataset = RandomViewDataset(
        num_views=OCTREE_VALID_VIEWS, height=OCTREE_VALID_RES, width=OCTREE_VALID_RES,
        split="test", scene="lego_proxy", device=dev)
    metrics = trainer.validate()
    torch.cuda.synchronize()
    validate_s = time.perf_counter() - t1
    require(math.isfinite(metrics["psnr"]), f"bad {phase} validation PSNR {metrics}")

    # -- the frame: counts from 0, one 512x512 frame, counts read right after -------------
    renderer.render_lookat(pipeline, f=EYE)          # warm-up
    torch.cuda.synchronize()
    chunk_valid = []
    trace = tracer.trace

    @functools.wraps(trace)
    def recording_trace(*args, **kwargs):
        rb_ = trace(*args, **kwargs)
        chunk_valid.append(tracer.prev_num_samples)
        return rb_

    tracer.trace = recording_trace
    kernels.reset_launches()
    t1 = time.perf_counter()
    rb = renderer.render_lookat(pipeline, f=EYE)
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t1) * 1e3
    frame_launches = dict(kernels.LAUNCHES)
    del tracer.trace
    chunks = len(chunk_valid)
    field_chunks = sum(1 for v in chunk_valid if v > 0)
    want = {k: v * (field_chunks if k in FIELD_POINT_KERNELS else chunks)
            for k, v in frame_kernels.items()}
    got = {k: frame_launches[k] for k in want}
    require(got == want, f"{phase} frame launches {got}, expected {want}")
    others = {k: v for k, v in frame_launches.items() if k not in want and v}
    require(not others, f"the {phase} frame launched other kernels: {others}")
    rgb, alpha = rb.rgb, rb.alpha
    require(tuple(rgb.shape) == (RES, RES, 3) and tuple(alpha.shape) == (RES, RES, 1),
            f"bad {phase} frame shapes {rb}")
    finite = all(bool(torch.isfinite(t).all()) for t in (rgb, alpha, rb.depth))
    require(finite, f"non-finite {phase} frame")
    require(float(alpha.min()) >= 0.0 and float(alpha.max()) <= 1.0 + 1e-5,
            f"{phase} alpha outside [0, 1]")
    hit_frac = float(rb.hit.float().mean())
    # the triplanar field fills the box, which covers the whole view: every ray may hit
    require(0.0 < hit_frac <= 1.0, f"{phase} hit fraction {hit_frac}")

    # -- one chunk against the plain versions ---------------------------------------------
    cam = Camera.from_args(eye=EYE, at=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0), width=RES,
                           height=RES, fov=np.radians(30.0), near=0.0, far=10.0)
    all_rays = generate_pinhole_rays(cam, device=dev)
    n_chunk = renderer.render_batch
    sl = slice(CHUNK_INDEX * n_chunk, (CHUNK_INDEX + 1) * n_chunk)
    chunk = Rays(all_rays.origins[sl].contiguous(), all_rays.dirs[sl].contiguous(),
                 all_rays.dist_min, all_rays.dist_max)
    with torch.no_grad():
        a = pipeline(rays=chunk)
        before = dict(kernels.LAUNCHES)
        with plain_versions(), \
                mock.patch.object(triplanar_grid, "triplane_sample", triplane_sample_plain), \
                mock.patch.object(codebook_grid, "codebook_resolve",
                                  codebook_resolve_plain_all):
            b = pipeline(rays=chunk)
        require(dict(kernels.LAUNCHES) == before, "a plain-version trace launched a kernel")
    chunk_err = {k: float((a.channels[k] - b.channels[k]).abs().max())
                 for k in ("rgb", "alpha", "depth")}
    require(all(e <= 1e-3 for e in chunk_err.values()),
            f"{phase} chunk differs from the plain versions: {chunk_err}")
    require(float(a.num_valid_samples) == float(b.num_valid_samples) > 0,
            f"{phase} chunk valid-sample counts differ or are 0")
    require(float((rgb.reshape(-1, 3)[sl] - a.rgb).abs().max()) <= 1e-6,
            f"{phase} chunk re-trace differs from the frame")

    with torch.no_grad():
        if phase == "triplanar":
            rows = triplane_rows_and_checks(phase, train_launches)
        else:
            rows = codebook_rows_and_checks(phase, train_launches)
    for row_ in rows:
        row_["frame_launches"] = frame_launches[row_["name"]]
    steady = sorted(st["ms"] for st in steps[1:NEW_GRID_STEPS - 1]
                    if st["step"] != NEW_GRID_PROFILED_STEP)
    info = {
        f"{phase}_path": f"main_nerf.parse_args + build ({os.path.basename(config)}, 4 views), "
                         f"MultiviewTrainer.iterate x {NEW_GRID_STEPS}, validate(), "
                         f"render_lookat {RES}x{RES}",
        "setup_s": setup_s, "grid": stats, "step_ms_median": steady[len(steady) // 2],
        "loss_steps_1_5": first, "loss_steps_21_25": late,
        "rays_per_step": [st["rays"] for st in steps],
        "budget_per_step": [st["budget"] for st in steps],
        "valid_per_step": [st["valid"] for st in steps],
        "steps_ms": [st["ms"] for st in steps], "train_launches": train_launches,
        "validate": {"views": OCTREE_VALID_VIEWS, "res": OCTREE_VALID_RES,
                     "psnr": metrics["psnr"], "s": validate_s},
        "frame_ms": frame_ms, "frame_launches": frame_launches, "hit_fraction": hit_frac,
        "frame_chunk_valid": chunk_valid,
        "chunk_max_abs_err_vs_plain": chunk_err, "chunk_tol": 1e-3,
    }
    info.update(profiled)
    info.update({f"frame_{k}": v for k, v in profile_frame(renderer, pipeline).items()})
    return rows, info


def run() -> dict:
    import torch
    try:
        from wisp_tpu_torch import kernels
    except ImportError as e:
        raise SmokeFailure(f"wisp_tpu_torch not importable ({e}); run from the root of "
                           f"a checkout")
    smi = nvidia_smi_line()
    print(f"device: {smi} | torch {torch.__version__} | CUDA {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    threepass_build = start_baseline_build(THREEPASS_SRC, "libwisp_threepass.so")
    hashgrid_v1_build = start_baseline_build(HASHGRID_V1_SRC, "libwisp_hashgrid_v1.so")
    hashgrid_query_v1_build = start_baseline_build(HASHGRID_QUERY_V1_SRC,
                                                   "libwisp_hashgrid_query_v1.so")
    octree_grid_v1_build = start_baseline_build(OCTREE_GRID_V1_SRC,
                                                "libwisp_octree_grid_v1.so")
    free_space_v1_build = start_baseline_build(FREE_SPACE_V1_SRC, "libwisp_free_space_v1.so")
    raymarch_v1_build = start_baseline_build(RAYMARCH_V1_SRC, "libwisp_raymarch_v1.so")
    octree_grid_bwd_v1_build = start_baseline_build(OCTREE_GRID_BWD_V1_SRC,
                                                    "libwisp_octree_grid_bwd_v1.so")
    mesh_v1_build = start_baseline_build(MESH_V1_SRC, "libwisp_mesh_sdf_v1.so")
    sphere_trace_v1_build = start_baseline_build(SPHERE_TRACE_V1_SRC,
                                                 "libwisp_sphere_trace_v1.so")
    walk_probe_build = start_walk_probe_build()
    scatter_rows_v1_build = start_baseline_build(SCATTER_ROWS_V1_SRC,
                                                 "libwisp_scatter_rows_v1.so")
    integrate_seg_v1_build = start_baseline_build(INTEGRATE_SEG_V1_SRC,
                                                  "libwisp_integrate_seg_v1.so")
    scatter_max_v1_build = start_baseline_build(SCATTER_MAX_V1_SRC,
                                                "libwisp_scatter_max_v1.so")
    scatter_back_bwd_v1_build = start_baseline_build(SCATTER_BACK_BWD_V1_SRC,
                                                     "libwisp_scatter_back_bwd_v1.so")
    kernels.build(verbose=True)
    global THREEPASS, HASHGRID_V1, HASHGRID_QUERY_V1, OCTREE_V1, MARCH_GRAD_V1, MESH_V1, \
        SPHERE_TRACE_V1, WALK_PROBE, SCATTER_SEG_V1, FEEDBACK_GATHER_V1
    THREEPASS = ThreePass(threepass_build)
    HASHGRID_V1 = HashGridV1(hashgrid_v1_build)
    HASHGRID_QUERY_V1 = HashGridQueryV1(hashgrid_query_v1_build)
    OCTREE_V1 = OctreeV1(octree_grid_v1_build, free_space_v1_build)
    MARCH_GRAD_V1 = MarchGradV1(raymarch_v1_build, octree_grid_bwd_v1_build)
    MESH_V1 = MeshV1(mesh_v1_build)
    SPHERE_TRACE_V1 = WalkDesign(finish_baseline_build(sphere_trace_v1_build,
                                                       SPHERE_TRACE_V1_SRC), "_v1")
    WALK_PROBE = WalkDesign(finish_baseline_build(walk_probe_build, "the walk probe"), "")
    SCATTER_SEG_V1 = ScatterSegV1(scatter_rows_v1_build, integrate_seg_v1_build)
    FEEDBACK_GATHER_V1 = FeedbackGatherV1(scatter_max_v1_build, scatter_back_bwd_v1_build)
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in str(kernels.BUILD_INFO.get("log", "")).splitlines()
             if "registers" in ln or "spill" in ln and "0 bytes spill" not in ln]
    print(json.dumps({"build_s": build_s, "ptxas": ptxas[:60]}), flush=True)
    kernels.library()

    dev = torch.device("cuda")
    with recording_compactions():
        phases = run_phases(dev, build_s)
    t0 = time.perf_counter()
    compaction_info = compaction_phase()
    phases["phase_s"]["compaction"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    hashgrid_info = hashgrid_phase()
    phases["phase_s"]["hashgrid"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    octree_grid_info = octree_grid_phase()
    phases["phase_s"]["octree grid"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    march_grad_info = march_grad_phase()
    phases["phase_s"]["march and octree grad"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh_info = mesh_phase(dev)
    phases["phase_s"]["mesh"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    query_step_info = query_step_phase()
    phases["phase_s"]["query and step folded"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    walk_info = walk_phase(dev)
    phases["phase_s"]["walks"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    scatter_seg_info = scatter_seg_phase()
    phases["phase_s"]["scatter and segment"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    feedback_gather_info = feedback_gather_phase()
    phases["phase_s"]["feedback and gather"] = time.perf_counter() - t0
    print(json.dumps({"kernels": phases["kernels"]}), flush=True)
    for line in phases["lines"]:
        print(json.dumps(line), flush=True)
    print(json.dumps({"compaction_shapes": compaction_info}), flush=True)
    print(json.dumps({"hashgrid_shapes": hashgrid_info}), flush=True)
    print(json.dumps({"octree_grid_shapes": octree_grid_info}), flush=True)
    print(json.dumps({"march_grad_shapes": march_grad_info}), flush=True)
    print(json.dumps({"mesh_shapes": mesh_info}), flush=True)
    print(json.dumps({"query_step_shapes": query_step_info}), flush=True)
    print(json.dumps({"walk_shapes": walk_info}), flush=True)
    print(json.dumps({"scatter_seg_shapes": scatter_seg_info}), flush=True)
    print(json.dumps({"feedback_gather_shapes": feedback_gather_info}), flush=True)
    print(json.dumps({"phase_s": phases["phase_s"], "profiler_shortfalls": PROFILER_SHORTFALLS,
                      "profiler_fallbacks": PROFILER_FALLBACKS}), flush=True)
    print(smi, flush=True)
    return {"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                   "count": torch.cuda.device_count()}}


def run_phases(dev, build_s: float) -> dict:
    """The twelve paths in order; their kernel rows, JSON lines and seconds."""
    import numpy as np
    import torch
    from wisp_tpu_torch import kernels
    from wisp_tpu_torch.core.rays import Rays
    from wisp_tpu_torch.ops.compaction import compaction_budget
    from wisp_tpu_torch.trainers.tracker.offline_renderer import OfflineRenderer
    COMPACTION_PHASE[0] = "render"
    t_render = time.perf_counter()
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
        with recording_k1("render chunk"), recording_march_grad("render chunk"):
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
    phase_s = {"build": build_s, "render": time.perf_counter() - t_render}
    COMPACTION_PHASE[0] = "train"
    t0 = time.perf_counter()
    train_rows, train_info = train_phase(dev)
    torch.cuda.empty_cache()
    phase_s["train"] = time.perf_counter() - t0
    COMPACTION_PHASE[0] = "sdf render"
    t0 = time.perf_counter()
    sdf_rows, sdf_info = sdf_phase(dev)
    torch.cuda.empty_cache()
    phase_s["sdf render"] = time.perf_counter() - t0
    COMPACTION_PHASE[0] = "sdf train"
    t0 = time.perf_counter()
    sdf_train_rows, sdf_train_info = sdf_train_phase(dev)
    torch.cuda.empty_cache()
    phase_s["sdf train"] = time.perf_counter() - t0
    # K15's forward runs on no path (the fused query is its forward)
    for row_ in sdf_rows:
        if row_["name"] == "octree_interp":
            row_["launches_from"] = ("none: OctreeGrid.interpolate takes octree_query_interp "
                                     "on every path")
    COMPACTION_PHASE[0] = "octree nerf"
    t0 = time.perf_counter()
    octree_rows, octree_info = octree_phase(dev)
    torch.cuda.empty_cache()
    phase_s["octree nerf"] = time.perf_counter() - t0
    COMPACTION_PHASE[0] = "stoch"
    t0 = time.perf_counter()
    stoch_rows, stoch_info = stoch_phase(dev)
    torch.cuda.empty_cache()
    phase_s["stoch"] = time.perf_counter() - t0
    COMPACTION_PHASE[0] = "seg"
    t0 = time.perf_counter()
    seg_rows, seg_info = seg_phase(dev)
    torch.cuda.empty_cache()
    phase_s["seg"] = time.perf_counter() - t0
    COMPACTION_PHASE[0] = "nglod app"
    t0 = time.perf_counter()
    nglod_rows, nglod_info = nglod_phase(dev)
    torch.cuda.empty_cache()
    phase_s["nglod app"] = time.perf_counter() - t0
    COMPACTION_PHASE[0] = "spc browser"
    t0 = time.perf_counter()
    spc_rows_, spc_info = spc_phase(dev)
    torch.cuda.empty_cache()
    phase_s["spc browser"] = time.perf_counter() - t0
    COMPACTION_PHASE[0] = "uniform"
    t0 = time.perf_counter()
    uniform_rows_, uniform_info = uniform_phase(dev)
    torch.cuda.empty_cache()
    phase_s["uniform"] = time.perf_counter() - t0
    COMPACTION_PHASE[0] = "triplanar"
    t0 = time.perf_counter()
    triplanar_rows, triplanar_info = new_grid_phase(
        dev, "triplanar", TRIPLANAR_CONFIG, TRIPLANAR_STEP_KERNELS, TRIPLANAR_FRAME_KERNELS)
    torch.cuda.empty_cache()
    phase_s["triplanar"] = time.perf_counter() - t0
    COMPACTION_PHASE[0] = "codebook"
    t0 = time.perf_counter()
    codebook_rows, codebook_info = new_grid_phase(
        dev, "codebook", CODEBOOK_CONFIG, CODEBOOK_STEP_KERNELS, CODEBOOK_FRAME_KERNELS)
    phase_s["codebook"] = time.perf_counter() - t0
    return {"kernels": rows + train_rows + sdf_rows + sdf_train_rows + octree_rows[:1]
            + stoch_rows + seg_rows + nglod_rows + spc_rows_ + uniform_rows_
            + triplanar_rows + codebook_rows,
            "lines": [main, train_info, sdf_info, sdf_train_info,
                      {"octree_nerf_path": octree_info, "raymarch_voxel_rows": octree_rows},
                      stoch_info, seg_info, nglod_info, spc_info, uniform_info,
                      triplanar_info, codebook_info],
            "phase_s": phase_s}


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
