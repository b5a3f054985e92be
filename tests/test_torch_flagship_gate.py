"""Gate 2: the flagship hash-grid NeRF trained from its shipped yaml on the GPU (markers
``slow`` and ``cuda``; tier-1 leaves it out and it skips without a card). It imports neither
jax nor the JAX package, so it runs on a machine without JAX:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_flagship_gate.py -q -s``.

Each case runs ``wisp_tpu_torch.app.nerf.main_nerf.main`` (what ``python -m
wisp_tpu_torch.app.nerf.main_nerf`` calls) on app/nerf/configs/nerf_hash_lego_proxy.yaml as
shipped: 100 views of 512x512, 100 epochs of 100 steps, validation on the 7-view test split
every 25 epochs, a prune every 100 iterations, a save and a snapshot at epoch 100. Only the
log dir is moved to a temporary directory.

* **A**: as shipped.
* **B**: as shipped plus ``--tracer.seg-early-stop 1e-3 --tracer.seg-count 4``, the
  segmented true-transmittance cull (K6) in training, validation and snapshots.

The reference is JAX's converged run of the same yaml (docs/pages/results_round5.md:103,
``r5-flagship-noes``, a TPU run: only its PSNR is used): 28.15 / 29.83 / 32.53 / 33.91 dB at
epochs 25 / 50 / 75 / 100. Each case holds PSNR@100 >= 32.91 dB (JAX's less 1 dB) and no
erosion (PSNR@100 at most 0.5 dB below the best earlier validation), and prints one JSON
line: the PSNRs read from the run's log, the s/epoch median over epochs 2-100 and 90-100
(the log records' timestamps), the prune times, the mean validation frame ms, the final
compaction budget and ray count and, in B, the cull share (the marched valid samples that
the cull drops, on 16,384 rays of training view 0) at epochs 25 and 100, the last
``seg_frac_max`` and the samples that the segments' budgets dropped in training.

Beside the gate's PSNR, each validation also renders the views once more at compaction 1.0
and without the cull (``psnr_full_budget``): the field's own quality, apart from what the
validation's compaction budget drops where a chunk holds more valid samples than the
training-tuned budget (JAX's validation has the same budget). That series is held to no
erosion as well, before the gate's own two checks.
"""

import json
import logging
import os
import statistics
import time
from unittest import mock

import pytest
import torch

from wisp_tpu_torch import kernels
from wisp_tpu_torch.app.nerf import main_nerf
from wisp_tpu_torch.core.rays import Rays
from wisp_tpu_torch.trainers.multiview_trainer import MultiviewTrainer

pytestmark = [pytest.mark.slow, pytest.mark.cuda]

CONFIG = "app/nerf/configs/nerf_hash_lego_proxy.yaml"
JAX_PSNR = {25: 28.15, 50: 29.83, 75: 32.53, 100: 33.91}
PSNR_FLOOR = JAX_PSNR[100] - 1.0
EROSION_MAX = 0.5
CASES = {"A": [], "B": ["--tracer.seg-early-stop", "1e-3", "--tracer.seg-count", "4"]}
PROBE_STRIDE = 16            # every 16th ray of a 512x512 view: 16,384 rays


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        self.records.append((record.created, record.getMessage()))


def cull_share(pipeline, rays: Rays) -> float:
    """The share of the marched valid samples of ``rays`` that the tracer's segmented cull
    drops: 1 - (valid samples with the cull) / (valid samples without it), both untouched by
    the compaction budget, which caps the kept slots and not the count."""
    tracer = pipeline.tracer
    eps = tracer.seg_early_stop
    with torch.no_grad():
        culled = float(pipeline(rays=rays, channels=["rgb"]).num_valid_samples)
        tracer.seg_early_stop = 0.0
        try:
            marched = float(pipeline(rays=rays, channels=["rgb"]).num_valid_samples)
        finally:
            tracer.seg_early_stop = eps
    return 1.0 - culled / marched if marched else 0.0


def _epoch_times(records):
    """{epoch: the time of its 'EPOCH n/N | total loss' record}."""
    out = {}
    for t, msg in records:
        if msg.startswith("EPOCH ") and "total loss" in msg:
            out[int(msg.split()[1].split("/")[0])] = t
    return out


def _psnrs(records):
    out = {}
    for _, msg in records:
        if msg.startswith("EPOCH ") and "psnr:" in msg:
            out[int(msg.split()[1].split("/")[0])] = float(msg.split("psnr:")[1].split()[0])
    return out


@pytest.mark.parametrize("case", ["A", "B"])
def test_flagship_yaml_gate(tmp_path, case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the training path runs the CUDA kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    built = {}
    prunes_ms, frames_ms, culls, seg_frac, full_psnr, overflow = [], [], {}, {}, {}, {}
    build, prune, render_view = main_nerf.build, MultiviewTrainer.prune, \
        MultiviewTrainer.render_view
    evaluate_metrics, step = MultiviewTrainer.evaluate_metrics, MultiviewTrainer.step
    timing = {"on": True}

    def recording_build(cfg):
        built["parts"] = build(cfg)
        return built["parts"]

    def timed_prune(self):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prune(self)
        torch.cuda.synchronize()
        prunes_ms.append((time.perf_counter() - t0) * 1e3)

    def timed_render_view(self, rays, chunk=32768):
        if not timing["on"]:
            return render_view(self, rays, chunk)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rgb = render_view(self, rays, chunk)
        torch.cuda.synchronize()
        frames_ms.append((time.perf_counter() - t0) * 1e3)
        if case == "B" and self.epoch in (25, 100) and self.epoch not in culls:
            view = self.train_dataset.data["rays"][0]
            probe = Rays(view.origins[::PROBE_STRIDE].contiguous(),
                         view.dirs[::PROBE_STRIDE].contiguous(), view.dist_min,
                         view.dist_max)
            culls[self.epoch] = cull_share(self.pipeline, probe)
            seg_frac[self.epoch] = self._prev_seg_frac_max
        return rgb

    def evaluate_both(self, dataset):
        metrics = evaluate_metrics(self, dataset)
        tracer = self.pipeline.tracer
        kept = (tracer.compaction, tracer.seg_early_stop)
        tracer.compaction, tracer.seg_early_stop = 1.0, 0.0
        timing["on"] = False
        try:
            full_psnr.setdefault(self.epoch, evaluate_metrics(self, dataset)["psnr"])
        finally:
            tracer.compaction, tracer.seg_early_stop = kept
            timing["on"] = True
        return metrics

    def counting_step(self, data, key=None):
        step(self, data, key)
        if self.last_num_overflow is not None:
            overflow[self.epoch] = overflow.get(self.epoch, 0.0) + self.last_num_overflow

    handler = _Records()
    logger = logging.getLogger("wisp_tpu_torch")
    logger.addHandler(handler)
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        with mock.patch.object(main_nerf, "build", recording_build), \
                mock.patch.object(MultiviewTrainer, "prune", timed_prune), \
                mock.patch.object(MultiviewTrainer, "render_view", timed_render_view), \
                mock.patch.object(MultiviewTrainer, "evaluate_metrics", evaluate_both), \
                mock.patch.object(MultiviewTrainer, "step", counting_step):
            main_nerf.main(["--config", CONFIG, "--tracker.log-dir",
                            os.path.join(str(tmp_path), "logs"), *CASES[case]])
    finally:
        logger.removeHandler(handler)
    wall_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    _, trainer, _ = built["parts"]
    stamps = _epoch_times(handler.records)
    per_epoch = {e: stamps[e] - stamps[e - 1] for e in stamps if e - 1 in stamps}
    psnr = _psnrs(handler.records)
    result = {
        "gate": f"flagship yaml, case {case}", "args": CASES[case],
        "device": torch.cuda.get_device_name(0), "psnr": psnr, "jax_psnr": JAX_PSNR,
        "psnr_full_budget": full_psnr,
        "s_per_epoch_median_2_100": statistics.median(
            [per_epoch[e] for e in range(2, 101)]),
        "s_per_epoch_median_90_100": statistics.median(
            [per_epoch[e] for e in range(90, 101)]),
        "prune_ms": prunes_ms, "validation_frame_ms_mean": statistics.mean(frames_ms),
        "validation_frames": len(frames_ms),
        "final_compaction": trainer.pipeline.tracer.compaction,
        "final_rays": trainer.train_dataset.transform.num_samples,
        "updates": trainer.num_updates, "wall_s": wall_s,
        "launches": {k: v for k, v in launches.items() if v},
    }
    if case == "B":
        result.update(cull_share=culls, seg_frac_max=seg_frac,
                      seg_frac_max_last=trainer._prev_seg_frac_max,
                      train_overflow_by_epoch=overflow)
    print(json.dumps(result), flush=True)
    assert sorted(psnr) == [25, 50, 75, 100], psnr
    # the field itself, rendered without the budget's truncation, must not erode either
    assert full_psnr[100] >= max(full_psnr[e] for e in (25, 50, 75)) - EROSION_MAX, \
        f"the field eroded: {full_psnr}"
    assert psnr[100] >= PSNR_FLOOR, f"PSNR@100 {psnr[100]} below {PSNR_FLOOR}"
    best_before = max(psnr[e] for e in (25, 50, 75))
    assert psnr[100] >= best_before - EROSION_MAX, f"erosion: {psnr}"
    seg_kernels = ("compact_live", "integrate_seg_fwd", "integrate_seg_bwd",
                   "scatter_max_acc")
    if case == "B":
        assert all(launches[k] > 0 for k in seg_kernels), launches
        # training ran only the segmented composite (the unsegmented forward ran for the
        # cull-share probe and the full-budget renders)
        assert launches["integrate_bwd"] == 0
    else:
        assert all(launches[k] == 0 for k in seg_kernels), launches
