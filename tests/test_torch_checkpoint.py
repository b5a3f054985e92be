"""The port's checkpoints, resume, model files and render snapshots on the CPU, at a tiny
size of ``nerf_hash_lego_proxy_stoch.yaml`` (a level-4 octree, 4 LODs at bitwidth 10, 2 views
of 16x16, 256 rays a batch and then ~8,192 samples, 64 steps a ray, a prune every 2 steps
from step 2 that keeps 60-93% of the cells, so that every step trains on samples): the
state of a resumed run equals the uninterrupted run's exactly, and each model format loads
back a pipeline that renders as the saved one."""

import math
import os
import warnings

import pytest
import torch

import test_torch_helpers  # noqa: F401  (caps torch's threads)

from wisp_tpu_torch.app.nerf import main_nerf
from wisp_tpu_torch.core.rays import Rays
from wisp_tpu_torch.trainers import checkpoint
from wisp_tpu_torch.trainers.base_trainer import (load_pipeline, load_state_dict,
                                                  pipeline_state_dict)
from wisp_tpu_torch.trainers.tracker import tracker as tracker_mod

CONFIG = "app/nerf/configs/nerf_hash_lego_proxy_stoch.yaml"
TINY = ["--device", "cpu", "--blas-level", "4", "--grid.num-lods", "4",
        "--grid.codebook-bitwidth", "10", "--grid.max-grid-res", "64",
        "--dataset.num-views", "2", "--dataset.height", "16", "--dataset.width", "16",
        "--dataset-transform.num-samples", "256", "--tracer.num-steps", "64",
        "--trainer.prune-every", "2", "--trainer.start-prune", "2",
        # the yaml's 2.96 culls every cell of a field this young: 0.9 culls some
        "--nef.prune-min-density", "0.9",
        "--trainer.max-epochs", "5", "--trainer.target-sample-size", "8192",
        "--tracker.tensorboard", "false",
        "--tracker.run-name", "run"]


def _build(tmp_path, *extra):
    cfg = main_nerf.parse_args(["--config", os.path.abspath(CONFIG), *TINY,
                                "--dataset.dataset-path", str(tmp_path),
                                "--tracker.log-dir", str(tmp_path), *extra])
    return main_nerf.build(cfg)


def _steps(trainer, n):
    for _ in range(n):
        trainer.iterate()
        assert math.isfinite(trainer.last_loss)


def _rays(n=64):
    g = torch.Generator().manual_seed(0)
    d = torch.nn.functional.normalize(torch.randn(n, 3, generator=g) * 0.2
                                      + torch.tensor([0.0, 0.0, 1.0]), dim=-1)
    o = torch.tensor([0.0, 0.0, -3.0]).expand(n, 3) + 0.3 * torch.randn(n, 3, generator=g)
    return Rays(o.contiguous(), d.contiguous(), 0.0, 6.0)


def _render(pipeline):
    with torch.no_grad():
        return pipeline(rays=_rays(), channels=["rgb", "alpha", "depth"])


def _trainer_state(trainer):
    """Everything the resumed run must reproduce, as comparable values."""
    nef, tracer = trainer.pipeline.nef, trainer.pipeline.tracer
    opt = trainer.optimizer.state_dict()
    return {
        "pipeline": pipeline_state_dict(trainer.pipeline),
        "optimizer": {k: v for i, s in opt["state"].items() for k, v in
                      ((f"{i}.{n}", t) for n, t in s.items())},
        "density_max_grid": trainer._density_max_grid,
        "counters": (trainer.epoch, trainer.iteration, trainer.num_updates),
        "adaptive": (trainer.train_dataset.transform.num_samples, tracer.compaction,
                     trainer._prev_num_samples, tuple(trainer._frac_window),
                     trainer._steps_since_retune),
        "blas_dense": nef.grid.blas.dense,
    }


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for key in a:
        if isinstance(a[key], dict):
            assert a[key].keys() == b[key].keys(), key
            for k in a[key]:
                assert torch.equal(torch.as_tensor(a[key][k]), torch.as_tensor(b[key][k])), k
        elif isinstance(a[key], torch.Tensor):
            assert torch.equal(a[key], b[key]), key
        else:
            assert a[key] == b[key], key


@pytest.mark.parametrize("k,m", [(3, 4)])
def test_resume_equals_uninterrupted(tmp_path, k, m):
    """k steps, the train state saved mid-epoch, a fresh trainer with ``--trainer.resume
    <file>``, m more steps: the same codebook, decoders, optimizer state, prune state
    (occupancy, cell densities, keep-scores), carried density maxima, counters, adaptive
    rays and budget, bit for bit, as k+m uninterrupted steps. Prunes fall on steps 2, 4
    and 6, on both sides of the save."""
    _, trainer, _ = _build(tmp_path)
    _steps(trainer, k)
    path = trainer.save_training_state()
    assert os.path.basename(path) == checkpoint.TRAIN_STATE_BASENAME + ".pt"
    _steps(trainer, m)
    assert not trainer.pipeline.nef.grid.blas.dense      # a prune carved the octree
    assert 0.0 < float(trainer.pipeline.nef.grid.blas.occ_grid.float().mean()) < 1.0
    assert trainer._prev_num_samples > 1000
    _, resumed, _ = _build(tmp_path, "--trainer.resume", path)
    _steps(resumed, m)
    _assert_same(_trainer_state(trainer), _trainer_state(resumed))


def test_checkpoint_every_and_resume_auto(tmp_path):
    """``resume: auto`` starts anew where the run's log dir holds no checkpoint; with
    ``checkpoint_every 1`` the end of each epoch writes one, and a later ``auto`` resumes
    from it at the next epoch's first step."""
    _, fresh, _ = _build(tmp_path, "--trainer.resume", "auto", "--trainer.checkpoint-every",
                         "1")
    assert checkpoint.latest_checkpoint(fresh.tracker.log_dir) is None
    _steps(fresh, 3)          # epoch 1 ends at step 3: the checkpoint is written
    assert (fresh.epoch, fresh.iteration) == (2, 1)
    path = checkpoint.latest_checkpoint(fresh.tracker.log_dir)
    assert path is not None and path.endswith(".pt")
    _, again, _ = _build(tmp_path, "--trainer.resume", "auto")
    _steps(again, 1)
    assert (again.epoch, again.iteration) == (2, 1)
    _assert_same(_trainer_state(fresh), _trainer_state(again))


@pytest.mark.parametrize("lose", [None, "generator", "optimizer", "density_max_grid"])
def test_chip_resume_check_sees_a_lost_state(tmp_path, lose):
    """``chip_smoke.state_differences``, the card's check that a resumed trainer holds the
    saved train state before its first step: it finds nothing after a resume, and names
    the random stream, the optimizer's state or the carried density maxima where a resume
    left one of them as built."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    _, trainer, _ = _build(tmp_path)
    _steps(trainer, 2)
    path = trainer.save_training_state()
    saved = trainer.state_dict()
    _, resumed, _ = _build(tmp_path, "--trainer.resume", path)
    resumed.begin_training()
    if lose == "generator":
        resumed.generator.manual_seed(0)
    elif lose == "optimizer":
        resumed.optimizer.state.clear()
    elif lose == "density_max_grid":
        resumed._density_max_grid.zero_()
    diffs = chip_smoke.state_differences(saved, resumed.state_dict())
    if lose is None:
        assert diffs == []
    else:
        assert diffs and all(lose in d for d in diffs), diffs


@pytest.mark.parametrize("fmt", ["full", "state_dict"])
def test_model_round_trip(tmp_path, fmt):
    """``save_model`` after a prune; 'full' reloads with ``load_pipeline``, 'state_dict'
    into a freshly built pipeline with ``load_state_dict``: the same tensors, the pruned
    octree, the same render. The control, a state without the octree's tensors and the
    keep-scores (a parameters-only state_dict), marches on a dense grid and renders
    otherwise."""
    pipeline, trainer, _ = _build(tmp_path, "--trainer.model-format", fmt)
    _steps(trainer, 3)
    assert not pipeline.nef.grid.blas.dense
    path = trainer.save_model()
    want = _render(pipeline)
    if fmt == "full":
        assert path.endswith("model.ckpt")
        loaded = load_pipeline(path, device="cpu")
    else:
        assert path.endswith("model.ckpt.pt")
        loaded, _, _ = _build(tmp_path)
        assert loaded.nef.grid.blas.dense
        load_state_dict(loaded, path)
        # the tracer's settings are config, not tensors (as in JAX's npz): the adapted budget
        loaded.tracer.compaction = pipeline.tracer.compaction
    assert not loaded.nef.grid.blas.dense
    _assert_same({"s": pipeline_state_dict(pipeline)}, {"s": pipeline_state_dict(loaded)})
    got = _render(loaded)
    for ch in ("rgb", "alpha", "depth"):
        assert torch.equal(got.channels[ch], want.channels[ch]), ch
    # the control: the parameters alone
    control, _, _ = _build(tmp_path)
    control.tracer.compaction = pipeline.tracer.compaction
    params = dict(torch.load(path, weights_only=True)) \
        if fmt == "state_dict" else dict(pipeline.named_parameters())
    params = {k: v for k, v in params.items() if "blas" not in k and "occupancy" not in k}
    control.load_state_dict(params, strict=False)
    assert control.nef.grid.blas.dense
    assert not torch.equal(_render(control).alpha, want.alpha)


def test_save_as_new_file_names(tmp_path):
    _, trainer, _ = _build(tmp_path, "--trainer.save-as-new", "true")
    _steps(trainer, 1)
    path = trainer.save_model()
    assert os.path.basename(path) == "model-ep1-it1.ckpt"
    assert os.path.dirname(path) == os.path.join(str(tmp_path), "nerf-hash-lego-proxy-stoch",
                                                 "run")


def test_tracker_warns_once_without_tensorboard(monkeypatch):
    def missing(log_dir):
        raise ImportError("No module named 'tensorboard'")

    monkeypatch.setattr(tracker_mod, "_Tensorboard", missing)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("default")
        for _ in range(3):
            t = tracker_mod.Tracker(cfg=tracker_mod.ConfigTracker(log_dir="unused"))
            assert t.dashboards == []
    msgs = [str(w.message) for w in caught if "tensorboard" in str(w.message)]
    assert len(msgs) == 1, msgs


def test_render_every_calls_the_visualizer(tmp_path):
    """With ``render_every 1`` each epoch's end renders one snapshot through the tracker's
    visualizer, from the tracker's snapshot camera, and logs its channels as images."""
    _, trainer, renderer = _build(tmp_path, "--trainer.render-every", "1")
    renderer.width = renderer.height = 8
    calls, images = [], []
    real = renderer.render_snapshot

    def recording(pipeline, **kwargs):
        calls.append(kwargs)
        return real(pipeline, **kwargs)

    renderer.render_snapshot = recording
    trainer.tracker.log_image = lambda name, image, step: images.append((name, image.shape,
                                                                         step))
    _steps(trainer, 5)        # epochs 1 and 2 end at steps 3 and 5
    cam = trainer.tracker.cfg.vis_camera
    assert len(calls) == 2 and calls[0]["f"] == cam.camera_origin
    assert ("rgb", (8, 8, 3), 1) in images and ("alpha", (8, 8, 1), 2) in images
