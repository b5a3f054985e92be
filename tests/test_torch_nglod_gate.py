"""The NGLOD app's quality gates on the GPU (markers ``slow`` and ``cuda``; tier-1 leaves
them out and they skip without a card). They import neither jax nor the JAX package, so
they run on a machine without JAX:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_nglod_gate.py -q -s``.

Each case runs ``wisp_tpu_torch.app.nglod.main_nglod.main`` (what ``python -m
wisp_tpu_torch.app.nglod.main_nglod`` calls) with its log dir moved to a temporary
directory, and prints one JSON line.

* **A**: app/nglod/configs/nglod_octree.yaml as shipped (level 7, OctreeGrid 16 x 6 LODs,
  500,000 samples and 32 a voxel, batch 512, 10 epochs, a resample after each), saving the
  'full' model at the end (``--trainer.save-every 10 --trainer.model-format full``, the JAX
  workflow's flags, docs/pages/results_round4.md:88-92). The floor is the JAX app test's
  (tests/apps/test_nglod.py:36): a volumetric IoU above 0.97. Beside it: s/epoch (epochs
  2-10, from the log records' timestamps) and the saved field's 512x512 frame traced three
  ways as chip_smoke.py's "nglod app" phase traces it (``chip_smoke.nglod_frame``:
  uncompacted, compaction 0.55, and 0.55 with mid-loop compaction 0.3 at 0.5).
* **B**: the JAX texture test's command line (tests/apps/test_nglod.py:146-170: the
  procedural textured icosphere, MeshSampledSDFDataset with sample_tex, NeuralSDFTex, level
  4, 15 epochs). Its floors are JAX's (:172-179): a volumetric IoU above 0.7 and an rgb
  loss below 0.05.
"""

import json
import logging
import os
import statistics

import pytest
import torch

from wisp_tpu_torch.app.nglod import main_nglod
from wisp_tpu_torch.trainers.base_trainer import load_pipeline
from wisp_tpu_torch.trainers.tracker.tracker import Tracker

pytestmark = [pytest.mark.slow, pytest.mark.cuda]

CONFIG = "app/nglod/configs/nglod_octree.yaml"
TEXTURE_ARGV = [
    "--trainer.max-epochs", "15", "--trainer.exp-name", "test-sdftex-app",
    "--trainer.valid-every", "-1", "--trainer.render-every", "-1",
    "--trainer.save-every", "-1", "--trainer.batch-size", "4096",
    "--trainer.optimizer.lr", "0.001", "--trainer.optimizer.eps", "1e-15",
    "--trainer.grid-lr-weight", "1.0", "--tracker.tensorboard", "false",
    "--blas-level", "4", "--grid.constructor", "OctreeGrid", "--grid.feature-dim", "16",
    "--grid.num-lods", "2", "--grid.multiscale-type", "sum", "--grid.feature-std", "0.01",
    "--dataset.constructor", "MeshSampledSDFDataset", "--dataset.num-samples", "50000",
    "--dataset.sample-tex", "true", "--nef.constructor", "NeuralSDFTex",
    "--nef.hidden-dim", "64", "--nef.num-layers", "1", "--nef.position-input", "true"]


class _EpochTimes(logging.Handler):
    """The time of each epoch's console line ('EPOCH n/m | total loss ...')."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.times = {}

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith("EPOCH") and "total loss" in msg:
            self.times[int(msg.split()[1].split("/")[0])] = record.created


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the app runs the CUDA kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _run(argv):
    # on the package's logger: the app's logging.basicConfig(force=True) replaces the root's
    handler = _EpochTimes()
    logger = logging.getLogger("wisp_tpu_torch")
    logger.addHandler(handler)
    try:
        result = main_nglod.main(argv)
    finally:
        logger.removeHandler(handler)
    t = handler.times
    epochs = sorted(t)
    per_epoch = [t[e] - t[e - 1] for e in epochs[1:] if e - 1 in t]
    return result, statistics.median(per_epoch) if per_epoch else None


def test_nglod_yaml_as_shipped(dev, tmp_path):
    import chip_smoke
    log_dir = str(tmp_path)
    result, s_epoch = _run(["--config", CONFIG, "--tracker.log-dir", log_dir,
                            "--tracker.run-name", "a", "--tracker.tensorboard", "false",
                            "--trainer.save-every", "10", "--trainer.model-format", "full"])
    model = os.path.join(log_dir, "nglod-octree", "a", "model.ckpt")
    pipeline = load_pipeline(model, device=dev)
    frame, _, _ = chip_smoke.nglod_frame(dev, pipeline, Tracker())
    frame.pop("profile_chunk")
    print(json.dumps({"gate": "nglod A", "volumetric_iou": result["volumetric_iou"],
                      "iou": result["iou"], "l2_loss": result["l2_loss"],
                      "s_per_epoch_2_10": s_epoch, "frame": frame,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    assert result["volumetric_iou"] > 0.97, result


def test_nglod_texture_app(dev, tmp_path):
    result, s_epoch = _run(TEXTURE_ARGV + ["--tracker.log-dir", str(tmp_path)])
    print(json.dumps({"gate": "nglod B", "volumetric_iou": result["volumetric_iou"],
                      "rgb_loss": result["rgb_loss"], "l2_loss": result["l2_loss"],
                      "iou": result["iou"], "s_per_epoch": s_epoch,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    assert result["volumetric_iou"] > 0.7, result
    assert result["rgb_loss"] < 0.05, result
