"""SDFTrainer — a neural SDF fitted to sampled signed distances (counterpart of
wisp_tpu/trainers/sdf_trainer.py).

* ``next_batch`` draws ``batch_size`` sample indices from ``np.random.default_rng(
  random_seed)``, as JAX does, and indexes the dataset's tensors on the device with them;
  an epoch is ``max(len(dataset) // batch_size, 1)`` steps, fixed at construction.
* ``step``: per loss LOD (the last only with ``only_last``) the sum of squared errors of
  the field's sdf and, when the batch carries 'rgb' (a textured dataset and NeuralSDFTex),
  of its colour; their sum divided by the batch size -> backward -> the optimizer. AMP is
  the base trainer's bf16 decoder policy. The step's three stats (loss, l2 and rgb loss
  over the batch) are read at once, in one device read (JAX defers the fetch by a step to
  hide a device round trip).
* ``post_epoch`` resamples the dataset when ``resample`` is set; ``render_snapshot`` (the
  ``render_every`` cadence) logs the field's cross-sections at 0 along x, y and z
  (``OfflineRenderer.sdf_slice``) and writes them as ``slice_d<dim>_ep<epoch>.png`` into
  the run's log dir.
* ``validate``: the IoU of the inside sets over the training samples (chunks of 65,536),
  and the volumetric IoU over 50,000 uniform points of ``default_rng(7)`` against the
  mesh's exact signed distance (K16): inside occupied cells where the dataset samples an
  octree (OctreeSampledSDFDataset, a narrowband field), over the whole box for a
  MeshSampledSDFDataset.

Not ported yet: the training state (``checkpoint_every`` and ``resume`` are refused when the
trainer is made): it does not carry the dataset's resampled points yet. ``save_every`` (the
pipeline) works.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from wisp_tpu_torch.ops.image.io import write_png
from wisp_tpu_torch.ops.mesh.compute_sdf import compute_sdf
from wisp_tpu_torch.ops.mesh.ops import sample_uniform
from wisp_tpu_torch.ops.sdf.metrics import compute_sdf_iou
from wisp_tpu_torch.trainers.base_trainer import BaseTrainer, ConfigBaseTrainer

log = logging.getLogger(__name__)

VALID_CHUNK = 65536
VALID_UNIFORM_POINTS = 50000
VALID_SEED = 7


@dataclasses.dataclass
class ConfigSDFTrainer(ConfigBaseTrainer):
    only_last: bool = True
    resample: bool = False
    batch_size: int = 4096


class SDFTrainer(BaseTrainer):
    def __init__(self, cfg: ConfigSDFTrainer, pipeline, train_dataset, tracker=None,
                 device=None):
        super().__init__(cfg=cfg, pipeline=pipeline, train_dataset=train_dataset,
                         tracker=tracker, device=device)
        if cfg.resume or cfg.checkpoint_every > -1:
            raise NotImplementedError(
                "the SDF trainer's training state (its dataset's resampled points and batch "
                "stream) is not carried by checkpoints yet (ROADMAP Queue 1, item 7)")
        self._batch_rng = np.random.default_rng(cfg.random_seed)
        self.iterations_per_epoch = max(len(train_dataset) // cfg.batch_size, 1)
        self.loss_lods = self._loss_lods()

    def _loss_lods(self):
        lods = list(range(self.pipeline.nef.grid.num_lods))
        return lods[-1:] if self.cfg.only_last else lods

    def pre_training(self):
        super().pre_training()
        self.tracker.metrics.define_metric("l2_loss", aggregation_type=float)
        self.tracker.metrics.define_metric("rgb_loss", aggregation_type=float)

    def pre_epoch(self):
        super().pre_epoch()
        self.loss_lods = self._loss_lods()

    def post_epoch(self):
        super().post_epoch()
        if self.cfg.resample:
            self.train_dataset.resample()

    def reset_data_iterator(self):
        self._data_iter = iter(range(self.iterations_per_epoch))

    def next_batch(self):
        next(self._data_iter)  # StopIteration at the end of the epoch
        idx = self._batch_rng.integers(0, len(self.train_dataset), size=(self.cfg.batch_size,))
        return self.train_dataset[idx]

    def compute_loss(self, coords: torch.Tensor, gts: torch.Tensor,
                     rgb_gts: Optional[torch.Tensor] = None):
        """(loss, aux): the summed squared sdf error, and colour error where ``rgb_gts``
        is given, over the loss LODs, over the batch; aux holds both terms over the
        batch."""
        l2_loss = 0.0
        rgb_loss = torch.zeros((), dtype=torch.float32, device=coords.device)
        for lod_idx in self.loss_lods:
            if rgb_gts is not None:
                out = self.pipeline.nef(channels=["rgb", "sdf"], coords=coords,
                                        lod_idx=lod_idx)
                rgb_loss = rgb_loss + ((out["rgb"] - rgb_gts[..., :3]) ** 2).sum()
                pred = out["sdf"]
            else:
                pred = self.pipeline.nef(channels="sdf", coords=coords, lod_idx=lod_idx)
            l2_loss = l2_loss + ((pred - gts) ** 2).sum()
        n = coords.shape[0]
        loss = (l2_loss + rgb_loss) / n
        return loss, {"l2_loss": l2_loss / n, "rgb_loss": rgb_loss / n}

    def step(self, data):
        coords = data["coords"].contiguous()
        gts = data["sdf"].reshape(coords.shape[0], -1)
        self.optimizer.zero_grad(set_to_none=True)
        loss, aux = self.compute_loss(coords, gts, data.get("rgb"))
        loss.backward()
        self.optimizer_step()
        stats = torch.stack([loss.detach(), aux["l2_loss"].detach(),
                             aux["rgb_loss"].detach()]).tolist()
        self.last_loss = stats[0]
        self.tracker.metrics.total_loss += stats[0]
        self.tracker.metrics.l2_loss += stats[1]
        self.tracker.metrics.rgb_loss += stats[2]

    def log_console(self):
        l2_loss = self.tracker.metrics.average_metric("l2_loss")
        log.info("EPOCH %d/%d | total loss: %.3E | l2 loss: %.3E", self.epoch, self.max_epochs,
                 self.tracker.metrics.average_metric("total_loss"), l2_loss)
        self.return_dict["l2_loss"] = l2_loss
        self.return_dict["rgb_loss"] = self.tracker.metrics.average_metric("rgb_loss")

    @torch.no_grad()
    def render_snapshot(self):
        """The field's cross-sections at 0 along x, y and z, logged and written as PNG."""
        if self.tracker.visualizer is None:
            return
        nef = self.pipeline.nef
        for dim in range(3):
            img = self.tracker.visualizer.sdf_slice(
                lambda coords: nef(channels="sdf", coords=coords), dim=dim, depth=0.0)
            self.tracker.log_image(f"sdf_slice/dim{dim}", img, self.epoch)
            write_png(os.path.join(self.tracker.ensure_log_dir(),
                                   f"slice_d{dim}_ep{self.epoch}.png"), img)

    @torch.no_grad()
    def validate(self) -> Dict[str, Any]:
        nef = self.pipeline.nef
        dataset = self.train_dataset
        coords = dataset.coordinates
        preds = [nef(channels="sdf", coords=coords[i:i + VALID_CHUNK].contiguous())
                 for i in range(0, coords.shape[0], VALID_CHUNK)]
        metrics = {"iou": compute_sdf_iou(torch.cat(preds), dataset.sdf_data)}
        blas = getattr(dataset, "blas", None)
        pts = torch.from_numpy(sample_uniform(VALID_UNIFORM_POINTS,
                                              rng=np.random.default_rng(VALID_SEED)))
        pts = pts.to(coords.device)
        if blas is not None:
            # inside occupied cells, where a narrowband field is defined
            vertices, faces = blas.extent.vertices, blas.extent.faces
            pts = pts[blas.query(pts).pidx > -1].contiguous()
        else:
            vertices, faces = dataset.vertices, dataset.faces
        gt = compute_sdf(vertices, faces, pts)
        metrics["volumetric_iou"] = compute_sdf_iou(nef(channels="sdf", coords=pts), gt)
        for k, v in metrics.items():
            self.tracker.log_metric(f"validation/{k}", v, self.epoch)
        log.info("EPOCH %d/%d | %s", self.epoch, self.max_epochs,
                 " | ".join(f"validation {k}: {v:.4f}" for k, v in metrics.items()))
        self.return_dict.update(metrics)
        return metrics
