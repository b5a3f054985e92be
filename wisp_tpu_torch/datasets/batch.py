"""Batch containers (counterpart of wisp_tpu/datasets/batch.py): dicts with attribute
access. Values are tensors on the dataset's device, or Rays."""

from __future__ import annotations


class Batch(dict):
    """AttrDict-style batch: b.rays, b['rays'] interchangeable."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        self[name] = value


class MultiviewBatch(Batch):
    """Multiview training batch: rays and per-ray supervision channels (rgb, masks)."""

    def ray_values(self):
        return {k: v for k, v in self.items() if k != "rays"}


class SDFBatch(Batch):
    """SDF training batch: coords [B, 3] and their signed distances sdf [B, 1]."""
