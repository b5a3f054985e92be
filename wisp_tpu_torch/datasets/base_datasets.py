"""Dataset base classes (counterpart of wisp_tpu/datasets/base_datasets.py: the multiview
and SDF bases)."""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np


class WispDataset:
    def __init__(self, dataset_path: Optional[str] = None,
                 transform: Optional[Callable] = None, split: Optional[str] = None):
        self.dataset_path = dataset_path
        self.transform = transform
        self.split = split

    def create_split(self, split: str, transform: Optional[Callable] = None):
        """A sibling dataset over another split."""
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise NotImplementedError


class MultiviewDataset(WispDataset):
    """Base of posed-image datasets."""

    @property
    def img_shape(self):
        raise NotImplementedError

    @property
    def num_images(self) -> int:
        raise NotImplementedError

    @property
    def cameras(self):
        raise NotImplementedError

    def as_pointcloud(self) -> Optional[np.ndarray]:
        """A depth-derived point cloud for the octree, where the dataset has depth (none
        here yet)."""
        return None


class SDFDataset(WispDataset):
    """Base of coordinate / signed-distance sample datasets."""

    def resample(self) -> None:
        """Draw the samples anew (SDFTrainer calls it between epochs when asked to)."""

    @property
    def coordinates(self):
        raise NotImplementedError
