"""OctreeSampledSDFDataset — signed-distance samples in the occupied cells of an octree
built from a mesh (counterpart of wisp_tpu/datasets/formats/octree_sampled_sdf.py).

A resample draws ``samples_per_voxel`` uniform points in every max-level leaf and
``num_samples // len(sample_mode)`` points for each entry of ``sample_mode`` ('rand',
'near', 'trace'), all on the host with the dataset's ``np.random.default_rng(seed)`` (the
same points as JAX's), keeps those inside occupied cells (the octree query, K9) and takes
their exact signed distance to the mesh (K16). Coords [N, 3] and sdf [N, 1] live on the
dataset's device; the octree's query maps must live there too.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from wisp_tpu_torch.datasets.base_datasets import SDFDataset
from wisp_tpu_torch.datasets.batch import SDFBatch
from wisp_tpu_torch.device import DeviceLike, resolve_device
from wisp_tpu_torch.ops.mesh.compute_sdf import compute_sdf
from wisp_tpu_torch.ops.mesh.ops import point_sample
from wisp_tpu_torch.ops.spc.sampling import sample_spc


class OctreeSampledSDFDataset(SDFDataset):
    def __init__(self, split: Optional[str] = None, transform: Optional[Callable] = None,
                 sample_mode: Optional[List[str]] = None, num_samples: int = 100000,
                 samples_per_voxel: int = 32, blas=None, seed: int = 0,
                 dataset_path: Optional[str] = None, device: DeviceLike = None):
        super().__init__(dataset_path=dataset_path, transform=transform, split=split)
        if not self.supports_blas(blas):
            raise ValueError("OctreeSampledSDFDataset needs an octree that carries its mesh "
                             "(blas.extent = MeshExtent(vertices, faces))")
        self.device = resolve_device(device)
        self.blas = blas
        self.sample_mode = list(sample_mode) if sample_mode is not None else ["near", "trace"]
        self.num_samples = num_samples
        self.samples_per_voxel = samples_per_voxel
        self._rng = np.random.default_rng(seed)
        self.resample()

    @staticmethod
    def supports_blas(blas) -> bool:
        return getattr(blas, "extent", None) is not None

    def draw(self) -> np.ndarray:
        """The resample's host part: voxel samples, then the mode samples, [M, 3] float32."""
        extent = self.blas.extent
        leaves = np.asarray(self.blas.points[self.blas.max_level])
        voxel = sample_spc(leaves, self.blas.max_level, self.samples_per_voxel, rng=self._rng)
        per_mode = self.num_samples // max(len(self.sample_mode), 1)
        surf = point_sample(extent.vertices, extent.faces, self.sample_mode, per_mode,
                            rng=self._rng)
        return np.concatenate([voxel, surf]).astype(np.float32)

    def narrowband(self, pts: np.ndarray) -> torch.Tensor:
        """The points inside occupied max-level cells, on the device."""
        p = torch.from_numpy(pts).to(self.device)
        return p[self.blas.query(p).pidx > -1].contiguous()

    def resample(self) -> None:
        pts = self.narrowband(self.draw())
        sdf = compute_sdf(self.blas.extent.vertices, self.blas.extent.faces, pts)
        self.coords_data = pts
        self.sdf_data = sdf[:, None]

    @property
    def coordinates(self) -> torch.Tensor:
        return self.coords_data

    def __len__(self):
        return int(self.coords_data.shape[0])

    def __getitem__(self, idx):
        if not isinstance(idx, torch.Tensor):
            idx = torch.as_tensor(np.asarray(idx), device=self.device)
        batch = SDFBatch(coords=self.coords_data[idx], sdf=self.sdf_data[idx])
        if self.transform is not None:
            batch = self.transform(batch)
        return batch
