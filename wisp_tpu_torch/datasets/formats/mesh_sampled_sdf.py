"""MeshSampledSDFDataset — signed-distance samples drawn from a mesh (counterpart of
wisp_tpu/datasets/formats/mesh_sampled_sdf.py).

The mesh is an .obj (``dataset_path``, read by ``ops.mesh.io.load_obj``; with
``sample_tex`` its materials too) or given as arrays (``vertices``, ``faces`` and, for
``sample_tex``, ``texv``, ``texf``, ``materials``, ``face_mats``); it is normalized by
``mode_norm``. A resample draws ``num_samples // len(sample_mode)`` points for each entry
of ``sample_mode`` ('rand', 'near', 'trace') on the host with the dataset's
``np.random.default_rng(seed)``, as JAX draws them, or with ``get_normals`` as many surface
samples with their faces' normals; then, on the dataset's device, the exact signed
distance (K16) and with ``sample_tex`` the colour of the nearest surface point
(``closest_tex``, K17). Coords [N, 3], sdf [N, 1] and the optional rgb [N, 3] and normals
[N, 3] live on the device.
"""

from __future__ import annotations

import logging
from typing import Callable, List, Optional

import numpy as np
import torch

from wisp_tpu_torch.datasets.base_datasets import SDFDataset
from wisp_tpu_torch.datasets.batch import SDFBatch
from wisp_tpu_torch.device import DeviceLike, resolve_device
from wisp_tpu_torch.ops.mesh.closest_tex import closest_tex
from wisp_tpu_torch.ops.mesh.compute_sdf import compute_sdf
from wisp_tpu_torch.ops.mesh.io import load_obj
from wisp_tpu_torch.ops.mesh.ops import normalize, point_sample, sample_surface

log = logging.getLogger(__name__)


class MeshSampledSDFDataset(SDFDataset):
    def __init__(self, dataset_path: Optional[str] = None, split: Optional[str] = None,
                 transform: Optional[Callable] = None,
                 sample_mode: Optional[List[str]] = None, num_samples: int = 100000,
                 get_normals: bool = False, sample_tex: bool = False,
                 mode_norm: str = "sphere", vertices: Optional[np.ndarray] = None,
                 faces: Optional[np.ndarray] = None, texv: Optional[np.ndarray] = None,
                 texf: Optional[np.ndarray] = None, materials: Optional[list] = None,
                 face_mats: Optional[np.ndarray] = None, seed: int = 0,
                 device: DeviceLike = None):
        super().__init__(dataset_path=dataset_path, transform=transform, split=split)
        self.device = resolve_device(device)
        self.sample_mode = (list(sample_mode) if sample_mode is not None
                            else ["rand", "near", "near", "trace", "trace"])
        self.num_samples = num_samples
        self.get_normals = get_normals
        self.sample_tex = sample_tex
        self.mode_norm = mode_norm
        self._rng = np.random.default_rng(seed)
        self.texv, self.texf, self.materials, self.face_mats = texv, texf, materials, face_mats
        if vertices is None:
            if sample_tex:
                (vertices, faces, self.texv, self.texf, self.face_mats,
                 self.materials) = load_obj(dataset_path, load_materials=True)
            else:
                vertices, faces = load_obj(dataset_path)
        if sample_tex and not self.materials:
            raise ValueError("sample_tex=True requires a materialed mesh (.obj with "
                             "mtllib/usemtl, or explicit materials=)")
        self.vertices, self.faces = normalize(vertices, faces, mode_norm)
        self.resample()

    def draw(self):
        """The resample's host part: (points [M, 3] float32, normals [M, 3] or None)."""
        per_mode = self.num_samples // max(len(self.sample_mode), 1)
        if self.get_normals:
            return sample_surface(self.vertices, self.faces, per_mode * len(self.sample_mode),
                                  rng=self._rng, return_normals=True)
        return point_sample(self.vertices, self.faces, self.sample_mode, per_mode,
                            rng=self._rng), None

    def resample(self) -> None:
        pts_np, normals = self.draw()
        pts = torch.from_numpy(pts_np).to(self.device)
        self.normals_data = (None if normals is None
                             else torch.from_numpy(normals).to(self.device))
        self.sdf_data = compute_sdf(self.vertices, self.faces, pts)[:, None]
        self.rgb_data = None
        if self.sample_tex:
            self.rgb_data, _, _ = closest_tex(self.vertices, self.faces, self.texv, self.texf,
                                              self.materials, self.face_mats, pts)
        self.coords_data = pts
        log.info("resampled %d sdf points%s%s", pts.shape[0],
                 " (+rgb)" if self.rgb_data is not None else "",
                 " (+normals)" if self.normals_data is not None else "")

    @property
    def coordinates(self) -> torch.Tensor:
        return self.coords_data

    def __len__(self):
        return int(self.coords_data.shape[0])

    def __getitem__(self, idx):
        if not isinstance(idx, torch.Tensor):
            idx = torch.as_tensor(np.asarray(idx), device=self.device)
        batch = SDFBatch(coords=self.coords_data[idx], sdf=self.sdf_data[idx])
        if self.rgb_data is not None:
            batch["rgb"] = self.rgb_data[idx]
        if self.normals_data is not None:
            batch["normals"] = self.normals_data[idx]
        if self.transform is not None:
            batch = self.transform(batch)
        return batch
