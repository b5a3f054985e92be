"""RandomViewDataset — procedural multiview dataset (counterpart of
wisp_tpu/datasets/random_view_dataset.py): cameras on a Fibonacci sphere around an analytic
density/colour field (the ``boxes`` scene, or ``lego_proxy``, the lego stand-in of the
flagship config), with ground truth from exact volumetric integration of that field.

Rays and ground truth live on the dataset's device (the card unless ``device="cpu"``). GT
integration runs there in chunks of at most 2^24 field samples. With ``dataset_path`` the
ground truth is cached as an npz there, under the same file name as the JAX package's.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from wisp_tpu_torch.core.camera import Camera
from wisp_tpu_torch.core.rays import Rays
from wisp_tpu_torch.datasets.base_datasets import MultiviewDataset
from wisp_tpu_torch.datasets.batch import MultiviewBatch
from wisp_tpu_torch.device import DeviceLike, resolve_device
from wisp_tpu_torch.ops.geometric import sample_fib_sphere
from wisp_tpu_torch.ops.raygen.raygen import generate_pinhole_rays

# soft axis-aligned boxes: center (3), half-extent (3), colour (3), density
_SCENE_BOXES = np.asarray([
    [0.0, -0.3, 0.0, 0.45, 0.15, 0.45, 0.9, 0.2, 0.1, 40.0],
    [0.0, 0.1, 0.0, 0.25, 0.25, 0.25, 0.1, 0.8, 0.2, 30.0],
    [0.25, 0.45, 0.25, 0.12, 0.12, 0.12, 0.2, 0.3, 0.9, 60.0],
    [-0.3, 0.35, -0.2, 0.10, 0.20, 0.10, 0.9, 0.8, 0.1, 50.0],
], dtype=np.float32)


def scene_density_color(coords: torch.Tensor):
    """Analytic sigma [N,1] and colour [N,3] of the boxes scene (sigmoid box edges)."""
    boxes = torch.as_tensor(_SCENE_BOXES, device=coords.device)
    centers, half, colors, sigmas = boxes[:, 0:3], boxes[:, 3:6], boxes[:, 6:9], boxes[:, 9]
    d = torch.abs(coords[:, None, :] - centers[None]) / half[None]
    inside = torch.prod(torch.sigmoid((1.0 - d) * 20.0), dim=-1)
    density = torch.sum(inside * sigmas[None], dim=-1, keepdim=True)
    w = inside * sigmas[None] + 1e-9
    color = (w[..., None] * colors[None]).sum(dim=1) / w.sum(dim=-1, keepdim=True)
    return density, color


def _sig(t):
    """C^1 smoothstep ramp centred at 0 with unit width (a sigmoid stand-in)."""
    u = torch.clamp(t + 0.5, 0.0, 1.0)
    return u * u * (3.0 - 2.0 * u)


def _boxind(px, py, pz, c, h, sharp=60.0):
    return (_sig((1.0 - torch.abs(px - c[0]) / h[0]) * sharp)
            * _sig((1.0 - torch.abs(py - c[1]) / h[1]) * sharp)
            * _sig((1.0 - torch.abs(pz - c[2]) / h[2]) * sharp))


def lego_proxy_density_color(coords: torch.Tensor):
    """The lego-bulldozer proxy: checkerboard base plate, tread fins, noise-textured body,
    cabin with windows, roof studs, two rotated arm plates and a striped blade (~4% of the
    cube occupied, edge sharpness 60-4000). Returns sigma [N,1] and colour [N,3]."""
    x, y, z = coords[:, 0], coords[:, 1], coords[:, 2]
    dev = coords.device

    def rgb(*v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    parts = []  # (indicator [N], colour [N,3] or [3], sigma)
    plate = _boxind(x, y, z, (0.0, -0.46, 0.0), (0.62, 0.04, 0.62))
    parity = torch.remainder(torch.floor(x / 0.08) + torch.floor(z / 0.08), 2.0)
    cb = (parity[:, None] * rgb(0.85, 0.75, 0.20)
          + (1.0 - parity[:, None]) * rgb(0.15, 0.15, 0.18))
    parts.append((plate, cb, 70.0))

    fin = _sig((0.018 - torch.abs(torch.remainder(x + 0.55, 0.1) - 0.05)) * 400.0)
    band_y = _sig((1.0 - torch.abs(y + 0.31) / 0.11) * 80.0)
    band_x = _sig((1.0 - torch.abs(x) / 0.58) * 80.0)
    for zc in (0.40, -0.40):
        band_z = _sig((1.0 - torch.abs(z - zc) / 0.10) * 80.0)
        parts.append((fin * band_y * band_x * band_z, rgb(0.25, 0.25, 0.28), 80.0))

    body = _boxind(x, y, z, (-0.05, -0.06, 0.0), (0.30, 0.16, 0.26))
    m = 0.55 + 0.45 * torch.sin(40.0 * x + 1.3) * torch.sin(33.0 * y + 0.7) \
        * torch.sin(47.0 * z + 2.1)
    parts.append((body, m[:, None] * rgb(0.90, 0.70, 0.10), 60.0))

    cabin = _boxind(x, y, z, (-0.18, 0.22, 0.0), (0.14, 0.12, 0.16), 80.0)
    hole = _boxind(x, y, z, (-0.18, 0.24, 0.0), (0.09, 0.07, 0.30), 80.0)
    parts.append((cabin * (1.0 - hole), rgb(0.35, 0.40, 0.55), 70.0))

    r2 = ((torch.remainder(x + 0.18 + 0.035, 0.07) - 0.035) ** 2
          + (torch.remainder(z + 0.035, 0.07) - 0.035) ** 2)
    stud = (_sig((0.022 ** 2 - r2) * 4000.0)
            * _sig((1.0 - torch.abs(y - 0.36) / 0.025) * 200.0)
            * _sig((1.0 - torch.abs(x + 0.18) / 0.12) * 80.0)
            * _sig((1.0 - torch.abs(z) / 0.14) * 80.0))
    parts.append((stud, rgb(0.95, 0.80, 0.15), 90.0))

    # float32 constants, as JAX rounds the numpy scalars
    ct, st = float(np.float32(np.cos(0.6))), float(np.float32(np.sin(0.6)))
    xr = ct * (x - 0.15) + st * (y - 0.05)
    yr = -st * (x - 0.15) + ct * (y - 0.05)
    for zc in (0.20, -0.20):
        arm = _boxind(xr, yr, z, (0.28, 0.0, zc), (0.28, 0.03, 0.015), 100.0)
        parts.append((arm, rgb(0.75, 0.12, 0.08), 80.0))

    blade = _boxind(x, y, z, (0.62, -0.28, 0.0), (0.025, 0.14, 0.30), 100.0)
    stripe = 0.5 + 0.5 * torch.sin(120.0 * y)
    parts.append((blade, stripe[:, None] * rgb(0.80, 0.78, 0.75), 90.0))

    density = torch.zeros((x.shape[0], 1), dtype=torch.float32, device=dev)
    csum = torch.zeros((x.shape[0], 3), dtype=torch.float32, device=dev)
    for ind, colour, sigma in parts:
        w = ind * sigma
        density = density + w[:, None]
        csum = csum + w[:, None] * colour
    return density, csum / (density + 1e-9)


SCENES = {"boxes": scene_density_color, "lego_proxy": lego_proxy_density_color}


def render_gt(rays: Rays, num_samples: int = 512, bg_color: float = 1.0,
              scene_fn: Callable = scene_density_color):
    """Exact volumetric rendering of the analytic scene over its box |x| < 0.78 (the
    tracer's integration math): [R,3] rgb and [R,1] alpha."""
    o, d = rays.origins, rays.dirs
    aabb = 0.78
    inv = 1.0 / torch.where(torch.abs(d) < 1e-9, torch.full_like(d, 1e-9), d)
    ta = (-aabb - o) * inv
    tb = (aabb - o) * inv
    tmin = torch.clamp(torch.amax(torch.minimum(ta, tb), dim=-1), min=1.0)
    tmax = torch.clamp(torch.amin(torch.maximum(ta, tb), dim=-1), max=5.0)
    hit = tmax > tmin
    t_near = torch.where(hit, tmin, torch.ones_like(tmin))
    t_far = torch.where(hit, torch.maximum(tmax, tmin + 1e-3),
                        torch.full_like(tmin, 1.0 + 1e-3))
    # divide by a tensor: a division by a Python scalar may round as a reciprocal product
    steps = torch.full((1,), float(num_samples), device=o.device)
    u = (torch.arange(num_samples, dtype=torch.float32, device=o.device) + 0.5) / steps
    depths = t_near[:, None] + (t_far - t_near)[:, None] * u[None]
    coords = o[:, None, :] + d[:, None, :] * depths[..., None]
    n, s, _ = coords.shape
    density, color = scene_fn(coords.reshape(-1, 3))
    density = density.reshape(n, s)
    color = color.reshape(n, s, 3)
    deltas = (t_far - t_near)[:, None] / steps
    tau = density * deltas
    sum_prev = torch.cumsum(tau, dim=-1) - tau
    weights = torch.exp(-sum_prev) * (1.0 - torch.exp(-tau))
    alpha = weights.sum(-1, keepdim=True)
    rgb = (weights[..., None] * color).sum(1) + bg_color * (1.0 - alpha)
    return rgb, alpha


class RandomViewDataset(MultiviewDataset):
    GT_CHUNK_SAMPLES = 2 ** 24  # field samples per GT integration chunk

    def __init__(self, num_views: int = 25, height: int = 128, width: int = 128,
                 split: str = "train", fov: float = 30.0, radius: float = 3.2,
                 num_gt_samples: int = 512, bg_color: str = "white",
                 transform: Optional[Callable] = None, dataset_path: Optional[str] = None,
                 scene: str = "boxes", device: DeviceLike = None):
        super().__init__(dataset_path=dataset_path, transform=transform, split=split)
        if scene not in SCENES:
            raise ValueError(f"unknown scene {scene!r}; choose from {sorted(SCENES)}")
        self.scene = scene
        self.device = resolve_device(device)
        self.num_views = num_views
        self.height = height
        self.width = width
        self.fov = fov
        self.radius = radius
        self.bg_color = bg_color
        self.num_gt_samples = num_gt_samples
        self.data = self.load()

    @torch.no_grad()
    def load(self):
        # the validation split uses other view directions than the training split
        eyes = sample_fib_sphere(self.num_views + (7 if self.split != "train" else 0))
        if self.split != "train":
            eyes = eyes[-self.num_views:]
        eyes = eyes * self.radius
        scene_fn = SCENES[self.scene]
        bg = 1.0 if self.bg_color == "white" else 0.0
        cache = self._gt_cache_file()
        cached = None
        if cache is not None and os.path.exists(cache):
            z = np.load(cache)
            cached = (z["rgb"], z["masks"])
        chunk = max(1, self.GT_CHUNK_SAMPLES // self.num_gt_samples)
        cameras, all_rays, rgbs, masks = {}, [], [], []
        for i, eye in enumerate(eyes):
            up = (0.0, 1.0, 0.0) if abs(eye[1]) < 0.95 * self.radius else (1.0, 0.0, 0.0)
            cam = Camera.from_args(eye=eye, at=(0.0, 0.0, 0.0), up=up, width=self.width,
                                   height=self.height, fov=np.radians(self.fov), near=0.0,
                                   far=6.0)
            cameras[str(i)] = cam
            rays = generate_pinhole_rays(cam, device=self.device)
            rays = Rays(rays.origins, rays.dirs, dist_min=0.0, dist_max=6.0)
            all_rays.append(rays)
            if cached is not None:
                rgbs.append(torch.from_numpy(cached[0][i]).to(self.device))
                masks.append(torch.from_numpy(cached[1][i]).to(self.device))
                continue
            rgb_parts, a_parts = [], []
            for s in range(0, len(rays), chunk):
                rgb_c, a_c = render_gt(rays[s:s + chunk], self.num_gt_samples, bg, scene_fn)
                rgb_parts.append(rgb_c)
                a_parts.append(a_c)
            rgbs.append(torch.cat(rgb_parts))
            masks.append(torch.cat(a_parts) > 0.5)
        if cache is not None and cached is None:
            os.makedirs(os.path.dirname(cache) or ".", exist_ok=True)
            np.savez_compressed(cache, rgb=torch.stack(rgbs).cpu().numpy(),
                                masks=torch.stack(masks).cpu().numpy())
        self._cameras = cameras
        return {"rays": all_rays, "rgb": rgbs, "masks": masks}

    def _gt_cache_file(self) -> Optional[str]:
        if self.dataset_path is None:
            return None
        key = (f"rv_{self.scene}_{self.split}_{self.num_views}v_{self.width}x{self.height}"
               f"_s{self.num_gt_samples}_f{self.fov:g}_r{self.radius:g}_{self.bg_color}")
        return os.path.join(self.dataset_path, key + ".npz")

    def create_split(self, split: str, transform=None) -> "RandomViewDataset":
        return RandomViewDataset(num_views=min(self.num_views, 7), height=self.height,
                                 width=self.width, split=split, fov=self.fov,
                                 radius=self.radius, num_gt_samples=self.num_gt_samples,
                                 bg_color=self.bg_color, transform=transform,
                                 dataset_path=self.dataset_path, scene=self.scene,
                                 device=self.device)

    def __len__(self):
        return len(self.data["rays"])

    def __getitem__(self, idx: int) -> MultiviewBatch:
        batch = MultiviewBatch(rays=self.data["rays"][idx], rgb=self.data["rgb"][idx],
                               masks=self.data["masks"][idx])
        if self.transform is not None:
            batch = self.transform(batch)
        return batch

    @property
    def img_shape(self):
        return (self.height, self.width)

    @property
    def num_images(self):
        return len(self.data["rays"])

    @property
    def cameras(self):
        return self._cameras

    @torch.no_grad()
    def scene_pointcloud(self, num_points: int = 200000, threshold: float = 1.0
                         ) -> np.ndarray:
        """Points of the analytic scene's occupied region, for a sparse octree: 4x
        ``num_points`` uniform draws in the box from ``default_rng(3)`` (JAX's draws), those
        whose scene density exceeds ``threshold`` (evaluated on the dataset's device), the
        first ``num_points`` of them."""
        rng = np.random.default_rng(3)
        pts = rng.uniform(-1.0, 1.0, (num_points * 4, 3)).astype(np.float32)
        density, _ = SCENES[self.scene](torch.from_numpy(pts).to(self.device))
        keep = (density[:, 0] > threshold).cpu().numpy()
        return pts[keep][:num_points]
