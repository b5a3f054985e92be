"""OfflineRenderer — headless renderer (counterpart of
wisp_tpu/trainers/tracker/offline_renderer.py: ``render`` and ``render_lookat``). Every
channel the tracer returns comes back: the NeRF's rgb, alpha, depth and hit, the SDF
tracer's xyz and normal too, and scalar channels (``num_overflow``) summed over the chunks.
``render_snapshot`` is the frame of the trainer's ``render_every`` snapshots, and
``sdf_slice`` the colour-mapped cross-section of an SDF that the SDF trainer's snapshots
log. The default 'rb' shading leaves rgb as the tracer wrote it; matcap and shadows are not
ported yet.

Rays go through the pipeline in chunks of ``render_batch`` (16,384 by default). The tail
chunk is padded to the chunk size with copies of its last ray, as in JAX, so that the
compaction budget of every chunk, and with it any overflow, is the same in both packages.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from wisp_tpu_torch.core.camera import Camera
from wisp_tpu_torch.core.rays import Rays
from wisp_tpu_torch.core.render_buffer import RenderBuffer
from wisp_tpu_torch.device import DeviceLike, resolve_device
from wisp_tpu_torch.ops.geometric import normalized_slice
from wisp_tpu_torch.ops.raygen.raygen import generate_pinhole_rays


class OfflineRenderer:
    DEFAULT_RENDER_BATCH = 2 ** 14

    def __init__(self, render_res: Tuple[int, int] = (1024, 1024), render_batch: int = -1,
                 device: DeviceLike = None):
        self.width, self.height = render_res
        self.render_batch = self.DEFAULT_RENDER_BATCH if render_batch < 0 else render_batch
        self.device = resolve_device(device)

    @torch.no_grad()
    def render(self, pipeline, rays: Rays, lod_idx: Optional[int] = None) -> RenderBuffer:
        """Trace a ray pack through the pipeline in chunks; outputs stay on the device."""
        rays = rays.to(self.device)
        n = rays.origins.shape[0]
        chunk = self.render_batch if self.render_batch > 0 else n
        outs = []
        for i in range(0, n, chunk):
            o, d = rays.origins[i:i + chunk], rays.dirs[i:i + chunk]
            pad = chunk - o.shape[0] if n > chunk else 0
            if pad > 0:
                o = torch.cat([o, o[-1:].expand(pad, 3)], dim=0)
                d = torch.cat([d, d[-1:].expand(pad, 3)], dim=0)
            r = Rays(o.contiguous(), d.contiguous(), rays.dist_min, rays.dist_max)
            out = pipeline(rays=r, lod_idx=lod_idx) if lod_idx is not None \
                else pipeline(rays=r)
            outs.append(out[:chunk - pad] if pad > 0 else out)
        return RenderBuffer.cat(outs) if len(outs) > 1 else outs[0]

    def render_lookat(self, pipeline, f=(0.0, 0.0, -3.0), t=(0.0, 0.0, 0.0),
                      fov: float = 30.0, lod_idx=None,
                      camera_clamp=(0.0, 10.0)) -> RenderBuffer:
        """Render from a look-at camera; channels come back as [H, W, C]."""
        up = (0.0, 1.0, 0.0)
        if abs(np.asarray(f)[1]) > 0.95 * np.linalg.norm(np.asarray(f)):
            up = (1.0, 0.0, 0.0)
        camera = Camera.from_args(eye=f, at=t, up=up, width=self.width, height=self.height,
                                  fov=np.radians(fov), near=camera_clamp[0],
                                  far=camera_clamp[1])
        rays = generate_pinhole_rays(camera, device=self.device)
        rb = self.render(pipeline, rays, lod_idx)
        return rb.reshape(self.height, self.width, -1)

    def render_snapshot(self, pipeline, f=(0.0, 0.0, -3.0), t=(0.0, 0.0, 0.0), fov: float = 30.0,
                        lod_idx=None, camera_clamp=(0.0, 10.0)) -> RenderBuffer:
        """The trainer's render snapshot: one ``render_lookat`` frame."""
        return self.render_lookat(pipeline, f=f, t=t, fov=fov, lod_idx=lod_idx,
                                  camera_clamp=camera_clamp)

    @torch.no_grad()
    def sdf_slice(self, sdf_fn, dim: int = 0, depth: float = 0.0, res: int = 256
                  ) -> np.ndarray:
        """[res, res, 3] float32 image of ``sdf_fn`` ([N, 3] points -> [N, 1] distances) on
        the plane at ``depth`` along axis ``dim``: outside fades from white at the surface,
        inside is blue, and the band |d| < 2/res is white (JAX offline_renderer.py:128)."""
        coords = normalized_slice(res, res, dim=dim, depth=depth,
                                  device=self.device).reshape(-1, 3)
        d = sdf_fn(coords).reshape(res, res).float().cpu().numpy()
        img = np.zeros((res, res, 3), dtype=np.float32)
        inside = d < 0
        img[..., 0] = np.where(inside, 0.2, 1.0 - np.clip(np.abs(d) * 4, 0, 1))
        img[..., 1] = np.where(inside, 0.4 + np.clip(-d * 4, 0, 0.6), 0.8)
        img[..., 2] = np.where(inside, 1.0, 1.0 - np.clip(np.abs(d) * 4, 0, 1))
        img[np.abs(d) < (2.0 / res)] = 1.0
        return img
