"""AxisAlignedBBoxAS — the [-1, 1]^3 box as an acceleration structure (counterpart of
wisp_tpu/accelstructs/aabb_as.py): ``OctreeAS.make_dense(0)`` under another name, one cell
at level 0, so every march tests the box alone. The triplanar grid's default."""

from __future__ import annotations

from wisp_tpu_torch.accelstructs.octree_as import OctreeAS
from wisp_tpu_torch.device import DeviceLike


class AxisAlignedBBoxAS(OctreeAS):
    def __init__(self, device: DeviceLike = None):
        dense = OctreeAS.make_dense(0, device=device)
        self.__dict__.update(dense.__dict__)

    def name(self) -> str:
        return "AABB"

    def public_properties(self) -> dict:
        return {"Bounds": "[-1, 1]^3"}
