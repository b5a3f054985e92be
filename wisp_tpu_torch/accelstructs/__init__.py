"""The acceleration structures of the port."""

from wisp_tpu_torch.accelstructs.aabb_as import AxisAlignedBBoxAS
from wisp_tpu_torch.accelstructs.octree_as import OctreeAS

__all__ = ["AxisAlignedBBoxAS", "OctreeAS"]
