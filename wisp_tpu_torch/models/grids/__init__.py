"""The feature grids of the port."""

from wisp_tpu_torch.models.grids.codebook_grid import CodebookOctreeGrid
from wisp_tpu_torch.models.grids.hash_grid import HashGrid
from wisp_tpu_torch.models.grids.octree_grid import OctreeGrid
from wisp_tpu_torch.models.grids.triplanar_grid import TriplanarGrid

__all__ = ["CodebookOctreeGrid", "HashGrid", "OctreeGrid", "TriplanarGrid"]
