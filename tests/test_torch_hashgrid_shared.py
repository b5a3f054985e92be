"""The host rule that picks the LODs K1's backward accumulates in shared memory
(``ops/grid.py shared_lods``) at the flagship's geometry and at the kernel tests', and the
two refusals of ``early_stop > 0``, which name the ROADMAP item where the cull lives.

CPU only, no JAX: the rule is plain Python that the card's wrapper calls before each
launch, so what it picks is checked here and what the kernel does with it on the card
(``tests/test_torch_kernels_cuda.py``).
"""

import types

import numpy as np
import pytest

from wisp_tpu_torch.config import utils as config_utils
from wisp_tpu_torch.ops import grid as grid_ops
from wisp_tpu_torch.tracers.packed_rf_tracer import PackedRFTracer


def geometric_resolutions(num_lods=16, lo=16, hi=512):
    """``HashGrid.from_geometric``'s resolutions (the flagship's: 16 LODs over 16..512)."""
    b = np.exp((np.log(hi) - np.log(lo)) / (num_lods - 1))
    return [int(np.floor(lo * b ** lod)) for lod in range(num_lods)]


# the flagship's rows a LOD at F = 2: 16^3 x 8 B = 32,768; 20^3: 64,000; 25^3: 125,000
@pytest.mark.parametrize("limit,expected", [
    (grid_ops.SHARED_MEMORY_BYTES, 3), (221_768, 3), (221_767, 2), (96_768, 2),
    (96_767, 1), (32_768, 1), (32_767, 0), (0, 0), (10 ** 9, 3)])
def test_shared_lods_at_the_flagship(limit, expected):
    res = geometric_resolutions()
    assert res[:4] == [16, 20, 25, 32]
    assert grid_ops.shared_lods(res, 19, 3, 2, 13, limit) == expected


def test_shared_lods_default_at_the_flagship():
    """The library's setting, taken from the card's measurement (PERF.md, section 6): LOD 0
    (32 KB), within a quarter of an SM's shared memory, so four blocks of 512 threads stay
    resident."""
    res = geometric_resolutions()
    assert grid_ops.shared_lods(res, 19, 3, 2, 13, grid_ops.SHARED_LOD_BYTES) == 1
    assert 4 * (grid_ops.SHARED_LOD_BYTES + 1024) <= 233_472   # an SM's 228 KB


@pytest.mark.parametrize("dim,f_dim,expected", [(3, 2, 2), (3, 8, 2), (2, 1, 4), (2, 2, 4),
                                                (2, 8, 4)])
def test_shared_lods_at_the_kernel_tests_geometry(dim, f_dim, expected):
    """Resolutions 4..64 at bitwidth 10: the dense LODs are 4 and 8 in 3D, 4 to 32 in 2D,
    and all of them fit a block (2D at F = 8: 1,360 rows x 32 B)."""
    assert grid_ops.shared_lods([4, 8, 16, 32, 64], 10, dim, f_dim, 5) == expected


def test_shared_lods_stops_at_a_hashed_lod_and_at_the_block():
    # a hashed LOD ends the prefix though a later one is dense again
    assert grid_ops.shared_lods([4, 64, 8], 10, 3, 2, 3) == 1
    # however high the limit, the rows stay within a block's 227 KB: 7 LODs of 16^3 x 8 B
    assert grid_ops.shared_lods([16] * 10, 19, 3, 2, 10, 10 ** 9) == 7
    # the LODs past n_lods are not looked at
    assert grid_ops.shared_lods([4, 8, 16], 12, 3, 2, 1) == 1


def test_shared_lods_stops_where_the_clip_reaches_the_last_row():
    """float32(res - 1 - 1e-5) is res - 1 above res 257, so a corner could leave the LOD's
    rows: such a LOD is never privatized (it only fits a block in 1D)."""
    assert not np.float32(300 - 1 - 1e-5) < 300 - 1
    assert grid_ops.shared_lods([300], 19, 1, 1, 1) == 0
    assert grid_ops.shared_lods([200], 19, 1, 1, 1) == 1


def test_early_stop_refusals_name_item_5():
    """The config front end and the tracer refuse ``early_stop > 0`` citing ROADMAP Queue 1,
    item 5 (the rest of the RF path), where the cull is queued."""
    with pytest.raises(NotImplementedError, match=r"item 5\)"):
        config_utils.refuse_unported("early_stop", 0.01, "tracer.")
    tracer = PackedRFTracer(early_stop=0.01)
    nef = types.SimpleNamespace(grid=object())
    with pytest.raises(NotImplementedError, match=r"item 5\)"):
        tracer.trace(nef, None, {"rgb"}, set(), early_stop=0.01)
