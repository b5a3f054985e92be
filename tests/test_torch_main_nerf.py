"""The port's NeRF app (``wisp_tpu_torch.app.nerf.main_nerf``) on the CPU at a tiny size of
``nerf_octree_lego_proxy.yaml``: ``build()`` and two training steps, ``main()`` through
training and validation, and the parts that JAX's app builds the same way: the scene's
point cloud (``scene_pointcloud``) and the sparse octree from it."""

import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import np_of

from wisp_tpu.accelstructs import OctreeAS as JOctreeAS
from wisp_tpu.datasets.random_view_dataset import SCENES as JSCENES
from wisp_tpu.datasets.random_view_dataset import RandomViewDataset as JRandomViewDataset

from wisp_tpu_torch.app.nerf import main_nerf
from wisp_tpu_torch.accelstructs.octree_as import OctreeAS
from wisp_tpu_torch.datasets.random_view_dataset import SCENES, RandomViewDataset

CONFIG = "app/nerf/configs/nerf_octree_lego_proxy.yaml"
# the depth cut of these tests: a level-4 octree, 2 LODs, 2 views of 24x24, 1,024 rays
TINY = ["--trainer.save-every", "-1", "--trainer.render-every", "-1", "--device", "cpu",
        "--blas-level", "4", "--grid.num-lods", "2", "--dataset.num-views", "2",
        "--dataset.height", "24", "--dataset.width", "24",
        "--dataset-transform.num-samples", "1024", "--tracker.tensorboard", "false"]


def _args(tmp_path, *extra):
    return ["--config", CONFIG, *TINY, "--dataset.dataset-path", str(tmp_path),
            "--tracker.log-dir", str(tmp_path), *extra]


def test_build_and_two_steps(tmp_path):
    cfg = main_nerf.parse_args(_args(tmp_path))
    pipeline, trainer, renderer = main_nerf.build(cfg)
    grid, tracer = pipeline.nef.grid, pipeline.tracer
    assert type(grid).__name__ == "OctreeGrid" and grid.feature_dim == 5
    assert grid.active_lods == (3, 4) and grid.blas.max_level == 4
    assert tracer.raymarch_type == "voxel" and tracer.num_steps == 16
    assert renderer.width == renderer.height == 512
    assert type(trainer.optimizer).__name__ == "RMSprop"
    assert trainer.validation_dataset is not None
    for _ in range(2):
        trainer.iterate()
        assert math.isfinite(trainer.last_loss)
        assert trainer.last_num_overflow == 0.0
    assert 0.0 < tracer.compaction <= 1.0


def test_main_trains_and_validates(tmp_path):
    out = main_nerf.main(_args(tmp_path, "--trainer.max-epochs", "1"))
    assert math.isfinite(out["psnr"]) and out["psnr"] > 5.0


def test_scene_pointcloud_matches_jax(tmp_path):
    """The same 800,000 draws, the same points kept. A point whose density lies within 1e-5
    of the threshold 1.0 may fall on either side in the two packages (their float32 scene
    functions round differently): such points are counted, not compared."""
    ds = RandomViewDataset(num_views=2, height=4, width=4, scene="lego_proxy", device="cpu",
                           dataset_path=str(tmp_path))
    got = ds.scene_pointcloud()
    want = JRandomViewDataset.scene_pointcloud(types.SimpleNamespace(scene="lego_proxy"))
    pts = np.random.default_rng(3).uniform(-1.0, 1.0, (800_000, 3)).astype(np.float32)
    tdens = np_of(SCENES["lego_proxy"](torch.from_numpy(pts))[0][:, 0])
    jdens = np.asarray(jax.jit(JSCENES["lego_proxy"])(jnp.asarray(pts))[0][:, 0])
    near = np.abs(tdens - 1.0) <= 1e-5
    np.testing.assert_array_equal((tdens > 1.0)[~near], (jdens > 1.0)[~near])
    flips = int(((tdens > 1.0) != (jdens > 1.0)).sum())
    assert flips <= int(near.sum()) <= 50  # counted: near the threshold only
    # the lego proxy fills ~3.6% of the box: fewer than 200,000 of the draws are kept
    assert got.shape == want.shape and 20_000 < got.shape[0] < 200_000
    if flips == 0:
        np.testing.assert_array_equal(got, want)
    else:
        assert len(set(map(tuple, got)) ^ set(map(tuple, want))) <= 2 * flips


@pytest.mark.parametrize("level", [4, 7])
def test_octree_from_the_pointcloud_matches_jax(level):
    """The app's octree: the scene's point cloud at ``level``, dilated twice
    (app/nerf/main_nerf.py:72-74)."""
    pc = JRandomViewDataset.scene_pointcloud(types.SimpleNamespace(scene="lego_proxy"))
    got = OctreeAS.from_pointcloud(pc, level, dilate=2, device="cpu")
    want = JOctreeAS.from_pointcloud(pc, level, dilate=2)
    assert got.level_counts == want.level_counts
    for a, b in zip(got.codes, want.codes):
        np.testing.assert_array_equal(a.astype(np.uint64), np.asarray(b).astype(np.uint64))
    np.testing.assert_array_equal(np_of(got.occ_grid), np.asarray(want.occ_grid))
    np.testing.assert_array_equal(np_of(got.cell_density), np.asarray(want.cell_density))
