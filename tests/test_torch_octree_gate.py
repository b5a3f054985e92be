"""Quality gate of the octree-grid NeRF through the port's app on the GPU (marker ``slow``;
tier-1 leaves it out). It imports neither jax nor the JAX package:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_octree_gate.py -q -s``.

The configuration is that of tests/apps/test_nerf.py::test_nerf_octree_grid_quick (an
OctreeGrid of 2 LODs x 8 features, 'sum', std 0.01, on the sparse level-4 octree of the
scene's point cloud; 8 views of 40x40, 256 GT samples, 1,024 rays a batch, target 32,768
samples; hidden 64; AdamW lr 1e-3, eps 1e-15, weight decay 1e-6, grid lr weight 500;
huber; no pruning; 8 epochs), with the 'voxel' march of 16 samples a voxel in place of its
'ray' march of 96 steps. It goes through ``wisp_tpu_torch.app.nerf.main_nerf.main`` with the
command line of the JAX test's ``_run``/``_light``.

The floor is the JAX app's PSNR on this same configuration less 0.5 dB (the margin of
``test_nerf_voxel_compaction_quality_parity``): 21.93 dB, measured once on the CPU with

    JAX_PLATFORMS=cpu python -c "import sys; sys.path[:0] = ['.', 'tests']; \\
    from apps.test_nerf import _light; print(_light(['--grid.constructor', 'OctreeGrid', \\
    '--grid.feature-dim', '8', '--grid.num-lods', '2', '--grid.feature-std', '0.01', \\
    '--grid.multiscale-type', 'sum', '--tracer.raymarch-type', 'voxel', \\
    '--tracer.num-steps', '16', '--blas-level', '4', '--sparse-blas', 'true'], epochs=8))"

(PSNR 21.926519666399276), so the floor is 21.43 dB.
"""

import pytest
import torch

from wisp_tpu_torch.app.nerf import main_nerf

pytestmark = pytest.mark.slow

JAX_PSNR = 21.926519666399276
PSNR_FLOOR = JAX_PSNR - 0.5

# tests/apps/test_nerf.py _run (with _light's overrides) and the octree test's flags,
# 'voxel' in place of 'ray'
ARGS = [
    "--trainer.max-epochs", "8", "--trainer.exp-name", "test-nerf",
    "--trainer.valid-every", "-1", "--trainer.render-every", "-1",
    "--trainer.save-every", "-1", "--trainer.prune-every", "-1",
    "--tracker.tensorboard", "false", "--dataset.constructor", "RandomViewDataset",
    "--dataset.num-views", "12", "--dataset.height", "64", "--dataset.width", "64",
    "--dataset-transform.num-samples", "2048",
    "--trainer.optimizer.constructor", "AdamW", "--trainer.optimizer.lr", "0.001",
    "--trainer.optimizer.eps", "1e-15", "--trainer.optimizer.weight-decay", "1e-6",
    "--trainer.grid-lr-weight", "500.0", "--trainer.rgb-loss-type", "huber",
    "--nef.view-embedder", "positional", "--nef.hidden-dim", "64", "--nef.bias", "true",
    "--blas-level", "5",
    # _light
    "--dataset.num-views", "8", "--dataset.height", "40", "--dataset.width", "40",
    "--dataset.num-gt-samples", "256", "--dataset-transform.num-samples", "1024",
    "--trainer.target-sample-size", "32768",
    # test_nerf_octree_grid_quick, 'voxel'
    "--grid.constructor", "OctreeGrid", "--grid.feature-dim", "8", "--grid.num-lods", "2",
    "--grid.feature-std", "0.01", "--grid.multiscale-type", "sum",
    "--tracer.raymarch-type", "voxel", "--tracer.num-steps", "16",
    "--blas-level", "4", "--sparse-blas", "true",
]


def test_octree_grid_voxel_quality():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the training path runs the CUDA kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    result = main_nerf.main(ARGS)
    psnr = result["psnr"]
    print(f"octree-grid voxel gate: PSNR {psnr:.3f} dB (JAX {JAX_PSNR:.3f}, floor "
          f"{PSNR_FLOOR:.3f}) on {torch.cuda.get_device_name(0)}")
    assert psnr > PSNR_FLOOR, f"octree-grid voxel PSNR too low: {psnr}"
