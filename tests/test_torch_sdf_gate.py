"""Quality gate of the port's SDF training path on the GPU (marker ``slow``; tier-1 leaves
it out). It imports neither jax nor the JAX package, so it runs on a machine without JAX:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_sdf_gate.py -q -s``.

The configuration is that of tests/apps/test_nglod.py::test_nglod_octree_sphere_iou:
main_nglod.py's procedural icosphere (subdivisions 3, normalized, 2,000,000 surface
samples) in a level-4 octree; an OctreeGrid of 3 LODs of 16 features, 'sum', std 0.01; a
NeuralSDF with the xyz appended, hidden 128, one layer; an OctreeSampledSDFDataset of
60,000 samples ('near' and 'trace') and 8 per voxel; batch 2,048, Adam lr 1e-3, eps 1e-15,
grid lr weight 1.0, AMP on (JAX's default); 20 epochs, then ``validate()``. The floor is the
JAX test's: a volumetric IoU above 0.97.
"""

import pytest
import torch

from wisp_tpu_torch.accelstructs.octree_as import MeshExtent, OctreeAS
from wisp_tpu_torch.datasets.formats.octree_sampled_sdf import OctreeSampledSDFDataset
from wisp_tpu_torch.models.grids.octree_grid import OctreeGrid
from wisp_tpu_torch.models.nefs.neural_sdf import NeuralSDF
from wisp_tpu_torch.models.pipeline import Pipeline
from wisp_tpu_torch.ops.mesh.io import make_sphere_mesh
from wisp_tpu_torch.ops.mesh.ops import normalize, sample_surface
from wisp_tpu_torch.ops.spc.core import quantize_points_np
from wisp_tpu_torch.tracers.packed_sdf_tracer import PackedSDFTracer
from wisp_tpu_torch.trainers.base_trainer import ConfigAdam
from wisp_tpu_torch.trainers.sdf_trainer import ConfigSDFTrainer, SDFTrainer

pytestmark = pytest.mark.slow

IOU_FLOOR = 0.97


def test_nglod_octree_sphere_iou():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the training path runs the CUDA kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    v, f = normalize(*make_sphere_mesh(radius=1.0, subdivisions=3), "sphere")
    blas = OctreeAS.from_quantized_points(quantize_points_np(sample_surface(v, f, 2_000_000), 4),
                                          4, device=dev)
    blas.extent = MeshExtent(v, f)
    gen = torch.Generator().manual_seed(0)
    grid = OctreeGrid(blas=blas, feature_dim=16, num_lods=3, multiscale_type="sum",
                      feature_std=0.01, generator=gen, device=dev)
    nef = NeuralSDF(grid=grid, position_input=True, hidden_dim=128, num_layers=1,
                    generator=gen, device=dev)
    dataset = OctreeSampledSDFDataset(num_samples=60000, samples_per_voxel=8, blas=blas,
                                      device=dev)
    cfg = ConfigSDFTrainer(optimizer=ConfigAdam(lr=1e-3, eps=1e-15), max_epochs=20,
                           batch_size=2048, grid_lr_weight=1.0)
    trainer = SDFTrainer(cfg, Pipeline(nef, PackedSDFTracer(num_steps=32, step_size=0.8)),
                         dataset, device=dev)
    trainer.train()
    metrics = trainer.validate()
    print(f"\nSDF gate: volumetric IoU {metrics['volumetric_iou']:.4f} (floor {IOU_FLOOR}), "
          f"narrowband IoU {metrics['iou']:.4f}, {len(dataset)} samples, "
          f"{trainer.iterations_per_epoch} steps an epoch, on {torch.cuda.get_device_name(0)}")
    assert metrics["volumetric_iou"] > IOU_FLOOR
