"""Quality gate of the port's stochastic hash-grid backward on the GPU (marker ``slow``;
tier-1 leaves it out). It imports neither jax nor the JAX package, so it runs on a machine
without JAX: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_stoch_gate.py -q -s``.

The configuration is that of tests/apps/test_nerf.py::
test_nerf_lego_proxy_quality_exact_backward with ``--grid.stoch-grad true``: the lego-proxy
scene, 20 views at 128x128 (validation on the 7-view test split), 4,096 rays a batch; a hash
grid of 8 LODs at bitwidth 13 over 16..256 ('cat', feature std 1e-9, dense_lod_matmul
'bf16', which the port reads only for the rule that keeps the dense LODs' gradient exact
below 2^30 / res^2 rows) on a level-5 octree; hidden 64 with the positional view embedding;
'ray' march, 192 steps at stride 2, compaction 0.5 with adaptive compaction, no early stop,
LOD spacing scale 1.0; AdamW lr 1e-3, eps 1e-15, weight decay 1e-6, grid lr weight 500;
huber loss; AMP on; pruning every 3 iterations from iteration 6; 20 epochs.

The floor is the JAX app's PSNR on that config less 1 dB: 19.01 dB at 20 epochs, measured
once on a CPU (a JAX-on-CPU run of 3 min 40 s; the JAX forward interpolates the dense LODs
as a bf16 matrix product, the port gathers them in float32) by

    JAX_PLATFORMS=cpu timeout 2400 python app/nerf/main_nerf.py --trainer.max-epochs 20
      --trainer.exp-name test-nerf --trainer.valid-every -1 --trainer.render-every -1
      --trainer.save-every -1 --tracker.tensorboard false --tracker.log-dir <dir>
      --dataset.constructor RandomViewDataset --dataset-transform.num-samples 4096
      --trainer.optimizer.constructor AdamW --trainer.optimizer.lr 0.001
      --trainer.optimizer.eps 1e-15 --trainer.optimizer.weight-decay 1e-6
      --trainer.grid-lr-weight 500.0 --trainer.rgb-loss-type huber
      --nef.view-embedder positional --nef.hidden-dim 64 --nef.bias true --blas-level 5
      --dataset.scene lego_proxy --dataset.num-views 20 --dataset.height 128
      --dataset.width 128 --grid.constructor HashGrid.from-geometric --grid.feature-std 1e-9
      --grid.num-lods 8 --grid.codebook-bitwidth 13 --grid.min-grid-res 16
      --grid.max-grid-res 256 --grid.multiscale-type cat --grid.dense-lod-matmul bf16
      --grid.stoch-grad true --tracer.raymarch-type ray --tracer.num-steps 192
      --tracer.compaction 0.5 --tracer.early-stop 0.0 --tracer.lod-spacing-scale 1.0
      --tracer.march-stride 2 --trainer.adaptive-compaction true --trainer.prune-every 3
      --trainer.start-prune 6

(the arguments of test_nerf.py's ``_run`` and of that test, with the one flag flipped).
"""

import pytest
import torch

from wisp_tpu_torch import kernels
from wisp_tpu_torch.accelstructs.octree_as import OctreeAS
from wisp_tpu_torch.datasets.random_view_dataset import RandomViewDataset
from wisp_tpu_torch.datasets.transforms.ray_sampler import SampleRays
from wisp_tpu_torch.models.grids.hash_grid import HashGrid
from wisp_tpu_torch.models.nefs.nerf import NeuralRadianceField
from wisp_tpu_torch.models.pipeline import Pipeline
from wisp_tpu_torch.tracers.packed_rf_tracer import PackedRFTracer
from wisp_tpu_torch.trainers.base_trainer import ConfigAdamW
from wisp_tpu_torch.trainers.multiview_trainer import ConfigMultiviewTrainer, MultiviewTrainer

pytestmark = pytest.mark.slow

JAX_PSNR = 19.01
PSNR_FLOOR = JAX_PSNR - 1.0


def test_lego_proxy_quality_stochastic_backward():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the training path runs the CUDA kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    train = RandomViewDataset(num_views=20, height=128, width=128, scene="lego_proxy",
                              transform=SampleRays(4096), device=dev)
    valid = train.create_split("test")
    grid = HashGrid.from_geometric(blas=OctreeAS.make_dense(5, device=dev), feature_dim=2,
                                   num_lods=8, multiscale_type="cat", feature_std=1e-9,
                                   codebook_bitwidth=13, min_grid_res=16, max_grid_res=256,
                                   dense_lod_matmul="bf16", stoch_grad=True, generator=gen,
                                   device=dev)
    nef = NeuralRadianceField(grid=grid, view_embedder="positional", view_multires=4,
                              hidden_dim=64, num_layers=1, bias=True, generator=gen,
                              device=dev)
    tracer = PackedRFTracer(raymarch_type="ray", num_steps=192, compaction=0.5,
                            early_stop=0.0, lod_spacing_scale=1.0, march_stride=2)
    cfg = ConfigMultiviewTrainer(
        optimizer=ConfigAdamW(lr=1e-3, eps=1e-15, weight_decay=1e-6), max_epochs=20,
        grid_lr_weight=500.0, rgb_loss_type="huber", adaptive_compaction=True,
        prune_every=3, start_prune=6)
    trainer = MultiviewTrainer(cfg, Pipeline(nef, tracer), train, validation_dataset=valid,
                               device=dev)
    kernels.reset_launches()
    trainer.train()
    launches = dict(kernels.LAUNCHES)
    psnr = trainer.validate()["psnr"]
    print(f"lego-proxy stochastic-backward gate: PSNR {psnr:.3f} dB after "
          f"{trainer.num_updates} steps ({launches['hashgrid_bwd_stoch']} stochastic and "
          f"{launches['hashgrid_bwd']} exact K1 backward launches) on "
          f"{torch.cuda.get_device_name(0)}")
    assert launches["hashgrid_bwd_stoch"] > 0 and launches["hashgrid_bwd"] == 0
    assert psnr > PSNR_FLOOR, f"lego-proxy stochastic-backward PSNR too low: {psnr}"
