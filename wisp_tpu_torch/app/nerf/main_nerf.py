"""The NeRF app of the port (counterpart of app/nerf/main_nerf.py): train a NeRF from a yaml
config and the command line, on the card unless ``--device cpu``.

    python -m wisp_tpu_torch.app.nerf.main_nerf --config app/nerf/configs/nerf_octree_lego_proxy.yaml

Grids, JAX's union: ``HashGrid.from_geometric``, ``HashGrid.from_octree``, ``OctreeGrid``,
``TriplanarGrid`` and ``CodebookOctreeGrid``. The octree is built from the dataset's point
cloud with ``--sparse-blas`` (the procedural scene's ``scene_pointcloud``, dilated twice),
else it is ``make_dense``; every grid gets it. The yaml files are read as data, with the
port's own reader (``wisp_tpu_torch.config``).

The tracker gets the app's config (written to ``config.yaml`` in the run's log dir) and a
512x512 ``OfflineRenderer`` for the ``render_every`` snapshots; ``save_every`` saves the
pipeline there in the trainer's ``model_format``. ``--pretrained <file>`` starts from a saved
pipeline when ``model_format`` is 'full', as JAX's app does; with 'state_dict' it is ignored
there too, and the pipeline of the config is built anew. A setting
the port has not ported is refused by ``parse_args``, before anything is built
(``config.utils.check_ported``).
"""

import dataclasses
import logging
import sys
from typing import Optional

import torch

from wisp_tpu_torch.accelstructs.octree_as import OctreeAS
from wisp_tpu_torch.config import autoconfig, instantiate, parse_config, print_config
from wisp_tpu_torch.config.utils import check_ported
from wisp_tpu_torch.datasets.random_view_dataset import RandomViewDataset
from wisp_tpu_torch.datasets.transforms.ray_sampler import SampleRays
from wisp_tpu_torch.device import resolve_device
from wisp_tpu_torch.models.grids.codebook_grid import CodebookOctreeGrid
from wisp_tpu_torch.models.grids.hash_grid import HashGrid
from wisp_tpu_torch.models.grids.octree_grid import OctreeGrid
from wisp_tpu_torch.models.grids.triplanar_grid import TriplanarGrid
from wisp_tpu_torch.models.nefs.nerf import NeuralRadianceField
from wisp_tpu_torch.models.pipeline import Pipeline
from wisp_tpu_torch.tracers.packed_rf_tracer import PackedRFTracer
from wisp_tpu_torch.trainers.base_trainer import load_pipeline
from wisp_tpu_torch.trainers.multiview_trainer import ConfigMultiviewTrainer, MultiviewTrainer
from wisp_tpu_torch.trainers.tracker.offline_renderer import OfflineRenderer
from wisp_tpu_torch.trainers.tracker.tracker import ConfigTracker, Tracker

RENDER_RES = (512, 512)


@dataclasses.dataclass
class NeRFAppConfig:
    blas_level: int = 7
    sparse_blas: bool = False
    nef: autoconfig(NeuralRadianceField) = None
    grid: autoconfig(HashGrid.from_geometric, HashGrid.from_octree, OctreeGrid, TriplanarGrid,
                     CodebookOctreeGrid) = None
    tracer: autoconfig(PackedRFTracer) = None
    dataset: autoconfig(RandomViewDataset) = None
    dataset_transform: autoconfig(SampleRays) = None
    trainer: ConfigMultiviewTrainer = None
    tracker: ConfigTracker = None
    log_level: int = logging.INFO
    pretrained: Optional[str] = None
    device: str = "cuda"
    valid_only: bool = False


def parse_args(argv=None) -> NeRFAppConfig:
    """The app's config from the command line (``--config file.yaml`` and overrides),
    refused, before anything is built, if it asks for what is not ported yet."""
    cfg = parse_config(NeRFAppConfig, args=argv)
    check_ported(cfg)
    return cfg


def build(cfg: NeRFAppConfig):
    """(pipeline, trainer, renderer) of the config, on ``cfg.device``."""
    device = resolve_device(cfg.device)
    # parameter init draws from one seeded generator, on the host
    gen = torch.Generator().manual_seed(cfg.trainer.random_seed)
    transform = instantiate(cfg.dataset_transform)
    train_dataset = instantiate(cfg.dataset, transform=transform, device=device)
    validation_dataset = train_dataset.create_split(cfg.trainer.valid_split or "val",
                                                    transform=None)
    pc = train_dataset.as_pointcloud()
    if pc is None and cfg.sparse_blas and hasattr(train_dataset, "scene_pointcloud"):
        pc = train_dataset.scene_pointcloud()
    if pc is not None:
        blas = OctreeAS.from_pointcloud(pc, cfg.blas_level, dilate=2, device=device)
    else:
        blas = OctreeAS.make_dense(cfg.blas_level, device=device)
    if cfg.pretrained and cfg.trainer.model_format == "full":
        pipeline = load_pipeline(cfg.pretrained, device=device)
    else:
        grid = instantiate(cfg.grid, blas=blas, generator=gen, device=device)
        nef = instantiate(cfg.nef, grid=grid, generator=gen, device=device)
        pipeline = Pipeline(nef=nef, tracer=instantiate(cfg.tracer))
    tracker = Tracker(exp_name=cfg.trainer.exp_name, cfg=cfg.tracker)
    tracker.save_app_config(cfg)
    renderer = OfflineRenderer(render_res=RENDER_RES, device=device)
    tracker.set_visualizer(renderer)
    trainer = MultiviewTrainer(cfg=cfg.trainer, pipeline=pipeline, train_dataset=train_dataset,
                               validation_dataset=validation_dataset, tracker=tracker,
                               device=device)
    return pipeline, trainer, renderer


def main(argv=None):
    cfg = parse_args(argv)
    logging.basicConfig(stream=sys.stdout, level=cfg.log_level, force=True,
                        format="%(asctime)s|%(levelname)8s| %(message)s",
                        datefmt="%Y-%m-%d %H:%M:%S")
    print_config(cfg)
    _, trainer, _ = build(cfg)
    if not cfg.valid_only:
        trainer.train()
    trainer.validate()
    return trainer.return_dict


if __name__ == "__main__":
    main()
