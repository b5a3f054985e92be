"""The NGLOD app of the port (counterpart of app/nglod/main_nglod.py): train a neural SDF
from a yaml config and the command line, on the card unless ``--device cpu``.

    python -m wisp_tpu_torch.app.nglod.main_nglod --config app/nglod/configs/nglod_octree.yaml

The octree is built from the .obj of ``--mesh-path`` (``OctreeAS.from_mesh``) or, without
one, from 2,000,000 surface samples of the procedural icosphere (subdivisions 3,
normalized to 'sphere'), as JAX's app does. The dataset follows its constructor:
``OctreeSampledSDFDataset`` samples that octree; ``MeshSampledSDFDataset`` samples the mesh,
and with ``sample_tex`` its colours: the .obj's materials, or for the icosphere a planar UV
map and JAX's procedural 64x64 texture. Grids: ``OctreeGrid`` and ``HashGrid.from_geometric``
(``TriplanarGrid`` is refused, naming its ROADMAP item); fields: ``NeuralSDF`` and
``NeuralSDFTex``.

The tracker gets the app's config and a 512x512 ``OfflineRenderer``, whose ``sdf_slice``
the trainer's ``render_every`` snapshots use; ``save_every`` saves the pipeline in the
trainer's ``model_format``. ``--pretrained <file>`` starts from a saved pipeline when
``model_format`` is 'full' (with 'state_dict' it is ignored there, as in JAX), and
``--valid-only`` validates it without training. ``parse_args`` refuses a setting the port
has not ported before anything is built (``config.utils.check_ported``).
"""

import dataclasses
import logging
import sys
from typing import Optional

import numpy as np
import torch

from wisp_tpu_torch.accelstructs.octree_as import MeshExtent, OctreeAS
from wisp_tpu_torch.config import autoconfig, instantiate, parse_config, print_config
from wisp_tpu_torch.config.utils import check_ported
from wisp_tpu_torch.datasets.formats.mesh_sampled_sdf import MeshSampledSDFDataset
from wisp_tpu_torch.datasets.formats.octree_sampled_sdf import OctreeSampledSDFDataset
from wisp_tpu_torch.device import resolve_device
from wisp_tpu_torch.models.grids.hash_grid import HashGrid
from wisp_tpu_torch.models.grids.octree_grid import OctreeGrid
from wisp_tpu_torch.models.nefs.neural_sdf import NeuralSDF, NeuralSDFTex
from wisp_tpu_torch.models.pipeline import Pipeline
from wisp_tpu_torch.ops.mesh.io import make_sphere_mesh
from wisp_tpu_torch.ops.mesh.ops import normalize, sample_surface
from wisp_tpu_torch.ops.spc.core import quantize_points_np
from wisp_tpu_torch.tracers.packed_sdf_tracer import PackedSDFTracer
from wisp_tpu_torch.trainers.base_trainer import load_pipeline
from wisp_tpu_torch.trainers.sdf_trainer import ConfigSDFTrainer, SDFTrainer
from wisp_tpu_torch.trainers.tracker.offline_renderer import OfflineRenderer
from wisp_tpu_torch.trainers.tracker.tracker import ConfigTracker, Tracker

RENDER_RES = (512, 512)
SPHERE_SAMPLES = 2_000_000      # the icosphere's surface samples (main_nglod.py:66)


@dataclasses.dataclass
class NGLODAppConfig:
    mesh_path: Optional[str] = None
    blas_level: int = 5
    num_samples_on_mesh: int = 1000000
    grid: autoconfig(OctreeGrid, HashGrid.from_geometric) = None
    nef: autoconfig(NeuralSDF, NeuralSDFTex) = None
    tracer: autoconfig(PackedSDFTracer) = None
    dataset: autoconfig(MeshSampledSDFDataset, OctreeSampledSDFDataset) = None
    trainer: ConfigSDFTrainer = None
    tracker: ConfigTracker = None
    log_level: int = logging.INFO
    pretrained: Optional[str] = None
    device: str = "cuda"
    valid_only: bool = False


def parse_args(argv=None) -> NGLODAppConfig:
    """The app's config from the command line (``--config file.yaml`` and overrides),
    refused, before anything is built, if it asks for what is not ported yet."""
    cfg = parse_config(NGLODAppConfig, args=argv)
    check_ported(cfg)
    return cfg


def procedural_texture():
    """JAX's texture of the icosphere (main_nglod.py:80-93): (UVs of the vertices from
    their x and y, one material with a smooth 64x64 image)."""
    uu, vv = np.meshgrid(np.linspace(0, 1, 64), np.linspace(0, 1, 64))
    tex = np.stack([0.5 + 0.5 * np.sin(6.28 * uu), 0.5 + 0.5 * np.cos(6.28 * vv),
                    0.5 + 0.5 * np.sin(3.14 * (uu + vv))], axis=-1).astype(np.float32)
    return [{"diffuse_texname": tex}]


def build_octree(cfg: NGLODAppConfig, device) -> OctreeAS:
    """The octree of ``--mesh-path``, or of the procedural icosphere; it carries its mesh."""
    if cfg.mesh_path:
        return OctreeAS.from_mesh(cfg.mesh_path, level=cfg.blas_level,
                                  num_samples=cfg.num_samples_on_mesh, device=device)
    vertices, faces = normalize(*make_sphere_mesh(radius=1.0, subdivisions=3), "sphere")
    samples = sample_surface(vertices, faces, SPHERE_SAMPLES)
    blas = OctreeAS.from_quantized_points(quantize_points_np(samples, cfg.blas_level),
                                          cfg.blas_level, device=device)
    blas.extent = MeshExtent(vertices, faces)
    logging.info("No --mesh-path given; using the procedural icosphere mesh")
    return blas


def build_dataset(cfg: NGLODAppConfig, blas: OctreeAS, device):
    """The config's dataset: the octree's samples, or the mesh's (textured with
    ``sample_tex``)."""
    if "Octree" in type(cfg.dataset).__name__:
        return instantiate(cfg.dataset, blas=blas, device=device)
    vertices, faces = blas.extent.vertices, blas.extent.faces
    if not getattr(cfg.dataset, "sample_tex", False):
        return instantiate(cfg.dataset, vertices=vertices, faces=faces, device=device)
    if cfg.mesh_path:
        return instantiate(cfg.dataset, dataset_path=cfg.mesh_path, device=device)
    texv = ((vertices[:, :2] + 1.0) / 2.0).astype(np.float32)
    return instantiate(cfg.dataset, vertices=vertices, faces=faces, texv=texv,
                       texf=faces.copy(), materials=procedural_texture(),
                       face_mats=np.zeros(len(faces), np.int32), device=device)


def build(cfg: NGLODAppConfig):
    """(pipeline, trainer) of the config, on ``cfg.device``."""
    device = resolve_device(cfg.device)
    # parameter init draws from one seeded generator, on the host
    gen = torch.Generator().manual_seed(cfg.trainer.random_seed)
    blas = build_octree(cfg, device)
    train_dataset = build_dataset(cfg, blas, device)
    if cfg.pretrained and cfg.trainer.model_format == "full":
        pipeline = load_pipeline(cfg.pretrained, device=device)
    else:
        grid = instantiate(cfg.grid, blas=blas, generator=gen, device=device)
        nef = instantiate(cfg.nef, grid=grid, generator=gen, device=device)
        pipeline = Pipeline(nef=nef, tracer=instantiate(cfg.tracer))
    tracker = Tracker(exp_name=cfg.trainer.exp_name, cfg=cfg.tracker)
    tracker.save_app_config(cfg)
    tracker.set_visualizer(OfflineRenderer(render_res=RENDER_RES, device=device))
    trainer = SDFTrainer(cfg=cfg.trainer, pipeline=pipeline, train_dataset=train_dataset,
                         tracker=tracker, device=device)
    return pipeline, trainer


def main(argv=None):
    cfg = parse_args(argv)
    logging.basicConfig(stream=sys.stdout, level=cfg.log_level, force=True,
                        format="%(asctime)s|%(levelname)8s| %(message)s",
                        datefmt="%Y-%m-%d %H:%M:%S")
    print_config(cfg)
    _, trainer = build(cfg)
    if not cfg.valid_only:
        trainer.train()
    trainer.validate()
    return trainer.return_dict


if __name__ == "__main__":
    main()
