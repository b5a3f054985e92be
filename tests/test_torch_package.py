"""The port stands alone: no module of wisp_tpu_torch, and not chip_smoke.py, imports jax
or wisp_tpu; importing the package builds no kernel; entry points without a card raise
unless asked for the CPU; chip_smoke.py fails without a card."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

import test_torch_helpers  # noqa: F401  (caps torch's threads)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "wisp_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "wisp_tpu")

_IMPORT_ALL = """
import importlib, pkgutil, sys
import wisp_tpu_torch
names = [m.name for m in pkgutil.walk_packages(wisp_tpu_torch.__path__, 'wisp_tpu_torch.')]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'wisp_tpu'))
from wisp_tpu_torch import kernels
print(len(names), bad, kernels._lib is None)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_import_pulls_in_no_jax_and_builds_nothing():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    line = out.stdout.strip().splitlines()[-1]
    assert line.endswith("[] True"), line
    assert int(line.split(" ")[0]) >= 20  # every submodule was imported


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_entry_points_need_a_card_or_the_cpu():
    from wisp_tpu_torch import resolve_device
    from wisp_tpu_torch.accelstructs.octree_as import OctreeAS
    from wisp_tpu_torch.models.grids.hash_grid import HashGrid
    from wisp_tpu_torch.trainers.tracker.offline_renderer import OfflineRenderer
    from wisp_tpu_torch.datasets.random_view_dataset import RandomViewDataset
    from wisp_tpu_torch.trainers.multiview_trainer import (ConfigMultiviewTrainer,
                                                           MultiviewTrainer)
    if torch.cuda.is_available():
        pytest.skip("a card is present; the no-card path cannot be shown here")
    entry_points = [lambda: resolve_device(None), lambda: OfflineRenderer((8, 8)),
                    lambda: OctreeAS.make_dense(2),
                    lambda: HashGrid(resolutions=(4, 8), codebook_bitwidth=8),
                    lambda: RandomViewDataset(num_views=2, height=4, width=4),
                    lambda: MultiviewTrainer(ConfigMultiviewTrainer(), None, [])]
    for fn in entry_points:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
    assert OfflineRenderer((8, 8), device="cpu").device.type == "cpu"
    assert OctreeAS.make_dense(2, device="cpu").occ_grid.device.type == "cpu"


def test_sdf_entry_points_need_a_card_or_the_cpu():
    import numpy as np
    from wisp_tpu_torch import interop
    from wisp_tpu_torch.accelstructs.octree_as import OctreeAS
    from wisp_tpu_torch.models.grids.octree_grid import OctreeGrid
    if torch.cuda.is_available():
        pytest.skip("a card is present; the no-card path cannot be shown here")
    from wisp_tpu_torch.accelstructs.octree_as import MeshExtent
    from wisp_tpu_torch.datasets.formats.octree_sampled_sdf import OctreeSampledSDFDataset
    from wisp_tpu_torch.ops.mesh.io import make_box_mesh
    from wisp_tpu_torch.trainers.sdf_trainer import ConfigSDFTrainer, SDFTrainer
    q = np.asarray([[1, 2, 3]], np.int32)
    blas = OctreeAS.from_quantized_points(q, 2, device="cpu")
    blas.extent = MeshExtent(*make_box_mesh())
    for fn in (lambda: OctreeAS.from_quantized_points(q, 2),
               lambda: OctreeGrid(blas=blas, num_lods=2),
               lambda: interop.build_sdf_pipeline({}, {"blas_level": 2}),
               lambda: OctreeSampledSDFDataset(blas=blas, num_samples=10),
               lambda: SDFTrainer(ConfigSDFTrainer(), None, [])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
    assert blas.level_counts == (1, 1, 1)
    assert all(m.device.type == "cpu" for m in blas.pidx_maps)
    assert OctreeGrid(blas=blas, num_lods=2, device="cpu").features[0].device.type == "cpu"


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(alone)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


FRONT_END = ["wisp_tpu_torch.config", "wisp_tpu_torch.app.nerf.main_nerf",
             "wisp_tpu_torch.app.nglod.main_nglod",
             "wisp_tpu_torch.examples.spc_browser.main_spc_browser"]


@pytest.fixture(scope="module")
def front_end_imports():
    """{module: the forbidden modules loaded once it and those before it are imported}, in
    one fresh interpreter: a module that pulls one in shows it, whatever came before."""
    code = ("import sys, importlib\n"
            f"for name in {FRONT_END!r}:\n"
            "    importlib.import_module(name)\n"
            "    print(name, sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'wisp_tpu', 'yaml', 'optax')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()[-len(FRONT_END):]
    return dict(line.split(" ", 1) for line in lines)


@pytest.mark.parametrize("module", FRONT_END)
def test_front_end_imports_no_jax(front_end_imports, module):
    """The config front end and the entry points (the apps read the yaml files with the
    port's own reader) import nothing of JAX, optax, PyYAML or the JAX package."""
    assert front_end_imports[module] == "[]"


def test_spc_browser_needs_a_card_or_the_cpu(tmp_path):
    from wisp_tpu_torch.examples.spc_browser import main_spc_browser
    if torch.cuda.is_available():
        pytest.skip("a card is present; the no-card path cannot be shown here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main_spc_browser.main(out_path=str(tmp_path / "spc.png"), res=4)
    assert not (tmp_path / "spc.png").exists()


def test_app_needs_a_card_or_the_cpu():
    from wisp_tpu_torch.app.nerf import main_nerf
    if torch.cuda.is_available():
        pytest.skip("a card is present; the no-card path cannot be shown here")
    cfg = main_nerf.parse_args(["--config", str(ROOT / "app/nerf/configs/"
                                                "nerf_octree_lego_proxy.yaml"),
                                "--trainer.save-every", "-1", "--trainer.render-every", "-1"])
    assert cfg.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main_nerf.build(cfg)
