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
    q = np.asarray([[1, 2, 3]], np.int32)
    blas = OctreeAS.from_quantized_points(q, 2, device="cpu")
    for fn in (lambda: OctreeAS.from_quantized_points(q, 2),
               lambda: OctreeGrid(blas=blas, num_lods=2),
               lambda: interop.build_sdf_pipeline({}, {"blas_level": 2})):
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
