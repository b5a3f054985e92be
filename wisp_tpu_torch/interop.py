"""Weights carried across: build the port's pipeline from the JAX pipeline's parameters,
given as numpy arrays, so that both packages compute the same function.

``build_pipeline`` builds a NeRF (on a hash grid or an octree grid; any of its marches,
'ray', 'uniform' or 'voxel', as ``config["tracer"]`` says), ``build_sdf_pipeline`` the
NGLOD SDF and ``build_spc_field`` the SPC browser's field (see each).
``sphere_sdf_decoder`` makes the deterministic decoder weights under which a NeuralSDF
approximates the sphere |x| - 0.9 (the checks of a render need a field that converges;
random weights do not).

``build_pipeline``'s ``params`` keys (the JAX module paths):

* ``grid.codebook.feats`` [total, F] — the flat hash table of a hash grid, or
  ``grid.features.<i>`` [V_i, F] — the dual-vertex features of an OctreeGrid's active LOD i
  (``config["grid"]["constructor"] == "OctreeGrid"``);
* ``blas.codes.<l>`` — the sorted morton codes of level l = 0..blas_level of a sparse octree
  (an OctreeGrid needs one); without them the octree is ``make_dense``;
* ``decoder_density.layers.<i>.weight`` [out, in] / ``.bias`` [out], ``decoder_density.lout.*``,
  and the same under ``decoder_color``;
* ``blas.occ_grid`` [8^level] bool and ``blas.cell_density`` [8^level] float32;
* optional: ``grid.occupancy`` [8^level] float32 (the prune keep-score) and
  ``nef.prune_streak`` [8^level] int32 (the grace streaks, with ``prune_grace`` > 1).

``config`` holds the static settings: ``blas_level``, ``blas_dense`` (a ``make_dense`` octree
never carved), ``grid`` (``resolutions``, ``feature_dim``, ``codebook_bitwidth``,
``multiscale_type`` of a HashGrid; or ``constructor: "OctreeGrid"`` and the OctreeGrid's
keyword arguments), ``nef`` (NeuralRadianceField keyword arguments, the prune settings
``prune_density_decay``, ``prune_min_density`` and ``prune_grace`` among them) and ``tracer``
(PackedRFTracer keyword arguments). This module reads numpy only; reading a JAX pipeline
into such a dict is the caller's business (the parity tests do it).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from wisp_tpu_torch.accelstructs.octree_as import MeshExtent, OctreeAS
from wisp_tpu_torch.device import DeviceLike, resolve_device
from wisp_tpu_torch.models.grids.hash_grid import HashGrid
from wisp_tpu_torch.models.grids.octree_grid import OctreeGrid
from wisp_tpu_torch.models.nefs.nerf import NeuralRadianceField
from wisp_tpu_torch.models.nefs.neural_sdf import NeuralSDF, NeuralSDFTex
from wisp_tpu_torch.models.nefs.spc_field import SPCField
from wisp_tpu_torch.models.pipeline import Pipeline
from wisp_tpu_torch.ops.geometric import sample_fib_sphere
from wisp_tpu_torch.tracers.packed_rf_tracer import PackedRFTracer
from wisp_tpu_torch.tracers.packed_sdf_tracer import PackedSDFTracer


def _load(param: torch.Tensor, value: np.ndarray, name: str) -> None:
    value = torch.from_numpy(np.array(value)).to(param.dtype)
    if tuple(param.shape) != tuple(value.shape):
        raise ValueError(f"{name}: shape {tuple(value.shape)} does not match the port's "
                         f"{tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(value)


def _load_decoder(decoder, prefix: str, params: Mapping[str, np.ndarray]) -> None:
    layers = list(decoder.layers) + [decoder.lout]
    names = [f"{prefix}.layers.{i}" for i in range(len(decoder.layers))] + [f"{prefix}.lout"]
    for layer, name in zip(layers, names):
        _load(layer.weight, params[name + ".weight"], name + ".weight")
        if layer.bias is not None:
            _load(layer.bias, params[name + ".bias"], name + ".bias")


def build_pipeline(params: Mapping[str, np.ndarray], config: Dict[str, Any],
                   device: DeviceLike = None) -> Pipeline:
    """The port's pipeline holding ``params``."""
    device = resolve_device(device)
    level = int(config["blas_level"])
    if "blas.codes.0" in params:
        blas = OctreeAS.from_codes([np.asarray(params[f"blas.codes.{l}"])
                                    for l in range(level + 1)], device=device)
    else:
        blas = OctreeAS.make_dense(level, device=device)
    if not config.get("blas_dense", False) and "blas.occ_grid" in params:
        occ = torch.from_numpy(np.array(params["blas.occ_grid"], dtype=bool)).to(device)
        dens = torch.from_numpy(np.array(params["blas.cell_density"], np.float32))
        blas = blas.update_occupancy(occ, dens.to(device))
    g = dict(config["grid"])
    if g.pop("constructor", "HashGrid") == "OctreeGrid":
        grid = OctreeGrid(blas=blas, device=device, **g)
        for i, feats in enumerate(grid.features):
            _load(feats, params[f"grid.features.{i}"], f"grid.features.{i}")
    else:
        grid = HashGrid(blas=blas, feature_dim=int(g["feature_dim"]),
                        resolutions=[int(r) for r in g["resolutions"]],
                        multiscale_type=g.get("multiscale_type", "cat"),
                        codebook_bitwidth=int(g["codebook_bitwidth"]),
                        coord_dim=int(g.get("coord_dim", 3)), device=device)
        _load(grid.codebook.feats, params["grid.codebook.feats"], "grid.codebook.feats")
    nef = NeuralRadianceField(grid=grid, device=device, **config.get("nef", {}))
    _load_decoder(nef.decoder_density, "decoder_density", params)
    _load_decoder(nef.decoder_color, "decoder_color", params)
    if "grid.occupancy" in params:
        _load(grid.occupancy, params["grid.occupancy"], "grid.occupancy")
    if "nef.prune_streak" in params and nef.prune_streak is not None:
        _load(nef.prune_streak, params["nef.prune_streak"], "nef.prune_streak")
    tracer = PackedRFTracer(**config.get("tracer", {}))
    return Pipeline(nef=nef, tracer=tracer)


def build_sdf_pipeline(params: Mapping[str, np.ndarray], config: Dict[str, Any],
                       device: DeviceLike = None) -> Pipeline:
    """The port's NGLOD pipeline (sparse OctreeAS, OctreeGrid or HashGrid, NeuralSDF or
    NeuralSDFTex, PackedSDFTracer) holding ``params``:

    * ``blas.codes.<l>`` — the sorted morton codes of level l, for l = 0..blas_level;
    * ``grid.features.<i>`` [V_i, F] — the dual-vertex features of active LOD i, or for a
      hash grid (``config["grid"]["constructor"] == "HashGrid"``, with ``resolutions``)
      ``grid.codebook.feats`` [total, F];
    * ``decoder.layers.<i>.weight`` [out, in] / ``.bias``, ``decoder.lout.*``;
    * optional: ``mesh.vertices`` [V, 3] and ``mesh.faces`` [T, 3], the mesh the octree was
      built from, kept as ``blas.extent`` (an SDF dataset samples it).

    ``config`` holds ``blas_level`` and the keyword arguments of ``grid`` (OctreeGrid),
    ``nef`` (NeuralSDF) and ``tracer`` (PackedSDFTracer); ``nef_constructor``
    "NeuralSDFTex" builds the textured field, whose decoder has four outputs."""
    device = resolve_device(device)
    level = int(config["blas_level"])
    blas = OctreeAS.from_codes([np.asarray(params[f"blas.codes.{l}"])
                                for l in range(level + 1)], device=device)
    if "mesh.vertices" in params:
        blas.extent = MeshExtent(np.asarray(params["mesh.vertices"], np.float32),
                                 np.asarray(params["mesh.faces"], np.int32))
    g = dict(config.get("grid", {}))
    if g.pop("constructor", "OctreeGrid") == "HashGrid":
        grid = HashGrid(blas=blas, device=device, **g)
        _load(grid.codebook.feats, params["grid.codebook.feats"], "grid.codebook.feats")
    else:
        grid = OctreeGrid(blas=blas, device=device, **g)
        for i, feats in enumerate(grid.features):
            _load(feats, params[f"grid.features.{i}"], f"grid.features.{i}")
    nef_cls = NeuralSDFTex if config.get("nef_constructor") == "NeuralSDFTex" else NeuralSDF
    nef = nef_cls(grid=grid, device=device, **config.get("nef", {}))
    _load_decoder(nef.decoder, "decoder", params)
    return Pipeline(nef=nef, tracer=PackedSDFTracer(**config.get("tracer", {})))


def build_spc_field(codes_per_level, colors: Optional[np.ndarray] = None,
                    normals: Optional[np.ndarray] = None, device: DeviceLike = None
                    ) -> SPCField:
    """The port's SPCField of a JAX one: its octree's sorted morton codes of each level 0..L
    (``blas.codes``, numpy) and its cell colours [num_leaves, 3] (and normals), numpy."""
    device = resolve_device(device)
    blas = OctreeAS.from_codes([np.asarray(c, dtype=np.uint64) for c in codes_per_level],
                               device=device)
    return SPCField(blas=blas, colors=colors, normals=normals, device=device)


def sphere_sdf_decoder(feature_dim: int, hidden_dim: int, seed: int = 0,
                       radius: float = 0.9) -> Dict[str, np.ndarray]:
    """Decoder weights (one hidden layer, relu, input = features then xyz) under which a
    NeuralSDF approximates |x| - ``radius``: hidden unit i weighs the xyz columns by the
    i-th Fibonacci-sphere direction u_i (its feature columns are seeded N(0, 0.05), so the
    features still move the field), and the output weights w solve, by ridge least squares
    over 4,096 Fibonacci directions x, sum_i w_i relu(u_i·x) = 1. Since relu(u·x) scales
    with |x|, the field is then |x| g(x/|x|) - radius with g within 0.6% of 1 at 128 hidden
    units (the plain weights 4/hidden, from the mean |x|/4 of relu(u·x), leave 1%)."""
    rng = np.random.default_rng(seed)
    u = sample_fib_sphere(hidden_dim)
    w0 = np.zeros((hidden_dim, feature_dim + 3), np.float32)
    w0[:, :feature_dim] = rng.normal(0.0, 0.05, (hidden_dim, feature_dim))
    w0[:, feature_dim:] = u
    fit = np.maximum(sample_fib_sphere(4096).astype(np.float64) @ u.T.astype(np.float64), 0.0)
    w = np.linalg.solve(fit.T @ fit + 1e-3 * np.eye(hidden_dim), fit.sum(axis=0))
    return {"decoder.layers.0.weight": w0,
            "decoder.layers.0.bias": np.zeros((hidden_dim,), np.float32),
            "decoder.lout.weight": w.astype(np.float32)[None],
            "decoder.lout.bias": np.full((1,), -radius, np.float32)}
