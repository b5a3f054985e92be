"""Shared helpers of the port's parity tests (no tests here).

Inputs are made with numpy from a seed and go through the JAX package (the reference) and
through ``wisp_tpu_torch`` on the CPU, where every kernel wrapper takes its plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from wisp_tpu.accelstructs import OctreeAS as JOctreeAS
from wisp_tpu.core import Rays as JRays
from wisp_tpu.models.grids import HashGrid as JHashGrid
from wisp_tpu.models.nefs.nerf import NeuralRadianceField as JNeRF
from wisp_tpu.models.pipeline import Pipeline as JPipeline
from wisp_tpu.tracers import PackedRFTracer as JPackedRFTracer

from wisp_tpu_torch.core.rays import Rays

# tier-1 runs several xdist workers side by side
torch.set_num_threads(2)

NEF_KW = dict(view_embedder="positional", view_multires=4, hidden_dim=32, num_layers=1,
              bias=True, activation_type="relu", layer_type="linear")
GRID_KW = dict(feature_dim=2, num_lods=4, codebook_bitwidth=10, min_grid_res=4,
               max_grid_res=32, multiscale_type="cat")


def carved_occupancy(level: int, seed: int, frac: float = 0.5):
    """Seeded occupancy [8^level] bool and cell densities (-1 where empty)."""
    rng = np.random.default_rng(seed)
    occ = rng.random(8 ** level) < frac
    dens = np.where(occ, rng.random(8 ** level).astype(np.float32) * 3.0, -1.0)
    return occ, dens.astype(np.float32)


def jax_blas(level: int = 3, carve_seed=None):
    blas = JOctreeAS.make_dense(level)
    if carve_seed is not None:
        occ, dens = carved_occupancy(level, carve_seed)
        blas = blas.update_occupancy(jnp.asarray(occ), cell_density=jnp.asarray(dens))
    return blas


def jax_pipeline(carve_seed=None, compaction=0.25, num_steps=32, march_stride=2,
                 feature_std=0.5):
    """The small flagship-shaped JAX pipeline: 4 LODs at bw 10, hidden 32, 32 steps."""
    blas = jax_blas(3, carve_seed)
    grid = JHashGrid.from_geometric(blas=blas, feature_std=feature_std,
                                    dense_lod_matmul=None, key=jax.random.PRNGKey(3),
                                    **GRID_KW)
    nef = JNeRF(grid=grid, key=jax.random.PRNGKey(4), **NEF_KW)
    tracer = JPackedRFTracer(raymarch_type="ray", num_steps=num_steps,
                             bg_color=(1.0, 1.0, 1.0), compaction=compaction,
                             march_stride=march_stride, lod_spacing_scale=1.0)
    return JPipeline(nef=nef, tracer=tracer)


def params_from_jax(pipe):
    """(params, config) of a JAX NeRF pipeline for wisp_tpu_torch.interop.build_pipeline."""
    nef = pipe.nef
    params = {"grid.codebook.feats": np.asarray(nef.grid.codebook.feats)}
    for prefix, dec in (("decoder_density", nef.decoder_density),
                        ("decoder_color", nef.decoder_color)):
        for name, layer in [(f"layers.{i}", l) for i, l in enumerate(dec.layers)] \
                + [("lout", dec.lout)]:
            params[f"{prefix}.{name}.weight"] = np.asarray(layer.weight)
            if layer.bias is not None:
                params[f"{prefix}.{name}.bias"] = np.asarray(layer.bias)
    blas = nef.grid.blas
    params["blas.occ_grid"] = np.asarray(blas.occ_grid)
    params["blas.cell_density"] = np.asarray(blas.cell_density)
    if getattr(nef.grid, "occupancy", None) is not None:
        params["grid.occupancy"] = np.asarray(nef.grid.occupancy)
    if getattr(nef, "prune_streak", None) is not None:
        params["nef.prune_streak"] = np.asarray(nef.prune_streak)
    t = pipe.tracer
    config = {
        "blas_level": blas.max_level,
        "blas_dense": bool(blas.dense),
        "grid": {"resolutions": list(nef.grid.resolutions),
                 "feature_dim": nef.grid.feature_dim,
                 "codebook_bitwidth": nef.grid.codebook_bitwidth,
                 "multiscale_type": nef.grid.multiscale_type},
        "nef": dict(NEF_KW, prune_density_decay=nef.prune_density_decay,
                    prune_min_density=nef.prune_min_density, prune_grace=nef.prune_grace),
        "tracer": {"raymarch_type": t.raymarch_type, "num_steps": t.num_steps,
                   "bg_color": t.bg_color, "compaction": t.compaction,
                   "march_stride": t.march_stride,
                   "lod_spacing_scale": t.lod_spacing_scale},
    }
    return params, config


def ray_arrays(n: int, seed: int = 0):
    """Rays from z=-3 towards the box, with a few that miss it."""
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs[:, 2] = np.abs(dirs[:, 2]) + 1.5
    dirs[: n // 8, 2] = -dirs[: n // 8, 2]          # pointing away: never reach the box
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    origins = np.tile(np.asarray([[0.1, -0.05, -3.0]], np.float32), (n, 1))
    origins += rng.normal(scale=0.3, size=(n, 3)).astype(np.float32)
    return origins, dirs


def both_rays(origins, dirs, dist_min=0.0, dist_max=8.0):
    return (JRays(jnp.asarray(origins), jnp.asarray(dirs), dist_min, dist_max),
            Rays(torch.from_numpy(origins.copy()), torch.from_numpy(dirs.copy()),
                 dist_min, dist_max))


def np_of(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def port_name(path: str) -> str:
    """A JAX pytree path ('.nef.decoder_color.layers[0].bias') as the port's parameter
    name ('nef.decoder_color.layers.0.bias')."""
    return path.lstrip(".").replace("[", ".").replace("]", "")


def sdf_params_from_jax(pipe):
    """(params, config) of a JAX NGLOD pipeline (sparse OctreeAS, OctreeGrid, NeuralSDF,
    PackedSDFTracer) for wisp_tpu_torch.interop.build_sdf_pipeline."""
    nef, grid = pipe.nef, pipe.nef.grid
    blas = grid.blas
    params = {f"blas.codes.{l}": np.asarray(c).astype(np.uint64)
              for l, c in enumerate(blas.codes)}
    for i, feats in enumerate(grid.features):
        params[f"grid.features.{i}"] = np.asarray(feats)
    dec = nef.decoder
    for name, layer in [(f"layers.{i}", l) for i, l in enumerate(dec.layers)] \
            + [("lout", dec.lout)]:
        params[f"decoder.{name}.weight"] = np.asarray(layer.weight)
        params[f"decoder.{name}.bias"] = np.asarray(layer.bias)
    t = pipe.tracer
    config = {
        "blas_level": blas.max_level,
        "grid": {"feature_dim": grid.feature_dim, "num_lods": grid.num_lods,
                 "interpolation_type": grid.interpolation_type,
                 "multiscale_type": grid.multiscale_type},
        "nef": {"pos_embedder": nef.pos_embedder_type,
                "position_input": nef.pos_embed_dim == 3 and nef.pos_embedder_type == "none",
                "activation_type": nef.activation_type, "layer_type": nef.layer_type,
                "hidden_dim": nef.hidden_dim, "num_layers": nef.num_layers},
        "tracer": {"num_steps": t.num_steps, "step_size": t.step_size, "min_dis": t.min_dis},
    }
    return params, config


def sphere_octree_points(level: int, num_samples: int = 200_000, radius: float = 1.0):
    """Quantized surface samples of the normalized icosphere (main_nglod.py:61-66)."""
    from wisp_tpu.ops.mesh import make_sphere_mesh, normalize, sample_surface
    from wisp_tpu.ops.spc.core import quantize_points
    v, f = make_sphere_mesh(radius=radius, subdivisions=3)
    v, f = normalize(v, f, "sphere")
    return quantize_points(sample_surface(v, f, num_samples), level)


def jax_sdf_pipeline(level=5, num_lods=3, hidden_dim=32, feature_dim=16,
                     multiscale_type="sum", num_steps=32, decoder=None, seed=0,
                     num_samples=50_000):
    """A small NGLOD pipeline on the sphere octree (the nglod_octree.yaml shape at a small
    size). ``decoder``: numpy weights to set (``interop.sphere_sdf_decoder``'s keys)."""
    from wisp_tpu.accelstructs import OctreeAS as JAS
    from wisp_tpu.models.grids import OctreeGrid as JOctreeGrid
    from wisp_tpu.models.nefs.neural_sdf import NeuralSDF as JNeuralSDF
    from wisp_tpu.tracers.packed_sdf_tracer import PackedSDFTracer as JSDFTracer
    blas = JAS.from_quantized_points(sphere_octree_points(level, num_samples), level)
    grid = JOctreeGrid(blas=blas, feature_dim=feature_dim, num_lods=num_lods,
                       interpolation_type="linear", multiscale_type=multiscale_type,
                       feature_std=0.01, key=jax.random.PRNGKey(seed))
    nef = JNeuralSDF(grid=grid, pos_embedder="none", position_input=True,
                     activation_type="relu", hidden_dim=hidden_dim, num_layers=1,
                     key=jax.random.PRNGKey(seed + 1))
    if decoder is not None:
        layers = [nef.decoder.layers[0].replace(weight=jnp.asarray(decoder["decoder.layers.0.weight"]),
                                                bias=jnp.asarray(decoder["decoder.layers.0.bias"]))]
        lout = nef.decoder.lout.replace(weight=jnp.asarray(decoder["decoder.lout.weight"]),
                                        bias=jnp.asarray(decoder["decoder.lout.bias"]))
        nef = nef.replace(decoder=nef.decoder.replace(layers=layers, lout=lout))
    tracer = JSDFTracer(num_steps=num_steps, step_size=0.8, min_dis=3e-4)
    return JPipeline(nef=nef, tracer=tracer)
