"""NeuralRadianceField — density + view-dependent colour field (counterpart of
wisp_tpu/models/nefs/nerf.py: constructor, ``rgba`` and ``prune``).

grid features (+ optional position embedding) -> density decoder (16 outputs; its output
bias[0] starts at 1.0) -> density = relu(channel 0), colour = sigmoid(colour decoder of
channels 1..15 and the view embedding).

``prune`` is instant-ngp's scheme as JAX has it (nerf.py:170-271): decay the keep-score,
re-query the density at one jittered point per cell (K1 forward over all 8^level cells),
max in the training samples' densities, threshold (with a grace streak), and rewrite the
blas's occupancy and density field. JAX is functional and returns a new nef; the port
updates this one in place.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from wisp_tpu_torch.device import DeviceLike, resolve_device
from wisp_tpu_torch.models.activations import get_activation_class
from wisp_tpu_torch.models.decoders.basic_decoders import BasicDecoder
from wisp_tpu_torch.models.embedders.positional_embedder import get_positional_embedder
from wisp_tpu_torch.models.layers import get_layer_class
from wisp_tpu_torch.models.nefs.base_nef import BaseNeuralField


PRUNE_DENSITY_DECAY_DEFAULT = (0.01 * 512) / float(np.sqrt(3))


class _Identity(torch.nn.Module):
    out_dim = 3

    def forward(self, x):
        return x


class NeuralRadianceField(BaseNeuralField):
    def __init__(self, grid=None, pos_embedder: str = "none", view_embedder: str = "none",
                 pos_multires: int = 10, view_multires: int = 4, position_input: bool = False,
                 activation_type: str = "relu", layer_type: str = "linear",
                 hidden_dim: int = 128, num_layers: int = 1, bias: bool = False,
                 prune_density_decay: Optional[float] = PRUNE_DENSITY_DECAY_DEFAULT,
                 prune_min_density: Optional[float] = 0.6, prune_grace: int = 1,
                 generator: Optional[torch.Generator] = None, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.grid = grid
        self.pos_embedder, self.pos_embed_dim = self.init_embedder(
            pos_embedder, pos_multires, position_input, device)
        self.view_embedder, self.view_embed_dim = self.init_embedder(
            view_embedder, view_multires, True, device)
        layer = get_layer_class(layer_type.replace("_norm", ""))
        activation = get_activation_class(activation_type)
        self.decoder_density = BasicDecoder(
            input_dim=self.density_net_input_dim(), output_dim=16, activation=activation,
            bias=bias, layer=layer, num_layers=num_layers, hidden_dim=hidden_dim, skip=[],
            generator=generator, device=device)
        if self.decoder_density.lout.bias is not None:
            with torch.no_grad():
                self.decoder_density.lout.bias[0] = 1.0  # density head starts at 1.0
        self.decoder_color = BasicDecoder(
            input_dim=self.color_net_input_dim(), output_dim=3, activation=activation,
            bias=bias, layer=layer, num_layers=num_layers + 1, hidden_dim=hidden_dim,
            skip=[], generator=generator, device=device)
        self.prune_density_decay = prune_density_decay
        self.prune_min_density = prune_min_density
        # a below-threshold cell is culled only after prune_grace consecutive prunes
        self.prune_grace = int(prune_grace)
        streak = None
        if self.prune_grace > 1 and getattr(grid, "occupancy", None) is not None:
            streak = torch.zeros(grid.occupancy.shape, dtype=torch.int32, device=device)
        self.register_buffer("prune_streak", streak)

    @staticmethod
    def init_embedder(embedder_type: str, frequencies: int, include_input: bool, device):
        if embedder_type == "none" and not include_input:
            return None, 0
        if embedder_type == "identity" or (embedder_type == "none" and include_input):
            return _Identity(), 3
        if embedder_type == "positional":
            return get_positional_embedder(frequencies=frequencies,
                                           include_input=include_input, device=device)
        raise NotImplementedError(f"Unsupported embedder type: {embedder_type}")

    def register_forward_functions(self):
        self._register_forward_function(self.rgba, ["density", "rgb"])

    def rgba(self, coords, ray_d, lod_idx=None, max_compute_lod=None, stoch_rows=None):
        """[N,3] coords + [N,3] view dirs -> {'rgb': [N,3], 'density': [N,1]}.
        ``stoch_rows``: the rows of the JAX call (the tracer's budget), which a hash grid's
        stochastic backward rule reads."""
        if lod_idx is None:
            lod_idx = len(self.grid.active_lods) - 1
        batch = coords.shape[0]
        kwargs = {}
        # only grids that can cap their computed LODs take the cap (nerf.py:135-140)
        if max_compute_lod is not None and getattr(self.grid, "SUPPORTS_COMPUTE_CAP", False):
            kwargs["max_compute_lod"] = max_compute_lod
        if stoch_rows is not None and getattr(self.grid, "stoch_grad", False):
            kwargs["stoch_rows"] = stoch_rows
        feats = self.grid.interpolate(coords, lod_idx, **kwargs)
        feats = feats.reshape(batch, self.effective_feature_dim())
        if self.pos_embedder is not None:
            pos = self.pos_embedder(coords).reshape(batch, self.pos_embed_dim)
            feats = torch.cat([feats, pos], dim=-1)
        density_feats = self.decoder_density(feats)
        if self.view_embedder is not None:
            fdir = torch.cat([density_feats,
                              self.view_embedder(ray_d).reshape(batch, self.view_embed_dim)],
                             dim=-1)
        else:
            fdir = density_feats
        colors = torch.sigmoid(self.decoder_color(fdir[..., 1:]))
        density = torch.relu(density_feats[..., 0:1])
        return {"rgb": colors, "density": density}

    def effective_feature_dim(self) -> int:
        if self.grid.multiscale_type == "cat":
            return self.grid.feature_dim * self.grid.num_lods
        return self.grid.feature_dim

    def density_net_input_dim(self) -> int:
        return self.effective_feature_dim() + self.pos_embed_dim

    def color_net_input_dim(self) -> int:
        return 15 + self.view_embed_dim

    @torch.no_grad()
    def prune(self, sample_max: Optional[torch.Tensor] = None,
              jitter: Optional[torch.Tensor] = None, views: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None) -> None:
        """One pruning step, in place. ``sample_max`` [8^level]: the per-cell max of the
        training samples' densities since the last prune (the tracer's density_feedback).
        ``jitter`` [cells, 3] in [0, 1) and ``views`` [cells, 3] unit vectors are the random
        query point in each cell and its view direction; each is drawn from ``generator``
        when not given (JAX draws them from its key; the parity tests pass JAX's)."""
        grid = self.grid
        if self.prune_density_decay is None or self.prune_min_density is None \
                or grid is None or getattr(grid, "occupancy", None) is None:
            return
        blas = grid.blas
        level = blas.max_level
        res = 2 ** level
        num_cells = grid.occupancy.shape[0]
        dev = grid.occupancy.device
        occupancy = grid.occupancy * self.prune_density_decay
        # every cell of the dense domain, row-major: cell id == (x*res + y)*res + z
        cell = torch.arange(num_cells, device=dev)
        points = torch.stack([cell // (res * res), (cell // res) % res, cell % res],
                             dim=-1).to(torch.float32)
        if jitter is None:
            jitter = torch.rand((num_cells, 3), generator=generator, device=dev)
        if views is None:
            views = torch.randn((num_cells, 3), generator=generator, device=dev)
            views = views / torch.linalg.norm(views, dim=-1, keepdim=True)
        samples = (points + jitter.to(dev)) / res * 2.0 - 1.0
        density = self.forward(channels="density", coords=samples.contiguous(),
                               ray_d=views.to(dev).contiguous())[:, 0].float()
        occupancy = torch.maximum(density, occupancy)
        if sample_max is not None:
            occupancy = torch.maximum(occupancy, sample_max)
        below = occupancy <= self.prune_min_density
        streak = self.prune_streak
        if self.prune_grace > 1 and streak is not None:
            streak = torch.where(below, streak + 1, torch.zeros_like(streak))
            keep = streak < self.prune_grace
        else:
            keep = ~below
        # density estimate: a decayed running max of the fresh queries (not the keep-score,
        # whose decay factor is above 1)
        prev = blas.cell_density.clamp(min=0.0)
        dens_est = torch.maximum(density, 0.95 * prev)
        dens_field = torch.where(keep, dens_est, torch.full_like(dens_est, -1.0))
        grid.blas = blas.update_occupancy(keep, cell_density=dens_field)
        grid.occupancy = occupancy
        if streak is not None:
            self.prune_streak = streak.to(torch.int32)
