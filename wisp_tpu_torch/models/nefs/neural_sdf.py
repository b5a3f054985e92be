"""NeuralSDF — neural signed distance field, NGLOD (counterpart of
wisp_tpu/models/nefs/neural_sdf.py ``NeuralSDF``): grid features, then the optional position
embedding, into a one-output BasicDecoder. ``position_input`` with the 'none' embedder
appends the raw xyz after the features."""

from __future__ import annotations

from typing import Optional

import torch

from wisp_tpu_torch.device import DeviceLike, resolve_device
from wisp_tpu_torch.models.activations import get_activation_class
from wisp_tpu_torch.models.decoders.basic_decoders import BasicDecoder
from wisp_tpu_torch.models.embedders.positional_embedder import get_positional_embedder
from wisp_tpu_torch.models.layers import get_layer_class
from wisp_tpu_torch.models.nefs.base_nef import BaseNeuralField


class _Identity(torch.nn.Module):
    def forward(self, x):
        return x


class NeuralSDF(BaseNeuralField):
    def __init__(self, grid=None, pos_embedder: str = "none", pos_multires: int = 4,
                 position_input: bool = False, activation_type: str = "relu",
                 layer_type: str = "linear", hidden_dim: int = 128, num_layers: int = 1,
                 generator: Optional[torch.Generator] = None, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.grid = grid
        self.pos_embedder_type = pos_embedder
        self.pos_embedder, self.pos_embed_dim = self.init_embedder(
            pos_embedder, pos_multires, position_input, device)
        self.decoder = BasicDecoder(
            input_dim=self.effective_feature_dim() + self.pos_embed_dim, output_dim=1,
            activation=get_activation_class(activation_type), bias=True,
            layer=get_layer_class(layer_type.replace("_norm", "")), num_layers=num_layers,
            hidden_dim=hidden_dim, skip=[], generator=generator, device=device)

    @staticmethod
    def init_embedder(embedder_type: str, frequencies: int, include_input: bool, device):
        if embedder_type == "none" and not include_input:
            return None, 0
        if embedder_type == "identity" or (embedder_type == "none" and include_input):
            return _Identity(), 3
        if embedder_type == "positional":
            return get_positional_embedder(frequencies=frequencies,
                                           include_input=include_input, device=device)
        raise NotImplementedError(embedder_type)

    def effective_feature_dim(self) -> int:
        if self.grid.multiscale_type == "cat":
            return self.grid.feature_dim * self.grid.num_lods
        return self.grid.feature_dim

    def register_forward_functions(self):
        self._register_forward_function(self.sdf, ["sdf"])

    def sdf(self, coords: torch.Tensor, lod_idx: Optional[int] = None) -> torch.Tensor:
        """[N, 3] -> signed distance [N, 1]."""
        if lod_idx is None:
            lod_idx = self.grid.num_lods - 1
        batch = coords.shape[0]
        feats = self.grid.interpolate(coords, lod_idx)      # [N, width]
        if self.pos_embedder is not None:
            feats = torch.cat([feats, self.pos_embedder(coords).reshape(batch,
                                                                        self.pos_embed_dim)],
                              dim=-1)
        return self.decoder(feats)
