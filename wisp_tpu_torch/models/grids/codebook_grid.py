"""CodebookOctreeGrid — the VQAD variable-bitrate grid (counterpart of
wisp_tpu/models/grids/codebook_grid.py): the octree grid's dual vertices hold logits over a
small dictionary a LOD instead of features.

``features[i]`` are the logits [V_i, 2^bw] of active LOD i and ``dictionary[i]`` its
[2^bw, F] entries, both feature_std * N(0, 1) (no bias), drawn dictionary then logits a LOD
from one generator. Every interpolation first resolves each LOD's table E [V_i, F] once a
call (K19, ``ops/codebook.py codebook_resolve``) in one of JAX's three modes:

* training (``self.training``, the default): the straight-through lookup, E = c * D[a] with
  a the argmax of softmax(logits) and c = (1 - s_a) + s_a; gradients reach the logits
  through the softmax and the dictionary through its chosen rows;
* eval (``eval()``, torch's own switch of ``training``): E = D[argmax(logits)];
* baked (``bake()``): the logits collapse, in place, to their argmax as float indices
  [V_i] that no longer train; E = D[index].

``OctreeGrid``'s 'linear' fused query (``octree_query_interp``) and 'closest' gather then
read E where an octree grid reads its features (``feature_tables``). E lives in a buffer
the grid owns, so the fused query's table cache keeps its entry from call to call.

``freeze()`` stops nothing, as in JAX: the lookup there never reads ``frozen`` (a fault of
the reference kept for parity, ROADMAP Queue 3).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
from torch import nn

from wisp_tpu_torch.device import DeviceLike
from wisp_tpu_torch.models.grids.octree_grid import OctreeGrid
from wisp_tpu_torch.ops.codebook import codebook_resolve
from wisp_tpu_torch.ops.spc.core import make_dual


class CodebookOctreeGrid(OctreeGrid):
    def __init__(self, blas=None, feature_dim: int = 16, num_lods: int = 1,
                 interpolation_type: str = "linear", multiscale_type: str = "cat",
                 feature_std: float = 0.0, feature_bias: float = 0.0,
                 codebook_bitwidth: int = 8, generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        self.bitwidth = codebook_bitwidth
        self.dictionary_size = 2 ** codebook_bitwidth
        self.baked = False
        self._resolved = None  # the flat buffer of the resolved tables E
        super().__init__(blas=blas, feature_dim=feature_dim, num_lods=num_lods,
                         interpolation_type=interpolation_type,
                         multiscale_type=multiscale_type, feature_std=feature_std,
                         feature_bias=feature_bias, generator=generator, device=device)

    def init_feature_structure(self, generator: Optional[torch.Generator] = None) -> None:
        """The dual octree's trinkets ('linear'), and a dictionary [2^bw, F] and logits
        [V_i, 2^bw] a LOD: feature_std * N(0, 1)."""
        points = [np.asarray(p) for p in self.blas.points]
        if self.interpolation_type == "linear":
            dual_points, trinkets = make_dual(points)
            self.trinkets = [torch.from_numpy(trinkets[lod]).to(self.device)
                             for lod in self.active_lods]
            counts = [dual_points[lod].shape[0] for lod in self.active_lods]
        else:  # 'closest': logits a cell
            counts = [points[lod].shape[0] for lod in self.active_lods]
        self.num_feat = sum(counts)
        dictionary, features = [], []
        for n in counts:
            for table, shape in ((dictionary, (self.dictionary_size, self.feature_dim)),
                                 (features, (n, self.dictionary_size))):
                table.append(nn.Parameter((self.feature_std * torch.randn(
                    shape, generator=generator)).to(self.device)))
        self.dictionary = nn.ParameterList(dictionary)
        self.features = nn.ParameterList(features)

    @property
    def mode(self) -> str:
        """The lookup's mode: 'baked', else 'train' or 'eval' by ``training``."""
        return "baked" if self.baked else ("train" if self.training else "eval")

    def feature_tables(self, n: int) -> List[torch.Tensor]:
        """LODs 0..n-1's resolved tables E [V_i, F] (K19), views of the grid's buffer."""
        tables, _ = codebook_resolve(list(self.features)[:n], list(self.dictionary)[:n],
                                     self.mode, self._buffer(n))
        return tables

    def _buffer(self, n: int) -> torch.Tensor:
        """The first sum V_i x F values of the grid's buffer of E, made at first use for
        every LOD (and anew if the grid moved)."""
        rows = [f.shape[0] for f in self.features]
        device = self.dictionary[0].device
        if self._resolved is None or self._resolved.device != device:
            self._resolved = torch.empty((sum(rows) * self.feature_dim,),
                                         dtype=torch.float32, device=device)
        return self._resolved[:sum(rows[:n]) * self.feature_dim]

    def freeze(self) -> "CodebookOctreeGrid":
        """Marks the grid frozen and stops nothing, as JAX's (see the module docstring)."""
        self.frozen = True
        return self

    def bake(self) -> "CodebookOctreeGrid":
        """Collapse each LOD's logits to their argmax, as float indices [V_i] that no longer
        train (in place; returns the grid)."""
        self.features = nn.ParameterList([
            nn.Parameter(torch.argmax(f.detach(), dim=-1).to(torch.float32),
                         requires_grad=False) for f in self.features])
        self.baked = True
        return self

    def __getstate__(self):
        state = dict(super().__getstate__())
        state["_resolved"] = None  # scratch: a saved grid does not carry it
        return state
