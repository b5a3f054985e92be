"""The codebook lookup of a VQAD grid (K19): each dual vertex's feature row, resolved once
a vertex from its logits over a per-LOD dictionary (counterpart of
wisp_tpu/models/grids/codebook_grid.py ``_index_features`` :71, inside
``OctreeGrid._interpolate``, wisp_tpu/models/grids/octree_grid.py:96).

JAX computes the lookup on every (sample, corner) row: in training the straight-through
keys ``one_hot(argmax(s)) - stop_gradient(s) + s`` (s = softmax(logits)) times the
dictionary; in eval the dictionary row of the logits' argmax; baked, the row of the stored
index. Each depends on the vertex alone, and the keys are exactly 0 off the argmax a
((0 - s) + s = 0), so the training row is c * D[a] with c = (1 - s_a) + s_a, 1 only up to
rounding. So the port resolves a table E [V_l, F] a LOD once a call, and the octree grid's
fused query interpolates it as it interpolates an ``OctreeGrid``'s features.

* ``codebook_resolve_plain``: s as ``jax.nn.softmax`` computes it (exp(x - max) over its
  sum), a the first argmax of s (not of the logits: two logits may round to one s), c and
  E; eval and baked modes; the indices a [V_l] int32 beside E.
* ``codebook_resolve_bwd_plain``: d logits = s * (g - <s, g>) with g = dE D^T, and
  d D[a] += c dE (eval and baked: the dictionary's gradient alone, c = 1). By linearity
  this sums JAX's per-corner terms.
* ``codebook_resolve``: the entry point over LODs 0..n-1, writing E into a buffer the caller
  owns (so the fused query's table cache keeps its entry); on the card K19's forward
  (``csrc/codebook.cu``, one launch for every LOD), differentiable through
  ``_CodebookResolveFn`` whose backward is K19's backward (one launch). On the CPU the same
  ``autograd.Function`` runs the plain versions. A bitwidth above 8 raises on the card.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from wisp_tpu_torch import kernels

MAX_LODS = 16      # LOD slots in the kernels' argument block (csrc/codebook.cu kMaxLods)
MAX_BITWIDTH = 8   # the kernels' logits a vertex: 2^8, 8 a lane of a warp
MODES = ("train", "eval", "baked")
# the dictionary gradients a block sums in shared memory before it adds them to the
# tables; above this the backward adds each vertex's row straight to them
BWD_SHARED_BYTES = 48 * 1024


def softmax_plain(logits: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis: exp(x - max) divided by its sum."""
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def codebook_resolve_plain(logits: torch.Tensor, dictionary: torch.Tensor, mode: str
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LOD: (E [V, F] float32, a [V] int32) of logits [V, K] ('train', 'eval') or float
    indices [V] ('baked', truncated as JAX's astype, clamped to the dictionary) over the
    dictionary [K, F]."""
    k = dictionary.shape[0]
    if mode == "baked":
        arg = logits.to(torch.int32).clamp(0, k - 1)
        return dictionary[arg.long()], arg
    if mode == "eval":
        arg = torch.argmax(logits, dim=-1)
        return dictionary[arg], arg.to(torch.int32)
    s = softmax_plain(logits)
    arg = torch.argmax(s, dim=-1)
    sa = s.gather(-1, arg[:, None])
    return ((1.0 - sa) + sa) * dictionary[arg], arg.to(torch.int32)


def codebook_resolve_bwd_plain(logits: torch.Tensor, dictionary: torch.Tensor,
                               arg: torch.Tensor, mode: str, grad_e: torch.Tensor
                               ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """One LOD's (d logits or None, d dictionary) for the cotangent ``grad_e`` [V, F]."""
    a = arg.long()
    if mode != "train":
        return None, torch.zeros_like(dictionary).index_add_(0, a, grad_e)
    s = softmax_plain(logits)
    sa = s.gather(-1, a[:, None])
    g = grad_e @ dictionary.T
    d_logits = s * (g - (s * g).sum(dim=-1, keepdim=True))
    d_dict = torch.zeros_like(dictionary).index_add_(0, a, ((1.0 - sa) + sa) * grad_e)
    return d_logits, d_dict


class _Lods(ctypes.Structure):
    """The LODs' tables as ``csrc/codebook.cu``'s ``Lods``."""
    _fields_ = [("logits", ctypes.c_void_p * MAX_LODS), ("dict", ctypes.c_void_p * MAX_LODS),
                ("grad_e", ctypes.c_void_p * MAX_LODS), ("out", ctypes.c_void_p * MAX_LODS),
                ("d_dict", ctypes.c_void_p * MAX_LODS), ("arg", ctypes.c_void_p * MAX_LODS),
                ("start", ctypes.c_longlong * (MAX_LODS + 1))]


def _geometry(logits, dictionaries, mode):
    """(K, F, the vertex counts), checked for the kernels."""
    n = len(logits)
    if mode not in MODES or not 1 <= n <= MAX_LODS or len(dictionaries) != n:
        raise ValueError(f"codebook_resolve: mode {mode!r} over {n} LODs")
    k, f_dim = dictionaries[0].shape
    bits = k.bit_length() - 1
    if k != 1 << bits or bits > MAX_BITWIDTH:
        raise NotImplementedError(f"codebook_resolve: a dictionary of {k} rows; the kernel "
                                  f"takes 2^1..2^{MAX_BITWIDTH} (ROADMAP Queue 3)")
    rows = []
    for i, (lg, d) in enumerate(zip(logits, dictionaries)):
        kernels.check(d, f"dictionaries[{i}]", torch.float32, (k, f_dim))
        kernels.check(lg, f"logits[{i}]", torch.float32,
                      (lg.shape[0],) if mode == "baked" else (lg.shape[0], k))
        rows.append(lg.shape[0])
    return k, f_dim, rows


def resolve_buffer(rows: Sequence[int], f_dim: int, buffer: Optional[torch.Tensor],
                   device: torch.device) -> torch.Tensor:
    """A flat float32 buffer of sum(rows) x F values on ``device`` (a tensor's own):
    ``buffer`` where it is that, else a new one."""
    size = sum(rows) * f_dim
    if buffer is None or buffer.numel() != size or buffer.device != device:
        buffer = torch.empty((size,), dtype=torch.float32, device=device)
    return buffer


def _views(flat: torch.Tensor, rows: Sequence[int], width: int) -> List[torch.Tensor]:
    return [t.view(v, width) if width else t for t, v in
            zip(torch.split(flat, [v * max(width, 1) for v in rows]), rows)]


def _resolve(logits, dictionaries, mode, buffer):
    """(E tables [V_l, F], views of ``buffer``; the indices [sum V_l] int32)."""
    device = dictionaries[0].device
    rows = [lg.shape[0] for lg in logits]
    f_dim = dictionaries[0].shape[1]
    e = _views(buffer, rows, f_dim)
    arg = torch.empty((sum(rows),), dtype=torch.int32, device=device)
    if not dictionaries[0].is_cuda:
        for lg, d, out, a in zip(logits, dictionaries, e, _views(arg, rows, 0)):
            got, got_arg = codebook_resolve_plain(lg, d, mode)
            out.copy_(got)
            a.copy_(got_arg)
        return e, arg
    k, f_dim, rows = _geometry(logits, dictionaries, mode)
    if sum(rows):
        lods = _Lods()
        start = 0
        for i, (lg, d, out, a) in enumerate(zip(logits, dictionaries, e,
                                                 _views(arg, rows, 0))):
            lods.logits[i], lods.dict[i] = lg.data_ptr(), d.data_ptr()
            lods.out[i], lods.arg[i] = out.data_ptr(), a.data_ptr()
            lods.start[i] = start
            start += rows[i]
        lods.start[len(rows)] = start
        kernels.launch("wisp_codebook_resolve", "codebook_resolve", len(rows), k, f_dim,
                       MODES.index(mode), ctypes.addressof(lods))
    return e, arg


def codebook_resolve_bwd(logits: Sequence[torch.Tensor], dictionaries: Sequence[torch.Tensor],
                         arg: torch.Tensor, mode: str, grad_e: Sequence[torch.Tensor]
                         ) -> Tuple[List[Optional[torch.Tensor]], List[torch.Tensor]]:
    """K19's backward over the LODs: (d logits a LOD, None in eval and baked modes; d
    dictionary a LOD) for the cotangents ``grad_e`` [V_l, F] and the forward's indices
    ``arg`` [sum V_l] int32. On the card one launch; the dictionary gradients (views of one
    zeroed buffer) take atomic adds in no fixed order."""
    rows = [lg.shape[0] for lg in logits]
    args = _views(arg, rows, 0)
    if not dictionaries[0].is_cuda:
        out = [codebook_resolve_bwd_plain(lg, d, a, mode, g)
               for lg, d, a, g in zip(logits, dictionaries, args, grad_e)]
        return [o[0] for o in out], [o[1] for o in out]
    k, f_dim, rows = _geometry(logits, dictionaries, mode)
    device = dictionaries[0].device
    d_dict = _views(torch.zeros((len(rows) * k * f_dim,), dtype=torch.float32,
                                device=device), [k] * len(rows), f_dim)
    d_logits = ([torch.empty((v, k), dtype=torch.float32, device=device) for v in rows]
                if mode == "train" else [None] * len(rows))
    if sum(rows):
        lods = _Lods()
        start = 0
        for i in range(len(rows)):
            kernels.check(grad_e[i], f"grad_e[{i}]", torch.float32, (rows[i], f_dim))
            lods.logits[i], lods.dict[i] = logits[i].data_ptr(), dictionaries[i].data_ptr()
            lods.grad_e[i], lods.d_dict[i] = grad_e[i].data_ptr(), d_dict[i].data_ptr()
            lods.arg[i] = args[i].data_ptr()
            lods.out[i] = kernels.ptr(d_logits[i])
            lods.start[i] = start
            start += rows[i]
        lods.start[len(rows)] = start
        shared = int(len(rows) * k * f_dim * 4 <= BWD_SHARED_BYTES)
        kernels.launch("wisp_codebook_bwd", "codebook_bwd", len(rows), k, f_dim,
                       MODES.index(mode), shared, ctypes.addressof(lods))
    return d_logits, d_dict


class _CodebookResolveFn(torch.autograd.Function):
    """``_resolve`` with K19's backward: saves the logits, the dictionaries and the indices
    (s and c are recomputed from the logits, as JAX's rematerialized lookup does)."""

    @staticmethod
    def forward(ctx, mode, holder, *tables):
        n = len(tables) // 2
        e, arg = _resolve(tables[:n], tables[n:], mode, holder[0])
        ctx.mode = mode
        ctx.save_for_backward(arg, *tables)
        ctx.mark_non_differentiable(arg)
        return (*e, arg)

    @staticmethod
    def backward(ctx, *grads):
        arg, *tables = ctx.saved_tensors
        n = len(tables) // 2
        grad_e = [g.float().contiguous() for g in grads[:n]]
        d_logits, d_dict = codebook_resolve_bwd(tables[:n], tables[n:], arg, ctx.mode, grad_e)
        need = ctx.needs_input_grad[2:]
        return (None, None) + tuple(g if nd else None
                                    for g, nd in zip(d_logits + d_dict, need))


def codebook_resolve(logits: Sequence[torch.Tensor], dictionaries: Sequence[torch.Tensor],
                     mode: str = "train", buffer: Optional[torch.Tensor] = None
                     ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The resolved feature tables of LODs 0..n-1: (E [V_l, F] float32 a LOD, views of
    ``buffer`` (a flat float32 tensor of sum V_l x F values; see ``resolve_buffer``); the
    indices a [sum V_l] int32). ``logits[i]`` is [V_i, 2^bw] ('train', 'eval') or [V_i]
    float indices ('baked'); ``dictionaries[i]`` is [2^bw, F]. Differentiable in the logits
    (train) and the dictionaries."""
    rows = [lg.shape[0] for lg in logits]
    buffer = resolve_buffer(rows, dictionaries[0].shape[1], buffer, dictionaries[0].device)
    tables = list(logits) + list(dictionaries)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tables):
        # the buffer rides in a list: a tensor argument would be an input, and E its views
        *e, arg = _CodebookResolveFn.apply(mode, [buffer], *tables)
        return e, arg
    return _resolve(logits, dictionaries, mode, buffer)
