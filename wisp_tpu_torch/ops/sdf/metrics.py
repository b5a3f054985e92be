"""SDF validation metrics (counterpart of wisp_tpu/ops/sdf/metrics.py)."""

from __future__ import annotations

import numpy as np
import torch


def _inside(sdf) -> np.ndarray:
    if isinstance(sdf, torch.Tensor):
        sdf = sdf.detach().cpu().numpy()
    return np.asarray(sdf).reshape(-1) < 0


def compute_sdf_iou(pred_sdf, gt_sdf) -> float:
    """IoU of the inside (sdf < 0) sets of two equally long samples (tensors or arrays)."""
    pred_inside, gt_inside = _inside(pred_sdf), _inside(gt_sdf)
    inter = np.logical_and(pred_inside, gt_inside).sum()
    union = np.logical_or(pred_inside, gt_inside).sum()
    return float(inter) / max(float(union), 1.0)


def compute_sparse_sdf_iou(nef_sdf_fn, coords: torch.Tensor, gt_sdf) -> float:
    """IoU of the field ``nef_sdf_fn`` queried at ``coords`` against ``gt_sdf``."""
    with torch.no_grad():
        pred = nef_sdf_fn(coords)
    return compute_sdf_iou(pred, gt_sdf)
