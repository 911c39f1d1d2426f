"""Anchor generation (mmdet AnchorGenerator semantics).

Port of the JAX package's ``ops/anchors.py``: anchors centred on grid
points (center_offset 0), flattened location-major then anchor-index,
with anchor index = ratio_idx * len(scales) + scale_idx — the conv-channel
layout of the RPN heads. Built in numpy float32 exactly as the reference
builds them, then moved to the requested device.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np
import torch


@lru_cache(maxsize=64)
def _grid_anchors_np(
    feat_h: int,
    feat_w: int,
    stride: int,
    scales: Tuple[float, ...],
    ratios: Tuple[float, ...],
) -> np.ndarray:
    scales_np = np.asarray(scales, dtype=np.float32)
    ratios_np = np.asarray(ratios, dtype=np.float32)
    h_ratios = np.sqrt(ratios_np)
    w_ratios = 1.0 / h_ratios
    ws = (stride * w_ratios[:, None] * scales_np[None, :]).reshape(-1)
    hs = (stride * h_ratios[:, None] * scales_np[None, :]).reshape(-1)
    base = np.stack([-0.5 * ws, -0.5 * hs, 0.5 * ws, 0.5 * hs], axis=-1)
    shift_x = np.arange(feat_w, dtype=np.float32) * stride
    shift_y = np.arange(feat_h, dtype=np.float32) * stride
    sx, sy = np.meshgrid(shift_x, shift_y)  # (H, W)
    shifts = np.stack([sx, sy, sx, sy], axis=-1)  # (H, W, 4)
    anchors = shifts[:, :, None, :] + base[None, None, :, :]
    anchors = anchors.reshape(-1, 4).astype(np.float32)
    anchors.setflags(write=False)
    return anchors


def generate_anchors(
    feat_h: int,
    feat_w: int,
    stride: int = 16,
    scales: Sequence[float] = (2, 4, 8, 16, 32),
    ratios: Sequence[float] = (0.5, 1.0, 2.0),
    device="cpu",
) -> torch.Tensor:
    """All XYXY anchors of a single-level (feat_h, feat_w) map, base size
    = stride: (feat_h * feat_w * A, 4) float32, A = len(scales) *
    len(ratios)."""
    a = _grid_anchors_np(
        int(feat_h), int(feat_w), int(stride),
        tuple(float(s) for s in scales), tuple(float(r) for r in ratios),
    )
    return torch.tensor(a, device=device)


def anchor_inside_flags(anchors, img_h, img_w, allowed_border: int = 0):
    """Valid-anchor mask (mmdet ``anchor_inside_flags``): anchors whose
    corners lie inside the image expanded by ``allowed_border``."""
    if allowed_border < 0:
        return torch.ones(anchors.shape[:-1], dtype=torch.bool,
                          device=anchors.device)
    return (
        (anchors[..., 0] >= -allowed_border)
        & (anchors[..., 1] >= -allowed_border)
        & (anchors[..., 2] < img_w + allowed_border)
        & (anchors[..., 3] < img_h + allowed_border)
    )
