"""Box primitives: area, IoU and the DeltaXYWH box coder.

Port of the JAX package's ``ops/boxes.py``. Boxes are XYXY; widths and heights are
``x2 - x1`` with no +1 (mmdet 2.x convention).
"""

from __future__ import annotations

import numpy as np
import torch

_DEFAULT_MEANS = (0.0, 0.0, 0.0, 0.0)
_DEFAULT_STDS = (1.0, 1.0, 1.0, 1.0)


def xyxy_to_yxyx(boxes: np.ndarray) -> np.ndarray:
    """(…, 4) XYXY → YXYX on host arrays (the evaluator's results keep the
    datasets' YXYX order)."""
    return np.asarray(boxes)[..., (1, 0, 3, 2)]


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of (…, 4) XYXY boxes."""
    return (boxes[..., 2] - boxes[..., 0]).clamp(min=0) * (
        boxes[..., 3] - boxes[..., 1]
    ).clamp(min=0)


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor):
    """Pairwise IoU: (..., M, 4) × (..., N, 4) → (..., M, N); the union
    is clamped at 1e-9."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return inter / union.clamp(min=1e-9)


def delta_encode(proposals, gt, means=_DEFAULT_MEANS, stds=_DEFAULT_STDS):
    """XYXY proposals + XYXY gt → normalized (dx, dy, dw, dh) targets."""
    pw = proposals[..., 2] - proposals[..., 0]
    ph = proposals[..., 3] - proposals[..., 1]
    px = proposals[..., 0] + 0.5 * pw
    py = proposals[..., 1] + 0.5 * ph

    gw = gt[..., 2] - gt[..., 0]
    gh = gt[..., 3] - gt[..., 1]
    gx = gt[..., 0] + 0.5 * gw
    gy = gt[..., 1] + 0.5 * gh

    eps = 1e-6
    pw = pw.clamp(min=eps)
    ph = ph.clamp(min=eps)
    dx = (gx - px) / pw
    dy = (gy - py) / ph
    dw = torch.log(gw.clamp(min=eps) / pw)
    dh = torch.log(gh.clamp(min=eps) / ph)
    deltas = torch.stack([dx, dy, dw, dh], dim=-1)
    means = deltas.new_tensor(means)
    stds = deltas.new_tensor(stds)
    return (deltas - means) / stds


def delta_decode(
    proposals,
    deltas,
    means=_DEFAULT_MEANS,
    stds=_DEFAULT_STDS,
    max_shape=None,
    wh_ratio_clip: float = 16.0 / 1000.0,
):
    """Normalized deltas → XYXY boxes, optionally clipped to ``max_shape``.

    ``max_shape`` is ``(h, w)``: two numbers, or two tensors that broadcast
    against the boxes' leading dimensions (per-image sizes)."""
    d = deltas * deltas.new_tensor(stds) + deltas.new_tensor(means)
    # f32 rounding of |log(clip)|, as the reference computes it in f32
    max_ratio = float(torch.tensor(wh_ratio_clip, dtype=torch.float32).log().abs())
    dx, dy = d[..., 0], d[..., 1]
    dw = d[..., 2].clamp(-max_ratio, max_ratio)
    dh = d[..., 3].clamp(-max_ratio, max_ratio)

    pw = proposals[..., 2] - proposals[..., 0]
    ph = proposals[..., 3] - proposals[..., 1]
    px = proposals[..., 0] + 0.5 * pw
    py = proposals[..., 1] + 0.5 * ph

    gw = pw * torch.exp(dw)
    gh = ph * torch.exp(dh)
    gx = px + pw * dx
    gy = py + ph * dy

    x1 = gx - 0.5 * gw
    y1 = gy - 0.5 * gh
    x2 = gx + 0.5 * gw
    y2 = gy + 0.5 * gh
    if max_shape is not None:
        h, w = (torch.as_tensor(v, dtype=x1.dtype, device=x1.device)
                for v in max_shape)
        zero = torch.zeros((), dtype=x1.dtype, device=x1.device)
        x1 = torch.minimum(torch.maximum(x1, zero), w)
        y1 = torch.minimum(torch.maximum(y1, zero), h)
        x2 = torch.minimum(torch.maximum(x2, zero), w)
        y2 = torch.minimum(torch.maximum(y2, zero), h)
    return torch.stack([x1, y1, x2, y2], dim=-1)

