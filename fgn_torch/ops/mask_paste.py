"""Paste per-detection mask logits into full-image masks.

Port of the JAX package's ``ops/mask_paste.py`` (mmdet
``FCNMaskHead.get_seg_masks`` / ``_do_paste_mask``; reference
subprojects/sp02_omniiseg_fgn_mmdet/fgn_roi_head.py:668-671).

Bilinear paste is separable, so the whole op is two small matmuls per
detection: out[n, y, x] = sum_ij Ry[n, y, i] * m[n, i, j] * Rx[n, x, j],
with hat-function weight matrices built from the detection box. Matches
grid_sample(align_corners=False): mask pixel centers sit at
(i + 0.5) / msize of the box extent; outside the box all weights are 0.

``paste_masks`` runs on tensors, on their device, for callers that want
the masks there; the evaluator pastes on the host with ``paste_masks_np``.
"""

from __future__ import annotations

import numpy as np
import torch


def _paste_weights(lo: torch.Tensor, hi: torch.Tensor, size: int, msize: int):
    """Weight matrix (N, size, msize): image axis → mask axis.

    lo/hi: (N,) box extent along this axis (in image pixels)."""
    span = (hi - lo).clamp(min=1e-6)  # (N,)
    img_c = torch.arange(size, dtype=lo.dtype, device=lo.device) + 0.5
    # Continuous mask coordinate of each image pixel center.
    m = (img_c[None, :] - lo[:, None]) / span[:, None] * msize - 0.5
    inside = (img_c[None, :] >= lo[:, None]) & (img_c[None, :] <= hi[:, None])
    mi = torch.arange(msize, dtype=lo.dtype, device=lo.device)
    # Hat weights with edge clamp (replicate border like grid_sample border
    # clamping of out-of-range sample points within the box).
    mc = m.clamp(0.0, msize - 1.0)
    w = (1.0 - (mc[:, :, None] - mi[None, None, :]).abs()).clamp(min=0.0)
    return w * inside[:, :, None]


def paste_masks(
    mask_logits: torch.Tensor,  # (N, msize, msize) — already sigmoid'ed or raw
    boxes: torch.Tensor,  # (N, 4) XYXY in image coords
    img_h: int,
    img_w: int,
    threshold: float | None = 0.5,
) -> torch.Tensor:
    """→ (N, img_h, img_w); bool when threshold is set, else float32."""
    boxes = boxes.to(torch.float32)
    ry = _paste_weights(boxes[:, 1], boxes[:, 3], img_h, mask_logits.shape[1])
    rx = _paste_weights(boxes[:, 0], boxes[:, 2], img_w, mask_logits.shape[2])
    tmp = torch.einsum("nyi,nij->nyj", ry, mask_logits.to(torch.float32))
    out = torch.einsum("nyj,nxj->nyx", tmp, rx)
    if threshold is not None:
        return out > threshold
    return out


# -- numpy twin (host-side paste) -------------------------------------------
#
# The evaluator pastes on the HOST: it fetches the (B, M, 14, 14) mask
# logits, not (B, M, H, W) masks, and only the valid detections need
# pasting (~2 small matmuls each). A copy of the JAX package's numpy paste;
# its numerics are paste_masks's (tests/test_torch_eval_host.py).


def _paste_weights_np(lo: np.ndarray, hi: np.ndarray, size: int, msize: int,
                      start: int = 0, stop: int | None = None):
    """Like _paste_weights, restricted to image pixels [start, stop) —
    weights are a function of absolute pixel coordinates, so a window
    slice equals the corresponding rows of the full matrix."""
    stop = size if stop is None else stop
    span = np.maximum(hi - lo, 1e-6)
    img_c = np.arange(start, stop, dtype=np.float32) + 0.5
    m = (img_c[None, :] - lo[:, None]) / span[:, None] * msize - 0.5
    inside = (img_c[None, :] >= lo[:, None]) & (img_c[None, :] <= hi[:, None])
    mi = np.arange(msize, dtype=np.float32)
    mc = np.clip(m, 0.0, msize - 1.0)
    w = np.maximum(1.0 - np.abs(mc[:, :, None] - mi[None, None, :]), 0.0)
    return (w * inside[:, :, None]).astype(np.float32)


def paste_masks_np(
    mask_probs: np.ndarray,  # (N, msize, msize) float
    boxes: np.ndarray,  # (N, 4) XYXY in image coords
    img_h: int,
    img_w: int,
    threshold: float | None = 0.5,
):
    """Host twin of paste_masks → (N, img_h, img_w).

    Pastes only inside each box's pixel window (every weight outside the
    box is zero by construction), then writes the window into the zero
    canvas. At COCO geometry (800×1088 canvas, typical boxes ≤300 px)
    this is 10-50× less host arithmetic than the full-canvas einsum;
    results are identical up to BLAS summation order."""
    N = len(mask_probs)
    out = np.zeros((N, img_h, img_w),
                   bool if threshold is not None else np.float32)
    if N == 0:
        return out
    boxes = np.asarray(boxes, np.float32)
    probs = np.asarray(mask_probs, np.float32)
    for n in range(N):
        x0, y0, x1, y1 = boxes[n]
        iy0, iy1 = max(int(np.floor(y0)), 0), min(int(np.ceil(y1)) + 1, img_h)
        ix0, ix1 = max(int(np.floor(x0)), 0), min(int(np.ceil(x1)) + 1, img_w)
        if iy1 <= iy0 or ix1 <= ix0:
            continue
        ry = _paste_weights_np(
            boxes[n : n + 1, 1], boxes[n : n + 1, 3], img_h,
            probs.shape[1], iy0, iy1,
        )[0]  # (wh, m)
        rx = _paste_weights_np(
            boxes[n : n + 1, 0], boxes[n : n + 1, 2], img_w,
            probs.shape[2], ix0, ix1,
        )[0]  # (ww, m)
        win = (ry @ probs[n]) @ rx.T
        if threshold is not None:
            out[n, iy0:iy1, ix0:ix1] = win > threshold
        else:
            out[n, iy0:iy1, ix0:ix1] = win
    return out
