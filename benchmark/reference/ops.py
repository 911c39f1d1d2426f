"""Box, anchor, RoIAlign, assignment, sampling and loss operations of the
plain reference, in float32 PyTorch.

Frozen from the port's plain versions (``ops/boxes.py``, ``ops/anchors.py``,
``ops/roi_align.py``, ``ops/assign.py``, ``ops/sample.py``,
``models/losses.py``), which follow mmdet 2.x: XYXY boxes with no +1,
DeltaXYWH coding, anchors centred on the grid points and ordered
location-major then ratio-major, RoIAlign with sampling ratio 2 and
half-pixel alignment, MaxIoU assignment with low-quality matches, random
positive/negative sampling ranked by given uniform draws.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F


# -- boxes ------------------------------------------------------------------

def box_area(b):
    return (b[..., 2] - b[..., 0]).clamp(min=0) * (b[..., 3] - b[..., 1]).clamp(min=0)


def box_iou(b1, b2):
    """(..., M, 4) × (..., N, 4) → (..., M, N); the union clamped at 1e-9."""
    lt = torch.maximum(b1[..., :, None, :2], b2[..., None, :, :2])
    rb = torch.minimum(b1[..., :, None, 2:], b2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(b1)[..., :, None] + box_area(b2)[..., None, :] - inter
    return inter / union.clamp(min=1e-9)


def delta_encode(props, gt, stds=(1.0, 1.0, 1.0, 1.0)):
    pw = props[..., 2] - props[..., 0]
    ph = props[..., 3] - props[..., 1]
    px = props[..., 0] + 0.5 * pw
    py = props[..., 1] + 0.5 * ph
    gw = gt[..., 2] - gt[..., 0]
    gh = gt[..., 3] - gt[..., 1]
    gx = gt[..., 0] + 0.5 * gw
    gy = gt[..., 1] + 0.5 * gh
    pw = pw.clamp(min=1e-6)
    ph = ph.clamp(min=1e-6)
    d = torch.stack([(gx - px) / pw, (gy - py) / ph,
                     torch.log(gw.clamp(min=1e-6) / pw),
                     torch.log(gh.clamp(min=1e-6) / ph)], dim=-1)
    return d / d.new_tensor(stds)


def delta_decode(props, deltas, stds=(1.0, 1.0, 1.0, 1.0), max_hw=None):
    """Deltas → XYXY boxes, clipped to ``max_hw`` = (h, w) when given
    (numbers or tensors that broadcast against the boxes' leading axes)."""
    d = deltas * deltas.new_tensor(stds)
    max_ratio = abs(float(np.log(np.float32(16.0 / 1000.0))))
    dw = d[..., 2].clamp(-max_ratio, max_ratio)
    dh = d[..., 3].clamp(-max_ratio, max_ratio)
    pw = props[..., 2] - props[..., 0]
    ph = props[..., 3] - props[..., 1]
    px = props[..., 0] + 0.5 * pw
    py = props[..., 1] + 0.5 * ph
    gw = pw * torch.exp(dw)
    gh = ph * torch.exp(dh)
    gx = px + pw * d[..., 0]
    gy = py + ph * d[..., 1]
    x1, y1 = gx - 0.5 * gw, gy - 0.5 * gh
    x2, y2 = gx + 0.5 * gw, gy + 0.5 * gh
    if max_hw is not None:
        h, w = (torch.as_tensor(v, dtype=x1.dtype, device=x1.device)
                for v in max_hw)
        zero = torch.zeros((), dtype=x1.dtype, device=x1.device)
        x1 = torch.minimum(torch.maximum(x1, zero), w)
        y1 = torch.minimum(torch.maximum(y1, zero), h)
        x2 = torch.minimum(torch.maximum(x2, zero), w)
        y2 = torch.minimum(torch.maximum(y2, zero), h)
    return torch.stack([x1, y1, x2, y2], dim=-1)


# -- anchors ----------------------------------------------------------------

def anchors(h: int, w: int, stride: int, scales, ratios, device):
    """(h·w·A, 4) XYXY float32, location-major, index ratio·len(scales) +
    scale; built in numpy float32 as mmdet builds them."""
    s = np.asarray(scales, np.float32)
    r = np.asarray(ratios, np.float32)
    hr = np.sqrt(r)
    ws = (stride * (1.0 / hr)[:, None] * s[None, :]).reshape(-1)
    hs = (stride * hr[:, None] * s[None, :]).reshape(-1)
    base = np.stack([-0.5 * ws, -0.5 * hs, 0.5 * ws, 0.5 * hs], axis=-1)
    sx, sy = np.meshgrid(np.arange(w, dtype=np.float32) * stride,
                         np.arange(h, dtype=np.float32) * stride)
    shifts = np.stack([sx, sy, sx, sy], axis=-1)
    a = (shifts[:, :, None, :] + base[None, None]).reshape(-1, 4)
    return torch.tensor(a.astype(np.float32), device=device)


def inside_flags(a, img_h, img_w):
    return (a[..., 0] >= 0) & (a[..., 1] >= 0) & (a[..., 2] < img_w) & (a[..., 3] < img_h)


# -- RoIAlign ---------------------------------------------------------------

def _bilinear(fmap, ys, xs):
    """fmap (B, H, W, C) at grids ys, xs (B, R, O) → (B, R, O, O, C);
    points outside (-1, size) count zero."""
    B, H, W, C = fmap.shape
    bidx = torch.arange(B, device=fmap.device)[:, None, None, None]
    oob_y = (ys <= -1.0) | (ys >= H)
    oob_x = (xs <= -1.0) | (xs >= W)
    y = ys.clamp(0.0, H - 1)
    x = xs.clamp(0.0, W - 1)
    y0, x0 = torch.floor(y), torch.floor(x)
    wy1, wx1 = y - y0, x - x0
    zero = torch.zeros((), dtype=y.dtype, device=y.device)
    wy0 = torch.where(oob_y, zero, 1.0 - wy1)
    wx0 = torch.where(oob_x, zero, 1.0 - wx1)
    wy1 = torch.where(oob_y, zero, wy1)
    wx1 = torch.where(oob_x, zero, wx1)
    y0i, x0i = y0.long(), x0.long()
    y1i = (y0i + 1).clamp(max=H - 1)
    x1i = (x0i + 1).clamp(max=W - 1)
    out = None
    for yi, wy in ((y0i, wy0), (y1i, wy1)):
        for xi, wx in ((x0i, wx0), (x1i, wx1)):
            v = fmap[bidx, yi[:, :, :, None], xi[:, :, None, :], :]
            v = v * (wy[:, :, :, None] * wx[:, :, None, :])[..., None]
            out = v if out is None else out + v
    return out


def roi_align(fmap, rois, out_size: int, spatial_scale: float,
              sampling_ratio: int = 2):
    """(B, H, W, C) map, (B, R, 4) XYXY rois → (B, R, O, O, C): the mean of
    sampling_ratio² bilinear samples a bin, aligned (half-pixel offset)."""
    O, S = out_size, sampling_ratio
    r = rois.to(torch.float32) * spatial_scale - 0.5
    bw = (r[..., 2] - r[..., 0]) / O
    bh = (r[..., 3] - r[..., 1]) / O
    dev = fmap.device
    grid = (torch.arange(O, dtype=torch.float32, device=dev)[:, None]
            + (torch.arange(S, dtype=torch.float32, device=dev)[None, :] + 0.5) / S)
    ys = r[..., 1, None, None] + bh[..., None, None] * grid  # (B, R, O, S)
    xs = r[..., 0, None, None] + bw[..., None, None] * grid
    acc = None
    for sy in range(S):
        for sx in range(S):
            v = _bilinear(fmap, ys[..., sy], xs[..., sx])
            acc = v if acc is None else acc + v
    return acc / float(S * S)


# -- assignment and sampling ------------------------------------------------

class Assigned(NamedTuple):
    gt_inds: torch.Tensor  # -1 ignore, 0 negative, g+1 gt g
    pos: torch.Tensor
    neg: torch.Tensor


def max_iou_assign(boxes, gt, gt_valid, pos_thr, neg_thr, min_pos,
                   box_valid=None) -> Assigned:
    """mmdet's MaxIoUAssigner with low-quality matches (the last gt wins a
    box claimed by several); leading dimensions broadcast."""
    ious = box_iou(gt, boxes)  # (..., G, A)
    ious = torch.where(gt_valid[..., :, None], ious, torch.zeros_like(ious))
    max_ov = ious.amax(dim=-2).clamp(min=0.0)
    arg = ious.argmax(dim=-2).to(torch.int32)
    a = torch.full(max_ov.shape, -1, dtype=torch.int32, device=ious.device)
    a = torch.where(max_ov < neg_thr, 0, a)
    a = torch.where(max_ov >= pos_thr, arg + 1, a)
    gt_max = ious.amax(dim=-1, keepdim=True)
    elig = (ious == gt_max) & (gt_max >= min_pos) & gt_valid[..., :, None] & (ious > 0)
    G = ious.shape[-2]
    ids = torch.arange(1, G + 1, dtype=torch.int32, device=ious.device)
    last = torch.where(elig, ids[:, None], torch.zeros((), dtype=torch.int32,
                                                       device=ious.device)).amax(dim=-2)
    a = torch.where(last > 0, last, a)
    if box_valid is not None:
        a = torch.where(box_valid, a, -1)
    return Assigned(a, a > 0, a == 0)


class Sampled(NamedTuple):
    inds: torch.Tensor
    is_pos: torch.Tensor
    valid: torch.Tensor


def _ranked(u, mask, k):
    A = mask.shape[-1]
    score = torch.where(mask, u, torch.full((), float("-inf"), device=u.device))
    k_eff = min(k, A)
    idx = torch.sort(score, dim=-1, descending=True, stable=True)[1][..., :k_eff]
    if k_eff < k:
        idx = torch.cat([idx, idx.new_zeros(idx.shape[:-1] + (k - k_eff,))], -1)
    picked = torch.arange(k, device=mask.device) < mask.sum(-1, keepdim=True).clamp(max=k)
    return idx, picked


def sample_pos_neg(u, pos, neg, num: int, pos_fraction: float) -> Sampled:
    """Up to num·pos_fraction positives then negatives to num slots, each
    ranked by its row of the draws u (..., 2, A), descending, ties to the
    lower index."""
    n_exp = int(num * pos_fraction)
    pos_idx, pos_picked = _ranked(u[..., 0, :], pos, n_exp)
    neg_idx, neg_picked = _ranked(u[..., 1, :], neg, num)
    n_pos = pos_picked.sum(-1, keepdim=True)
    n_neg = torch.minimum(num - n_pos, neg_picked.sum(-1, keepdim=True))
    slots = torch.arange(num, device=pos.device)
    is_pos = slots < n_pos
    valid = slots < n_pos + n_neg
    inds = torch.gather(neg_idx, -1, (slots - n_pos).clamp(0, num - 1))
    pos_slot = slots.clamp(0, max(n_exp - 1, 0)).expand_as(inds)
    if n_exp > 0:
        inds = torch.where(is_pos, torch.gather(pos_idx, -1, pos_slot), inds)
    return Sampled(inds, is_pos, valid)


# -- losses -----------------------------------------------------------------

def _avg(f):
    if isinstance(f, torch.Tensor):
        return f.to(torch.float32).clamp(min=1.0)
    return max(float(f), 1.0)


def sigmoid_bce(logits, targets, weights, avg):
    per = (logits.clamp(min=0.0) - logits * targets
           + torch.log1p(torch.exp(-logits.abs())))
    return (per * weights).sum() / _avg(avg)


def softmax_ce(logits, labels, weights, avg):
    logp = F.log_softmax(logits, dim=-1)
    picked = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return (-picked * weights).sum() / _avg(avg)


def smooth_l1(pred, target, weights, avg, beta: float = 1.0):
    d = (pred - target).abs()
    per = torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)
    return (per * weights).sum() / _avg(avg)
