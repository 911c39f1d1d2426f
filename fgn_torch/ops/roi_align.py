"""RoIAlign in plain PyTorch, gather form.

Port of the JAX package's ``ops/roi_align.py``: four corner gathers per
sample point, static sampling ratio, half-pixel ``aligned``, and a sample
point outside ``(-1, size)`` counts zero. It serves three purposes:

  * the support-mask RoIAlign at C=1 (``models/fgn.py::_count_spp``),
    which never goes to the kernel, on any device;
  * the backbone-feature RoIAlign when C is not a multiple of 128;
  * a second oracle, beside the hat-weight plain version, for the CUDA
    kernel in ``ops/roi_align_cuda.py``.

ROIs are per image: (B, R, 4) XYXY against a (B, H, W, C) map (NHWC).
Accumulation is float32; the result is float32 for a bf16 or f32 map, as
in the reference.
"""

from __future__ import annotations

import torch


def _bilinear_sample(fmap, ys, xs):
    """Sample fmap (B, H, W, C) at per-image grids ys (B, R, O), xs (B, R, O)
    → (B, R, O, O, C). Points outside (-1, size) contribute zero."""
    B, H, W, C = fmap.shape
    bidx = torch.arange(B, device=fmap.device)[:, None, None, None]

    def corner(y_idx, x_idx, wy, wx):
        v = fmap[bidx, y_idx[:, :, :, None], x_idx[:, :, None, :], :]
        w = (wy[:, :, :, None] * wx[:, :, None, :])[..., None]
        return v * w

    oob_y = (ys <= -1.0) | (ys >= H)
    oob_x = (xs <= -1.0) | (xs >= W)
    y = ys.clamp(0.0, H - 1)
    x = xs.clamp(0.0, W - 1)
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    wy1 = y - y0
    wx1 = x - x0
    zero = torch.zeros((), dtype=y.dtype, device=y.device)
    wy0 = torch.where(oob_y, zero, 1.0 - wy1)
    wx0 = torch.where(oob_x, zero, 1.0 - wx1)
    wy1 = torch.where(oob_y, zero, wy1)
    wx1 = torch.where(oob_x, zero, wx1)
    y0i = y0.long()
    x0i = x0.long()
    y1i = (y0i + 1).clamp(max=H - 1)
    x1i = (x0i + 1).clamp(max=W - 1)

    out = corner(y0i, x0i, wy0, wx0)
    out += corner(y0i, x1i, wy0, wx1)
    out += corner(y1i, x0i, wy1, wx0)
    out += corner(y1i, x1i, wy1, wx1)
    return out


def roi_align(
    fmap: torch.Tensor,  # (B, H, W, C)
    rois: torch.Tensor,  # (B, R, 4) XYXY in input coords
    out_size: int,
    spatial_scale: float = 1.0,
    sampling_ratio: int = 2,
    aligned: bool = True,
) -> torch.Tensor:
    """→ (B, R, out_size, out_size, C) float32."""
    O = out_size
    S = max(int(sampling_ratio), 1)
    offset = 0.5 if aligned else 0.0
    rois = rois.to(torch.float32)

    x1 = rois[..., 0] * spatial_scale - offset  # (B, R)
    y1 = rois[..., 1] * spatial_scale - offset
    x2 = rois[..., 2] * spatial_scale - offset
    y2 = rois[..., 3] * spatial_scale - offset
    rw = x2 - x1
    rh = y2 - y1
    if not aligned:
        rw = rw.clamp(min=1.0)
        rh = rh.clamp(min=1.0)
    bw = rw / O
    bh = rh / O

    # Sample offsets within the roi: (O, S) → bin i, sample s.
    dev = fmap.device
    grid = (
        torch.arange(O, dtype=torch.float32, device=dev)[:, None]
        + (torch.arange(S, dtype=torch.float32, device=dev)[None, :] + 0.5) / S
    )
    ys = y1[..., None, None] + bh[..., None, None] * grid  # (B, R, O, S)
    xs = x1[..., None, None] + bw[..., None, None] * grid

    acc = None
    for sy in range(S):
        for sx in range(S):
            v = _bilinear_sample(fmap, ys[..., sy], xs[..., sx])
            acc = v if acc is None else acc + v
    return acc.to(torch.float32) / float(S * S)
