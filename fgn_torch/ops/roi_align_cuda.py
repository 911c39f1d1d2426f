"""RoIAlign on backbone features: hand-written CUDA kernel + plain version.

Counterpart of the JAX package's ``ops/roi_align_pallas.py``, with the
same signature and result. ``roi_align_cuda`` launches
``csrc/roi_align.cu`` for a CUDA tensor and uses ``_roi_align_plain`` only
for a CPU tensor. The plain version is the TPU kernel's arithmetic in
torch: hat-weight matrices (``_hat_weights``/``_roi_weights``) and the pair
of contractions of ``_chunk_contract``, f32 accumulation, one rounding to
the map's dtype. Forward only: the backward comes with the training step.
"""

from __future__ import annotations

import torch

from fgn_torch.ops import _build


def _hat_weights(start, bin_size, size: int, out_size: int, ratio: int):
    """(..., O, size) averaging-bilinear weight matrix for one axis."""
    O, S = out_size, ratio
    dev = start.device
    grid = (
        torch.arange(O, dtype=torch.float32, device=dev)[:, None]
        + (torch.arange(S, dtype=torch.float32, device=dev)[None, :] + 0.5) / S
    )  # (O, S)
    pts = start[..., None, None] + bin_size[..., None, None] * grid  # (..., O, S)
    oob = (pts <= -1.0) | (pts >= size)
    ptsc = pts.clamp(0.0, size - 1)
    idx = torch.arange(size, dtype=torch.float32, device=dev)
    w = (1.0 - (ptsc[..., None] - idx).abs()).clamp(min=0.0)
    w = torch.where(oob[..., None], torch.zeros((), device=dev), w)
    return w.sum(dim=-2) / float(S)  # (..., O, size)


def _roi_weights(rois, H, W, O, spatial_scale, sampling_ratio, aligned):
    offset = 0.5 if aligned else 0.0
    x1 = rois[..., 0] * spatial_scale - offset
    y1 = rois[..., 1] * spatial_scale - offset
    rw = rois[..., 2] * spatial_scale - offset - x1
    rh = rois[..., 3] * spatial_scale - offset - y1
    if not aligned:
        rw = rw.clamp(min=1.0)
        rh = rh.clamp(min=1.0)
    wy = _hat_weights(y1, rh / O, H, O, sampling_ratio)
    wx = _hat_weights(x1, rw / O, W, O, sampling_ratio)
    return wy, wx


def _roi_align_plain(fmap, rois, out_size=7, spatial_scale=1.0,
                     sampling_ratio=2, aligned=True):
    """The kernel's plain version: out[b,r,i,j,c] =
    Σ_h Σ_w Wy[b,r,i,h] · f[b,h,w,c] · Wx[b,r,j,w], in f32."""
    B, H, W, C = fmap.shape
    wy, wx = _roi_weights(
        rois.to(torch.float32), H, W, out_size, spatial_scale,
        max(int(sampling_ratio), 1), aligned,
    )  # (B, R, O, H), (B, R, O, W)
    tmp = torch.einsum("brih,bhwc->briwc", wy, fmap.to(torch.float32))
    out = torch.einsum("briwc,brjw->brijc", tmp, wx)
    return out.to(fmap.dtype)


def roi_align_cuda(fmap, rois, out_size: int = 7, spatial_scale: float = 1.0,
                   sampling_ratio: int = 2, aligned: bool = True):
    """(B, H, W, C) map, (B, R, 4) XYXY f32 rois → (B, R, O, O, C) in the
    map's dtype (f32 or bf16)."""
    if fmap.device.type == "cpu":
        return _roi_align_plain(
            fmap, rois, out_size, spatial_scale, sampling_ratio, aligned
        )
    if fmap.device.type != "cuda":
        raise ValueError(f"roi_align_cuda: unsupported device {fmap.device}")
    if fmap.requires_grad:
        raise NotImplementedError(
            "roi_align_cuda is forward only; its backward comes with the "
            "training step"
        )
    if fmap.dim() != 4 or rois.dim() != 3 or rois.shape[-1] != 4:
        raise ValueError(
            f"roi_align_cuda: want fmap (B,H,W,C) and rois (B,R,4), got "
            f"{tuple(fmap.shape)} and {tuple(rois.shape)}"
        )
    B, H, W, C = fmap.shape
    R = rois.shape[1]
    S = max(int(sampling_ratio), 1)
    dtypes = {torch.float32: 0, torch.bfloat16: 1}
    if fmap.dtype not in dtypes:
        raise TypeError(f"roi_align_cuda: fmap dtype {fmap.dtype} not in f32/bf16")
    if rois.dtype != torch.float32:
        raise TypeError(f"roi_align_cuda: rois must be float32, got {rois.dtype}")
    if rois.device != fmap.device or rois.shape[0] != B:
        raise ValueError("roi_align_cuda: rois must match fmap's device and batch")
    if not (fmap.is_contiguous() and rois.is_contiguous()):
        raise ValueError("roi_align_cuda: fmap and rois must be contiguous")
    if C % 2 or fmap.data_ptr() % (2 * fmap.element_size()):
        raise ValueError("roi_align_cuda: C must be even and fmap pair-aligned")
    if out_size * S > 64 or R > 65535 or B > 65535:
        raise ValueError("roi_align_cuda: out_size*sampling_ratio <= 64, "
                         "R and B <= 65535")
    out = torch.empty((B, R, out_size, out_size, C), dtype=fmap.dtype,
                      device=fmap.device)
    if out.numel() == 0:
        return out
    lib = _build.load("roi_align")
    rc = lib.fgn_roi_align_forward(
        fmap.data_ptr(), rois.data_ptr(), out.data_ptr(), B, H, W, C, R,
        out_size, S, float(spatial_scale), int(bool(aligned)),
        dtypes[fmap.dtype], torch.cuda.current_stream(fmap.device).cuda_stream,
    )
    _build.check(lib, "fgn_roi_align_error_string", rc, "roi_align kernel")
    roi_align_cuda.launches += 1
    return out


roi_align_cuda.launches = 0
