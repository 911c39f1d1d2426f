"""RoIAlign on backbone features: hand-written CUDA kernels + plain versions.

Counterpart of the JAX package's ``ops/roi_align_pallas.py``, with the
same signature and result. ``roi_align_cuda`` is differentiable with
respect to the map, as the TPU kernel's custom VJP is: it applies
``_RoIAlign``, a ``torch.autograd.Function`` whose forward launches the
forward kernel of ``csrc/roi_align.cu`` and whose backward launches its
backward kernel (``roi_align_backward_cuda``). No gradient flows to the
ROIs. For a CPU tensor the same Function runs the plain versions instead:
``_roi_align_plain`` forward, ``_roi_align_plain_bwd`` backward. They are
the TPU kernel's arithmetic in torch: hat-weight matrices
(``_hat_weights``/``_roi_weights``) and a pair of contractions, f32
accumulation, one rounding to the map's dtype; the backward is the JAX
``f_bwd``'s pair of einsums, chunked over ROIs.
"""

from __future__ import annotations

import torch

from fgn_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
    """The forward kernel's plain version: out[b,r,i,j,c] =
    Σ_h Σ_w Wy[b,r,i,h] · f[b,h,w,c] · Wx[b,r,j,w], in f32."""
    B, H, W, C = fmap.shape
    wy, wx = _roi_weights(
        rois.to(torch.float32), H, W, out_size, spatial_scale,
        max(int(sampling_ratio), 1), aligned,
    )  # (B, R, O, H), (B, R, O, W)
    tmp = torch.einsum("brih,bhwc->briwc", wy, fmap.to(torch.float32))
    out = torch.einsum("briwc,brjw->brijc", tmp, wx)
    return out.to(fmap.dtype)


def _roi_align_plain_bwd(g, rois, H: int, W: int, dtype, out_size=7,
                         spatial_scale=1.0, sampling_ratio=2, aligned=True,
                         roi_chunk: int = 32):
    """The backward kernel's plain version: the map's gradient
    df[b,h,w,c] = Σ_r Σ_i Σ_j Wy[b,r,i,h] · g[b,r,i,j,c] · Wx[b,r,j,w],
    summed in f32 over chunks of ``roi_chunk`` ROIs, cast to ``dtype``."""
    B, R, O, _, C = g.shape
    wy, wx = _roi_weights(
        rois.to(torch.float32), H, W, out_size, spatial_scale,
        max(int(sampling_ratio), 1), aligned,
    )
    df = torch.zeros((B, H, W, C), dtype=torch.float32, device=g.device)
    for lo in range(0, R, roi_chunk):
        sl = slice(lo, lo + roi_chunk)
        gyc = torch.einsum("brih,brijc->brhjc", wy[:, sl],
                           g[:, sl].to(torch.float32))  # (B, RC, H, O, C)
        df += torch.einsum("brhjc,brjw->bhwc", gyc, wx[:, sl])
    return df.to(dtype)


def _check(fmap, rois, out_size, S, what):
    if fmap.dim() != 4 or rois.dim() != 3 or rois.shape[-1] != 4:
        raise ValueError(
            f"{what}: want fmap (B,H,W,C) and rois (B,R,4), got "
            f"{tuple(fmap.shape)} and {tuple(rois.shape)}"
        )
    if fmap.dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {fmap.dtype} not in f32/bf16")
    if rois.dtype != torch.float32:
        raise TypeError(f"{what}: rois must be float32, got {rois.dtype}")
    if rois.device != fmap.device or rois.shape[0] != fmap.shape[0]:
        raise ValueError(f"{what}: rois must match the map's device and batch")
    if not (fmap.is_contiguous() and rois.is_contiguous()):
        raise ValueError(f"{what}: tensors must be contiguous")
    if fmap.shape[-1] % 2 or fmap.data_ptr() % (2 * fmap.element_size()):
        raise ValueError(f"{what}: C must be even and the data pair-aligned")
    if out_size * S > 64 or rois.shape[1] > 65535 or fmap.shape[0] > 65535:
        raise ValueError(f"{what}: out_size*sampling_ratio <= 64, R and B "
                         f"<= 65535")


def _roi_align_forward(fmap, rois, out_size, spatial_scale, sampling_ratio,
                       aligned):
    """Forward on the map's device: the plain version for a CPU tensor, the
    kernel for a CUDA tensor."""
    if fmap.device.type == "cpu":
        return _roi_align_plain(
            fmap, rois, out_size, spatial_scale, sampling_ratio, aligned
        )
    if fmap.device.type != "cuda":
        raise ValueError(f"roi_align_cuda: unsupported device {fmap.device}")
    S = max(int(sampling_ratio), 1)
    _check(fmap, rois, out_size, S, "roi_align_cuda")
    B, H, W, C = fmap.shape
    R = rois.shape[1]
    out = torch.empty((B, R, out_size, out_size, C), dtype=fmap.dtype,
                      device=fmap.device)
    if out.numel() == 0:
        return out
    lib = _build.load("roi_align")
    rc = lib.fgn_roi_align_forward(
        fmap.data_ptr(), rois.data_ptr(), out.data_ptr(), B, H, W, C, R,
        out_size, S, float(spatial_scale), int(bool(aligned)),
        _DTYPES[fmap.dtype], torch.cuda.current_stream(fmap.device).cuda_stream,
    )
    _build.check(lib, "fgn_roi_align_error_string", rc, "roi_align kernel")
    roi_align_cuda.launches += 1
    return out


def roi_align_backward_cuda(g, rois, H: int, W: int, out_size: int = 7,
                            spatial_scale: float = 1.0, sampling_ratio: int = 2,
                            aligned: bool = True):
    """The map's gradient: g (B, R, O, O, C), the gradient of the output, →
    (B, H, W, C) in g's dtype (the map's dtype). The backward kernel for a
    CUDA tensor, the plain version for a CPU tensor."""
    if g.device.type == "cpu":
        return _roi_align_plain_bwd(g, rois, H, W, g.dtype, out_size,
                                    spatial_scale, sampling_ratio, aligned)
    if g.device.type != "cuda":
        raise ValueError(f"roi_align_backward_cuda: unsupported device {g.device}")
    S = max(int(sampling_ratio), 1)
    B, R = g.shape[:2]
    C = g.shape[-1]
    if g.shape != (B, R, out_size, out_size, C) or not g.is_contiguous():
        raise ValueError(f"roi_align_backward_cuda: g must be a contiguous "
                         f"(B,R,O,O,C) with O={out_size}, got {tuple(g.shape)}")
    _check(g.reshape(B, R * out_size, out_size, C), rois, out_size, S,
           "roi_align_backward_cuda")
    acc = torch.zeros((B, H, W, C), dtype=torch.float32, device=g.device)
    if acc.numel() == 0 or g.numel() == 0:
        return acc.to(g.dtype)
    df = acc if g.dtype == torch.float32 else torch.empty_like(acc, dtype=g.dtype)
    lib = _build.load("roi_align")
    rc = lib.fgn_roi_align_backward(
        g.data_ptr(), rois.data_ptr(), acc.data_ptr(), df.data_ptr(), B, H, W,
        C, R, out_size, S, float(spatial_scale), int(bool(aligned)),
        _DTYPES[g.dtype], torch.cuda.current_stream(g.device).cuda_stream,
    )
    _build.check(lib, "fgn_roi_align_error_string", rc,
                 "roi_align backward kernel")
    roi_align_backward_cuda.launches += 1
    return df


class _RoIAlign(torch.autograd.Function):
    """RoIAlign, differentiable with respect to the map (not the ROIs)."""

    @staticmethod
    def forward(ctx, fmap, rois, out_size, spatial_scale, sampling_ratio,
                aligned):
        ctx.save_for_backward(rois)
        ctx.geom = (fmap.shape[1], fmap.shape[2], out_size, spatial_scale,
                    sampling_ratio, aligned)
        return _roi_align_forward(fmap, rois, out_size, spatial_scale,
                                  sampling_ratio, aligned)

    @staticmethod
    def backward(ctx, g):
        (rois,) = ctx.saved_tensors
        df = roi_align_backward_cuda(g.contiguous(), rois, *ctx.geom)
        return df, None, None, None, None, None


def roi_align_cuda(fmap, rois, out_size: int = 7, spatial_scale: float = 1.0,
                   sampling_ratio: int = 2, aligned: bool = True):
    """(B, H, W, C) map, (B, R, 4) XYXY f32 rois → (B, R, O, O, C) in the
    map's dtype (f32 or bf16). Differentiable with respect to the map."""
    return _RoIAlign.apply(fmap, rois, out_size, spatial_scale,
                           sampling_ratio, aligned)


roi_align_cuda.launches = 0
roi_align_backward_cuda.launches = 0
