"""The InternImage backbone (Wang et al., CVPR 2023, arXiv:2211.05778) as
FGN's C4 map, in PyTorch.

The equations are those of InternImage's detection code
(``detection/mmdet_custom/models/backbones/intern_image.py``:
``StemLayer``, ``DownsampleLayer``, ``InternImageLayer``;
``ops_dcnv3/modules/dcnv3.py``: ``DCNv3_pytorch``;
``ops_dcnv3/functions/dcnv3_func.py``: ``dcnv3_core_pytorch``), with
InternImage-L's settings from ``InternImageConfig``:

  * the stem: a 3×3 stride-2 convolution (pad 1, bias) to C/2 channels,
    LayerNorm, GELU, a 3×3 stride-2 convolution (pad 1, bias) to C,
    LayerNorm;
  * block j of a stage (C channels, G = C/16 groups), post-norm with the
    per-channel layer scales γ₁, γ₂: ``x + γ₁·LN₁(DCN(x))``, then
    ``x + γ₂·LN₂(fc2(GELU(fc1(x))))``, GELU exact, hidden 4C;
  * DCN(x): ``v = input_proj(x)``; ``y = GELU(LN(dwconv3×3(x)))`` (the
    depthwise convolution with pad 1 and bias reads x, not v); the offsets
    Δ = ``offset(y)`` (G·9·2 channels) and the weights m = softmax over the
    9 points of ``mask(y)`` (G·9 channels); for point p = 3i + j of group
    g the offset pair is (Δx, Δy) = Δ[(g·9 + p)·2 + (0, 1)] and the output
    at pixel (y₀, x₀), channel c of group g, is
    Σ_p m_p · bilin(v[g·16 + c], x₀ + s·(i − 1 + Δx), y₀ + s·(j − 1 + Δy)),
    s the offset scale, pixel centres at integers, zeros outside the map;
    then ``output_proj``;
  * after stages 1 and 2: a 3×3 stride-2 convolution (pad 1, no bias) to
    2C, then LayerNorm;
  * the output is stage ``out_stage``'s map after its blocks, (B, H/16,
    W/16, C) NHWC: with post-norm there is no stage-end norm; the stages
    after it are not built. Drop path is training-only and absent.

Precision follows ``models/swin.py``: parameters are float32 and cast at
use; the convolutions, every linear layer and GELU run in ``dtype``; the
residual stream (the stem's output, each block's two sums, each
downsampling's output) stays float32, LayerNorm takes its statistics in
float32. In the DCN core the mask's softmax, the sampling locations, the
bilinear weights and the 9-point sums are float32; the values are v's
(``dtype``), widened to float32, and the sum is rounded once to ``dtype``.
The map goes to the heads in ``dtype``.

The DCN core (``DCNv3.dcn_core``: from v, Δ and the mask logits to the
output before ``output_proj``, inside the span ``dcn_core``) is
``dcnv3_core_pytorch``'s composition of library ops in float32, the same
on the card and on the CPU: the locations base + s·Δ in pixels, normalised
for ``F.grid_sample`` (``align_corners=False``, zeros outside); v permuted
to (B·G, 16, H, W) in float32; the sampled (B·G, 16, 9, H·W) values
weighted by the softmax and summed; one rounding to ``dtype``. In bf16
the library takes its grid in the map's dtype, which cannot resolve a
pixel at the stage-1 grid's 272 columns, so the route runs in float32.
Each shape's base grid is built once and cached. Spans ``ii_stem``,
``ii_stage1``… and ``ii_down`` cover the stem, each stage's blocks and
each downsampling; the counters ``dcn.calls``, ``dcn.samples`` (Σ
B·H·W·G·9) and ``dcn.tmp_bytes`` (the bytes the composition builds in
memory: grids, the permuted map, the sampled values; what a kernel would
drive to 0) count the work.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fgn_torch.config.internimage import InternImageConfig
from fgn_torch.models.resnet import Linear, _nchw, _nhwc
from fgn_torch.models.vit import LayerNorm, Mlp
from fgn_torch.utils.profiling import count, span

GROUP_CHANNELS = 16
_CACHE: Dict[Tuple, torch.Tensor] = {}


def base_grid(H: int, W: int, k: int, s: float, device) -> torch.Tensor:
    """(H, W, 1, k², 2) float32: pixel (y₀, x₀)'s point p = k·i + j at
    (x₀ + s·(i − c), y₀ + s·(j − c)), c = (k − 1)/2, as (x, y)."""
    key = ("base", H, W, k, s, str(device))
    if key not in _CACHE:
        d = s * (torch.arange(k, dtype=torch.float32, device=device) - (k - 1) // 2)
        x = torch.arange(W, dtype=torch.float32, device=device)[None, :, None]
        y = torch.arange(H, dtype=torch.float32, device=device)[:, None, None]
        px = (x + d.repeat_interleave(k)).expand(H, W, k * k)  # i = p // k
        py = (y + d.repeat(k)).expand(H, W, k * k)  # j = p % k
        _CACHE[key] = torch.stack((px, py), -1)[:, :, None]
    return _CACHE[key]


def locations(base, offset, s: float):
    """The sampling locations base + s·Δ, float32: ``base`` (H, W, 1, P, 2),
    ``offset`` (B, H, W, G, P, 2) in any float dtype."""
    return torch.add(base, offset, alpha=s)


def _normalizer(H: int, W: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(2/W, 2/H) and (1/W − 1, 1/H − 1): a pixel location (x, y) to
    ``F.grid_sample``'s coordinates with ``align_corners=False``, pixel i's
    centre at (2i + 1)/size − 1."""
    key = ("norm", H, W, str(device))
    if key not in _CACHE:
        _CACHE[key] = (torch.tensor([2.0 / W, 2.0 / H], device=device),
                       torch.tensor([1.0 / W - 1.0, 1.0 / H - 1.0], device=device))
    return _CACHE[key]


def _contiguous(x, dtype) -> torch.Tensor:
    """A contiguous copy of ``x`` in ``dtype``: one pass, whatever x's strides."""
    out = torch.empty(x.shape, dtype=dtype, device=x.device)
    out.copy_(x)
    return out


class Conv3x3(nn.Module):
    """A 3×3 convolution with pad 1 over an NHWC map, in ``dtype``."""

    def __init__(self, cin: int, cout: int, stride: int = 1, groups: int = 1,
                 bias: bool = True, dtype=torch.float32):
        super().__init__()
        self.stride = stride
        self.groups = groups
        self.dt = dtype
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(self.dt)
        y = F.conv2d(_nchw(x.to(self.dt).contiguous()), self.weight.to(self.dt), b,
                     stride=self.stride, padding=1, groups=self.groups)
        return _nhwc(y)


class DCNv3(nn.Module):
    """Deformable convolution v3 over (B, H, W, C) maps, G groups of 16
    channels, a k×k grid of points dilated by the offset scale."""

    def __init__(self, dim: int, groups: int, k: int, offset_scale: float, eps: float,
                 dtype=torch.float32):
        super().__init__()
        self.group = groups
        self.kernel = k
        self.offset_scale = offset_scale
        self.dt = dtype
        P = k * k
        self.input_proj = Linear(dim, dim, dtype)
        self.dw_conv = Conv3x3(dim, dim, groups=dim, dtype=dtype)
        self.dw_norm = LayerNorm(dim, eps, dtype)
        self.offset = Linear(dim, groups * P * 2, dtype)
        self.mask = Linear(dim, groups * P, dtype)
        self.output_proj = Linear(dim, dim, dtype)

    def forward(self, x):
        x = x.to(self.dt)
        v = self.input_proj(x)
        y = F.gelu(self.dw_norm(self.dw_conv(x)))
        return self.output_proj(self.dcn_core(v, self.offset(y), self.mask(y)))

    def dcn_core(self, value, offset, mask_logits):
        """Σ_p softmax(mask_logits)_p · bilin(value, base_p + s·Δ_p) →
        (B, H, W, C) in value's dtype; ``value`` (B, H, W, C), ``offset``
        (B, H, W, G·P·2), ``mask_logits`` (B, H, W, G·P)."""
        B, H, W, C = value.shape
        G, P = self.group, self.kernel ** 2
        gc = C // G
        with span("dcn_core"):
            ft = torch.promote_types(value.dtype, torch.float32)
            loc = locations(base_grid(H, W, self.kernel, self.offset_scale, value.device),
                            offset.view(B, H, W, G, P, 2), self.offset_scale)
            scale, shift = _normalizer(H, W, value.device)
            normed = torch.addcmul(shift, loc, scale)
            # points outside pixels: the 9-point sum runs over a middle axis,
            # each point's H·W values contiguous
            grid = normed.permute(0, 3, 4, 1, 2, 5).reshape(B * G, P, H * W, 2)
            v = _contiguous(value.view(B, H, W, G, gc).permute(0, 3, 4, 1, 2), ft)
            sampled = F.grid_sample(v.view(B * G, gc, H, W), grid, mode="bilinear",
                                    padding_mode="zeros", align_corners=False)
            soft = torch.softmax(mask_logits.view(B, H * W, G, P), -1, dtype=ft)
            m = soft.permute(0, 2, 3, 1).reshape(B * G, 1, P, H * W)
            weighted = sampled * m  # (B·G, 16, P, H·W)
            summed = weighted.sum(2)
            out = _contiguous(summed.view(B, G, gc, H, W).permute(0, 3, 4, 1, 2),
                              value.dtype).view(B, H, W, C)
        built = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                 for t in (loc, normed, grid, v, sampled, soft, m, weighted, summed)}
        built.pop(out.untyped_storage().data_ptr(), None)
        count("dcn.calls")
        count("dcn.samples", B * H * W * G * P)
        count("dcn.tmp_bytes", sum(built.values()))
        return out


class InternImageBlock(nn.Module):
    def __init__(self, dim: int, groups: int, cfg: InternImageConfig, dtype=torch.float32):
        super().__init__()
        self.dcn = DCNv3(dim, groups, cfg.kernel_size, cfg.offset_scale, cfg.ln_eps, dtype)
        self.norm1 = LayerNorm(dim, cfg.ln_eps, dtype)
        self.mlp = Mlp(dim, int(dim * cfg.mlp_ratio), dtype)
        self.norm2 = LayerNorm(dim, cfg.ln_eps, dtype)
        self.gamma1 = nn.Parameter(torch.full((dim,), cfg.layer_scale))
        self.gamma2 = nn.Parameter(torch.full((dim,), cfg.layer_scale))

    def forward(self, x):  # (B, H, W, C) float32
        x = torch.addcmul(x, self.gamma1, self.norm1(self.dcn(x)))
        return torch.addcmul(x, self.gamma2, self.norm2(self.mlp(x)))


class Downsample(nn.Module):
    """(B, H, W, C) → (B, ⌈H/2⌉, ⌈W/2⌉, 2C), float32 out."""

    def __init__(self, dim: int, eps: float, dtype=torch.float32):
        super().__init__()
        self.conv = Conv3x3(dim, 2 * dim, stride=2, bias=False, dtype=dtype)
        self.norm = LayerNorm(2 * dim, eps, torch.promote_types(dtype, torch.float32))

    def forward(self, x):
        with span("ii_down"):
            return self.norm(self.conv(x))


class InternImageStage(nn.Module):
    def __init__(self, cfg: InternImageConfig, i: int, down: bool, dtype=torch.float32):
        super().__init__()
        dim = cfg.dim(i)
        self.blocks = nn.ModuleList(InternImageBlock(dim, cfg.groups[i], cfg, dtype)
                                    for _ in range(cfg.depths[i]))
        self.downsample = Downsample(dim, cfg.ln_eps, dtype) if down else None


class InternImage(nn.Module):
    """(B, H, W, 3) normalized images → (B, H/16, W/16, C) NHWC, C the out
    stage's width (640 for InternImage-L). ``frozen=True`` detaches the
    output."""

    def __init__(self, cfg: InternImageConfig, frozen: bool = False, dtype=torch.float32):
        super().__init__()
        if not cfg.post_norm or cfg.kernel_size != 3:
            raise ValueError(f"only InternImage's post-norm blocks with 3×3 DCNv3 "
                             f"grids are built: {cfg}")
        if any(cfg.dim(i) != GROUP_CHANNELS * cfg.groups[i] for i in range(cfg.out_stage)):
            raise ValueError(f"DCNv3 groups hold {GROUP_CHANNELS} channels: {cfg}")
        self.cfg = cfg
        self.frozen = frozen
        self.dt = dtype
        res_dt = torch.promote_types(dtype, torch.float32)  # the residual stream's
        C = cfg.channels
        self.patch_embed = nn.Module()
        self.patch_embed.conv1 = Conv3x3(3, C // 2, stride=2, dtype=dtype)
        self.patch_embed.norm1 = LayerNorm(C // 2, cfg.ln_eps, dtype)
        self.patch_embed.conv2 = Conv3x3(C // 2, C, stride=2, dtype=dtype)
        self.patch_embed.norm2 = LayerNorm(C, cfg.ln_eps, res_dt)
        n = cfg.out_stage
        self.levels = nn.ModuleList(InternImageStage(cfg, i, i < n - 1, dtype)
                                    for i in range(n))

    def forward(self, x):  # NHWC
        pe = self.patch_embed
        with span("ii_stem"):
            x = pe.norm2(pe.conv2(F.gelu(pe.norm1(pe.conv1(x)))))
        for i, level in enumerate(self.levels):
            with span(f"ii_stage{i + 1}"):
                for blk in level.blocks:
                    x = blk(x)
            if level.downsample is not None:
                x = level.downsample(x)
        x = x.to(self.dt)
        return x.detach() if self.frozen else x
