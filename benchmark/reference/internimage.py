"""The plain reference of FGN on the InternImage backbone (Wang et al.,
*InternImage: Exploring Large-Scale Vision Foundation Models with
Deformable Convolutions*, CVPR 2023, arXiv:2211.05778), in float32.

The backbone is the detection code's forward written out in plain torch
(OpenGVLab/InternImage ``detection/mmdet_custom/models/backbones/
intern_image.py``: ``StemLayer``, ``DownsampleLayer``, ``MLPLayer``,
``InternImageLayer``, ``InternImageBlock``; ``ops_dcnv3/modules/dcnv3.py``:
``DCNv3_pytorch``), with InternImage-L's published settings coming from the
configuration file (``cascade_internimage_l_fpn_3x_coco.py``). The DCNv3
core is not ``dcnv3_core_pytorch``'s ``F.grid_sample`` but the gather its
equations describe, done explicitly for each of the 9 points and each of
the 4 corners: the location x₀ + s·(i − 1 + Δx), y₀ + s·(j − 1 + Δy) of
point p = 3i + j, its floor, the four corners' bilinear weights
(1 − |x − xc|)·(1 − |y − yc|), zeros for a corner outside the map, the
corner's 16 channels of the group gathered by index, times the point's
softmax weight, summed. So a convention of the program's route (the half
pixel, the order of x and y, the base grid dilated by s) that differs from
the equations shows as a gap. The heads are ``RefFGN``'s with the C4 map's
width where it enters them, as ``RefSwinFGN``'s. Every convolution and
linear layer takes the precision's quantizer, as in ``nets.py``; the caller
turns TF32 off (``precision.strict_f32``).

Departures from the published code, each deliberate:

  * the C4 wiring: FGN's heads take stage 3's map (640 channels at stride
    16 for InternImage-L; with post-norm no stage-end norm) as their C4
    map; stage 4 and its downsampling are not built, as res5 runs on the
    RoIs in its place, and res5's first block projects 640 to 1024
    channels;
  * the offset and mask projections are initialised by the weights' rule
    (``harness/weights.py``), not InternImage's zeros: under zeros every
    block is a fixed dilated 3×3 box filter;
  * parameter names are the port's (``levels.{i}.blocks.{j}.dcn.dw_conv``
    and ``.dw_norm`` for the ``dw_conv`` Sequential's convolution and norm,
    ``patch_embed.norm1`` for ``norm1``'s LayerNorm, ``levels.{i}.
    downsample.norm``), so one state dict loads into both;
  * drop path (0.4 for InternImage-L) is training-only and absent;
  * images come as FGN's canvases, NHWC.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import nets
from benchmark.reference.fgn import RefFGN
from benchmark.reference.precision import QUANTIZERS
from benchmark.reference.swin import LayerNorm, Mlp, RefSwinFGN

GROUP_CHANNELS = 16


def dcn_core(v, offset, mask_logits, group: int, k: int, s: float):
    """DCNv3's sampling from its equations: ``v`` (B, H, W, C), ``offset``
    (B, H, W, G·k²·2), ``mask_logits`` (B, H, W, G·k²) → (B, H, W, C)."""
    B, H, W, C = v.shape
    G, P, gc = group, k * k, C // group
    m = F.softmax(mask_logits.reshape(B, H, W, G, P), -1)
    d = offset.reshape(B, H, W, G, P, 2)
    vg = v.reshape(B, H * W, G, gc)
    dev = v.device
    b = torch.arange(B, device=dev).view(B, 1, 1, 1)
    g = torch.arange(G, device=dev).view(1, 1, 1, G)
    y0 = torch.arange(H, device=dev, dtype=v.dtype).view(1, H, 1, 1)
    x0 = torch.arange(W, device=dev, dtype=v.dtype).view(1, 1, W, 1)
    c = (k - 1) // 2
    out = torch.zeros(B, H, W, G, gc, device=dev, dtype=v.dtype)
    for p in range(P):
        i, j = divmod(p, k)
        x = x0 + s * (i - c + d[..., p, 0])
        y = y0 + s * (j - c + d[..., p, 1])
        xf, yf = torch.floor(x), torch.floor(y)
        for cy in (yf, yf + 1):
            for cx in (xf, xf + 1):
                w = (1 - (x - cx).abs()) * (1 - (y - cy).abs())
                inside = (cx >= 0) & (cx <= W - 1) & (cy >= 0) & (cy <= H - 1)
                zero = torch.zeros_like(w)
                idx = torch.where(inside, cy * W + cx, zero).long()
                w = torch.where(inside, m[..., p] * w, zero)
                out += w[..., None] * vg[b, idx, g]
    return out.reshape(B, H, W, C)


class Conv3x3(nn.Module):
    """``nn.Conv2d(cin, cout, 3, stride, padding=1, groups=groups)`` on NCHW."""

    def __init__(self, cin: int, cout: int, stride: int = 1, groups: int = 1,
                 bias: bool = True, q=lambda x: x):
        super().__init__()
        self.stride = stride
        self.groups = groups
        self.q = q
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        return F.conv2d(self.q(x), self.q(self.weight), self.bias, stride=self.stride,
                        padding=1, groups=self.groups)


class DCNv3(nn.Module):
    """``DCNv3_pytorch``: channels-last in and out."""

    def __init__(self, channels: int, group: int, kernel_size: int, offset_scale: float,
                 eps: float, q):
        super().__init__()
        self.group = group
        self.kernel_size = kernel_size
        self.offset_scale = offset_scale
        P = kernel_size * kernel_size
        self.input_proj = nets.Linear(channels, channels, q=q)
        self.dw_conv = Conv3x3(channels, channels, groups=channels, q=q)
        self.dw_norm = LayerNorm(channels, eps)
        self.offset = nets.Linear(channels, group * P * 2, q=q)
        self.mask = nets.Linear(channels, group * P, q=q)
        self.output_proj = nets.Linear(channels, channels, q=q)

    def forward(self, input):
        x = self.input_proj(input)
        x1 = self.dw_conv(input.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        x1 = F.gelu(self.dw_norm(x1))
        offset = self.offset(x1)
        mask = self.mask(x1)
        x = dcn_core(x, offset, mask, self.group, self.kernel_size, self.offset_scale)
        return self.output_proj(x)


class InternImageLayer(nn.Module):
    """Post-norm with layer scale: ``x + γ₁·LN₁(DCN(x))``, then
    ``x + γ₂·LN₂(MLP(x))``."""

    def __init__(self, channels: int, group: int, b: Dict, q):
        super().__init__()
        eps = b["ln_eps"]
        self.dcn = DCNv3(channels, group, b["kernel_size"], b["offset_scale"], eps, q)
        self.norm1 = LayerNorm(channels, eps)
        self.mlp = Mlp(channels, int(channels * b["mlp_ratio"]), q)
        self.norm2 = LayerNorm(channels, eps)
        self.gamma1 = nn.Parameter(b["layer_scale"] * torch.ones(channels))
        self.gamma2 = nn.Parameter(b["layer_scale"] * torch.ones(channels))

    def forward(self, x):
        x = x + self.gamma1 * self.norm1(self.dcn(x))
        return x + self.gamma2 * self.norm2(self.mlp(x))


class DownsampleLayer(nn.Module):
    def __init__(self, channels: int, eps: float, q):
        super().__init__()
        self.conv = Conv3x3(channels, 2 * channels, stride=2, bias=False, q=q)
        self.norm = LayerNorm(2 * channels, eps)

    def forward(self, x):
        return self.norm(self.conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1))


class InternImageBlock(nn.Module):
    def __init__(self, channels: int, depth: int, group: int, downsample: bool, b: Dict, q):
        super().__init__()
        self.blocks = nn.ModuleList(InternImageLayer(channels, group, b, q)
                                    for _ in range(depth))
        self.downsample = DownsampleLayer(channels, b["ln_eps"], q) if downsample else None


class StemLayer(nn.Module):
    def __init__(self, out_chans: int, eps: float, q):
        super().__init__()
        self.conv1 = Conv3x3(3, out_chans // 2, stride=2, q=q)
        self.norm1 = LayerNorm(out_chans // 2, eps)
        self.conv2 = Conv3x3(out_chans // 2, out_chans, stride=2, q=q)
        self.norm2 = LayerNorm(out_chans, eps)

    def forward(self, x):  # NCHW → NHWC
        x = self.norm1(self.conv1(x).permute(0, 2, 3, 1))
        x = self.conv2(F.gelu(x).permute(0, 3, 1, 2))
        return self.norm2(x.permute(0, 2, 3, 1))


class InternImage(nn.Module):
    """(B, H, W, 3) → (B, H/16, W/16, C) NHWC, stage ``out_stage``'s map
    after its blocks; ``b``: the configuration's ``backbone`` block."""

    def __init__(self, b: Dict, frozen: bool = False, q=lambda x: x):
        super().__init__()
        if not b["post_norm"] or b["kernel_size"] != 3:
            raise ValueError(f"the reference builds InternImage's post-norm blocks "
                             f"with 3×3 DCNv3 grids: {b}")
        self.frozen = frozen
        C, n = b["channels"], b["out_stage"]
        for i in range(n):
            if C * 2 ** i != GROUP_CHANNELS * b["groups"][i]:
                raise ValueError(f"DCNv3 groups hold {GROUP_CHANNELS} channels: {b}")
        self.patch_embed = StemLayer(C, b["ln_eps"], q)
        self.levels = nn.ModuleList(
            InternImageBlock(C * 2 ** i, b["depths"][i], b["groups"][i], i < n - 1, b, q)
            for i in range(n))

    def forward(self, x):
        x = self.patch_embed(nets.nchw(x))
        for level in self.levels:
            for blk in level.blocks:
                x = blk(x)
            if level.downsample is not None:
                x = level.downsample(x)
        return x.detach() if self.frozen else x


class RefInternImageFGN(RefFGN):
    """``RefFGN`` with InternImage as its backbone: ``model_cfg`` and
    ``backbone_cfg`` are the configuration's ``model`` and ``backbone``
    blocks. The C4 map's width enters ``rpn_conv`` and res5's first block
    (a projection shortcut to 1024); the support and RoI features keep
    res5's width, as ``RefSwinFGN``'s."""

    count_spp = RefSwinFGN.count_spp
    bbox_feats = RefSwinFGN.bbox_feats

    def __init__(self, model_cfg: Dict, backbone_cfg: Dict, precision: str = "f32"):
        super().__init__(model_cfg, precision)
        q = QUANTIZERS[precision]
        b = backbone_cfg
        c4 = b["channels"] * 2 ** (b["out_stage"] - 1)
        self.backbone = InternImage(b, frozen=model_cfg["backbone_frozen"], q=q)
        self.rpn_conv = nets.Conv2d(c4, self.c["feat_channels"], 3, q=q)
        self.shared5.res5 = nets.ResLayer(c4, 512, 3, 1, expansion=2,
                                          norm=self.c.get("res5_norm", "gn"), q=q)
