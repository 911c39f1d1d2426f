"""The plain reference of FGN on ViTDet's plain ViT backbone (Li, Mao,
Girshick, He, *Exploring Plain Vision Transformer Backbones for Object
Detection*, ECCV 2022, arXiv:2203.16527), in float32.

The backbone is detectron2 ``modeling/backbone/vit.py``'s forward written
out in plain torch (``get_abs_pos``, ``get_rel_pos``,
``add_decomposed_rel_pos``, ``window_partition``/``window_unpartition``,
``Attention``, ``Block``, ``ViT``), with its published ViT-L settings
coming from the configuration file (``mask_rcnn_vitdet_l_100ep.py``):
attention is q·kᵀ·scale, plus the decomposed relative positions, a
softmax and ·v, each a tensor in memory. The heads are ``RefFGN``'s.
Every convolution and linear layer takes the precision's quantizer, as in
``nets.py``; the caller turns TF32 off (``precision.strict_f32``).

Departures from detectron2, each deliberate:

  * the C4 wiring: FGN's heads take the last block's map (1024 channels,
    stride 16) as their C4 map, where ViTDet puts its SimpleFeaturePyramid
    (ViTDet's ablation of the pyramid also studies the last map alone);
  * parameter names are the port's (``block{i}``, ``patch_embed.weight``,
    ``mlp.fc1``), so one state dict loads into both;
  * drop path is training-only and absent; no cls token is run (the
    position table keeps its cls slot, dropped as ``get_abs_pos`` drops it);
  * images come as FGN's canvases, NHWC, whose sides are multiples of the
    patch (1024 px queries, 128 px supports), so the patch convolution
    needs no padding.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import nets
from benchmark.reference.fgn import RefFGN
from benchmark.reference.precision import QUANTIZERS


def get_abs_pos(abs_pos, has_cls_token: bool, hw):
    h, w = hw
    if has_cls_token:
        abs_pos = abs_pos[:, 1:]
    size = int(math.sqrt(abs_pos.shape[1]))
    if size != h or size != w:
        new = F.interpolate(abs_pos.reshape(1, size, size, -1).permute(0, 3, 1, 2),
                            size=(h, w), mode="bicubic", align_corners=False)
        return new.permute(0, 2, 3, 1)
    return abs_pos.reshape(1, h, w, -1)


def get_rel_pos(q_size: int, k_size: int, rel_pos):
    max_rel_dist = int(2 * max(q_size, k_size) - 1)
    if rel_pos.shape[0] != max_rel_dist:
        resized = F.interpolate(rel_pos.reshape(1, rel_pos.shape[0], -1).permute(0, 2, 1),
                                size=max_rel_dist, mode="linear")
        resized = resized.reshape(-1, max_rel_dist).permute(1, 0)
    else:
        resized = rel_pos
    dev = rel_pos.device
    q_coords = torch.arange(q_size, device=dev)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size, device=dev)[None, :] * max(q_size / k_size, 1.0)
    relative = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return resized[relative.long()]


def add_decomposed_rel_pos(attn, q, rel_pos_h, rel_pos_w, q_size, k_size):
    q_h, q_w = q_size
    k_h, k_w = k_size
    Rh = get_rel_pos(q_h, k_h, rel_pos_h)
    Rw = get_rel_pos(q_w, k_w, rel_pos_w)
    B, _, dim = q.shape
    r_q = q.reshape(B, q_h, q_w, dim)
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, Rh)
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, Rw)
    attn = (attn.view(B, q_h, q_w, k_h, k_w) + rel_h[:, :, :, :, None]
            + rel_w[:, :, :, None, :])
    return attn.view(B, q_h * q_w, k_h * k_w)


def window_partition(x, window_size: int):
    B, H, W, C = x.shape
    pad_h = (window_size - H % window_size) % window_size
    pad_w = (window_size - W % window_size) % window_size
    if pad_h > 0 or pad_w > 0:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.view(B, Hp // window_size, window_size, Wp // window_size, window_size, C)
    windows = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, window_size, window_size, C)
    return windows, (Hp, Wp)


def window_unpartition(windows, window_size: int, pad_hw, hw):
    Hp, Wp = pad_hw
    H, W = hw
    B = windows.shape[0] // (Hp * Wp // window_size // window_size)
    x = windows.view(B, Hp // window_size, Wp // window_size, window_size, window_size, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(B, Hp, Wp, -1)
    if Hp > H or Wp > W:
        x = x[:, :H, :W, :].contiguous()
    return x


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return F.layer_norm(x, (x.shape[-1],), self.weight, self.bias, self.eps)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, rel_len: int, q):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.qkv = nets.Linear(dim, 3 * dim, q=q)
        self.proj = nets.Linear(dim, dim, q=q)
        self.rel_pos_h = nn.Parameter(torch.zeros(rel_len, dim // num_heads))
        self.rel_pos_w = nn.Parameter(torch.zeros(rel_len, dim // num_heads))

    def forward(self, x):
        B, H, W, _ = x.shape
        qkv = self.qkv(x).reshape(B, H * W, 3, self.num_heads, -1).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.reshape(3, B * self.num_heads, H * W, -1).unbind(0)
        attn = (q * self.scale) @ k.transpose(-2, -1)
        attn = add_decomposed_rel_pos(attn, q, self.rel_pos_h, self.rel_pos_w, (H, W), (H, W))
        attn = attn.softmax(dim=-1)
        x = (attn @ v).view(B, self.num_heads, H, W, -1).permute(0, 2, 3, 1, 4)
        return self.proj(x.reshape(B, H, W, -1))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, q):
        super().__init__()
        self.fc1 = nets.Linear(dim, hidden, q=q)
        self.fc2 = nets.Linear(hidden, dim, q=q)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_dim: int, window_size: int,
                 rel_len: int, eps: float, q):
        super().__init__()
        self.window_size = window_size
        self.norm1 = LayerNorm(dim, eps)
        self.attn = Attention(dim, num_heads, rel_len, q)
        self.norm2 = LayerNorm(dim, eps)
        self.mlp = Mlp(dim, mlp_dim, q)

    def forward(self, x):
        shortcut = x
        x = self.norm1(x)
        if self.window_size > 0:
            H, W = x.shape[1], x.shape[2]
            x, pad_hw = window_partition(x, self.window_size)
        x = self.attn(x)
        if self.window_size > 0:
            x = window_unpartition(x, self.window_size, pad_hw, (H, W))
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch: int, q):
        super().__init__()
        self.q = q
        self.weight = nn.Parameter(torch.empty(dim, 3, patch, patch))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):  # NHWC → NHWC
        y = F.conv2d(self.q(nets.nchw(x)), self.q(self.weight), self.bias,
                     stride=self.weight.shape[-1])
        return nets.nhwc(y)


class ViT(nn.Module):
    """(B, H, W, 3) → (B, H/patch, W/patch, embed_dim), NHWC; ``b``: the
    configuration's ``backbone`` block."""

    def __init__(self, b: Dict, frozen: bool = False, q=lambda x: x):
        super().__init__()
        self.frozen = frozen
        D = b["embed_dim"]
        self.patch_embed = PatchEmbed(D, b["patch_size"], q)
        self.pos_embed = nn.Parameter(torch.zeros(1, b["pretrain_grid"] ** 2 + 1, D))
        grid = b["img_size"] // b["patch_size"]
        self.depth = b["depth"]
        for i in range(self.depth):
            window = 0 if i in b["global_blocks"] else b["window_size"]
            setattr(self, f"block{i}", Block(
                D, b["num_heads"], int(D * b["mlp_ratio"]), window,
                2 * (window or grid) - 1, b["ln_eps"], q))

    def forward(self, x):
        x = self.patch_embed(x)
        x = x + get_abs_pos(self.pos_embed, True, (x.shape[1], x.shape[2]))
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
        return x.detach() if self.frozen else x


class RefViTDetFGN(RefFGN):
    """``RefFGN`` with the ViT as its backbone: ``model_cfg`` and
    ``backbone_cfg`` are the configuration's ``model`` and ``backbone``
    blocks."""

    def __init__(self, model_cfg: Dict, backbone_cfg: Dict, precision: str = "f32"):
        super().__init__(model_cfg, precision)
        self.backbone = ViT(backbone_cfg, frozen=model_cfg["backbone_frozen"],
                            q=QUANTIZERS[precision])
