"""The plain reference of FGN on the Swin Transformer backbone (Liu et al.,
*Swin Transformer: Hierarchical Vision Transformer using Shifted
Windows*, ICCV 2021, arXiv:2103.14030), in float32.

The backbone is the detection code's forward written out in plain torch
(mmdetection ``models/backbones/swin.py``: ``WindowMSA``,
``ShiftWindowMSA``, ``SwinBlock``, ``SwinBlockSequence``,
``SwinTransformer``; ``Swin-Transformer-Object-Detection``
``mmdet/models/backbones/swin_transformer.py``: ``PatchEmbed``,
``PatchMerging``), with Swin-L's published settings coming from the
configuration file (``mask2former_swin-l-p4-w12-384-in21k``): the
relative position index from ``double_step_seq`` and its flip, the
attention mask from the nine slices of the padded grid, each window's
scores, bias, mask, softmax and ·v a tensor in memory. The heads are
``RefFGN``'s with the C4 map's width where it enters them (``rpn_conv``
and res5's first block). Every convolution and linear layer takes the
precision's quantizer, as in ``nets.py``; the caller turns TF32 off
(``precision.strict_f32``).

Departures from the published code, each deliberate:

  * the C4 wiring: FGN's heads take stage 3's map after its output norm
    (``norm2``, 768 channels at stride 16 for Swin-L) as their C4 map;
    stage 4 and its norm are not built, as res5 runs on the RoIs in its
    place, and res5's first block projects 768 to 1024 channels;
  * PatchMerging concatenates the 2×2 neighbours in the official order
    (x0 = [0::2, 0::2], x1 = [1::2, 0::2], x2 = [0::2, 1::2],
    x3 = [1::2, 1::2]); mmdetection's ``nn.Unfold`` takes the same
    entries in another order of the 4C channels, which its checkpoint
    converter reorders;
  * parameter names are the port's (``stages.{i}.blocks.{j}.attn.qkv``,
    ``patch_embed.proj``, ``stages.{i}.downsample.reduction``), so one
    state dict loads into both; the relative position index is computed,
    not a buffer;
  * drop path (0.3 for Swin-L) is training-only and absent;
  * images come as FGN's canvases, NHWC.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import nets, ops
from benchmark.reference.fgn import ROI_OUT, RefFGN, _mask_float
from benchmark.reference.precision import QUANTIZERS


def double_step_seq(step1: int, len1: int, step2: int, len2: int):
    seq1 = torch.arange(0, step1 * len1, step1)
    seq2 = torch.arange(0, step2 * len2, step2)
    return (seq1[:, None] + seq2[None, :]).reshape(1, -1)


def relative_position_index(window: int):
    Wh = Ww = window
    rel_index_coords = double_step_seq(2 * Ww - 1, Wh, 1, Ww)
    rel_position_index = rel_index_coords + rel_index_coords.T
    return rel_position_index.flip(1).contiguous()


def window_partition(x, window_size: int):
    B, H, W, C = x.shape
    x = x.view(B, H // window_size, window_size, W // window_size, window_size, C)
    windows = x.permute(0, 1, 3, 2, 4, 5).contiguous()
    return windows.view(-1, window_size, window_size, C)


def window_reverse(windows, H: int, W: int, window_size: int):
    B = int(windows.shape[0] / (H * W / window_size / window_size))
    x = windows.view(B, H // window_size, W // window_size, window_size, window_size, -1)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(B, H, W, -1)


def shifted_window_mask(H_pad: int, W_pad: int, window_size: int, shift_size: int, device):
    img_mask = torch.zeros((1, H_pad, W_pad, 1), device=device)
    h_slices = (slice(0, -window_size), slice(-window_size, -shift_size),
                slice(-shift_size, None))
    w_slices = (slice(0, -window_size), slice(-window_size, -shift_size),
                slice(-shift_size, None))
    cnt = 0
    for h in h_slices:
        for w in w_slices:
            img_mask[:, h, w, :] = cnt
            cnt += 1
    mask_windows = window_partition(img_mask, window_size)
    mask_windows = mask_windows.view(-1, window_size * window_size)
    attn_mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
    return attn_mask.masked_fill(attn_mask != 0, float(-100.0)).masked_fill(
        attn_mask == 0, float(0.0))


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return F.layer_norm(x, (x.shape[-1],), self.weight, self.bias, self.eps)


class WindowMSA(nn.Module):
    def __init__(self, embed_dims: int, num_heads: int, window_size: int, q):
        super().__init__()
        self.window_size = window_size
        self.num_heads = num_heads
        self.scale = (embed_dims // num_heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.qkv = nets.Linear(embed_dims, embed_dims * 3, q=q)
        self.proj = nets.Linear(embed_dims, embed_dims, q=q)

    def forward(self, x, mask=None):
        B, N, C = x.shape
        qkv = self.qkv(x).reshape(B, N, 3, self.num_heads, C // self.num_heads)
        qkv = qkv.permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        q = q * self.scale
        attn = q @ k.transpose(-2, -1)
        index = relative_position_index(self.window_size).to(x.device)
        relative_position_bias = self.relative_position_bias_table[index.view(-1)].view(
            self.window_size ** 2, self.window_size ** 2, -1)
        relative_position_bias = relative_position_bias.permute(2, 0, 1).contiguous()
        attn = attn + relative_position_bias.unsqueeze(0)
        if mask is not None:
            nW = mask.shape[0]
            attn = attn.view(B // nW, nW, self.num_heads, N, N) + mask.unsqueeze(1).unsqueeze(0)
            attn = attn.view(-1, self.num_heads, N, N)
        attn = attn.softmax(dim=-1)
        x = (attn @ v).transpose(1, 2).reshape(B, N, C)
        return self.proj(x)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, q):
        super().__init__()
        self.fc1 = nets.Linear(dim, hidden, q=q)
        self.fc2 = nets.Linear(hidden, dim, q=q)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    """``SwinBlock`` with ``ShiftWindowMSA``'s padding, roll and mask."""

    def __init__(self, dim: int, num_heads: int, mlp_dim: int, window_size: int,
                 shift: bool, eps: float, q):
        super().__init__()
        self.window_size = window_size
        self.shift_size = window_size // 2 if shift else 0
        self.norm1 = LayerNorm(dim, eps)
        self.attn = WindowMSA(dim, num_heads, window_size, q)
        self.norm2 = LayerNorm(dim, eps)
        self.mlp = Mlp(dim, mlp_dim, q)

    def shift_window_msa(self, query, hw_shape):
        B, L, C = query.shape
        H, W = hw_shape
        ws = self.window_size
        query = query.view(B, H, W, C)
        pad_r = (ws - W % ws) % ws
        pad_b = (ws - H % ws) % ws
        query = F.pad(query, (0, 0, 0, pad_r, 0, pad_b))
        H_pad, W_pad = query.shape[1], query.shape[2]
        if self.shift_size > 0:
            shifted_query = torch.roll(query, shifts=(-self.shift_size, -self.shift_size),
                                       dims=(1, 2))
            attn_mask = shifted_window_mask(H_pad, W_pad, ws, self.shift_size, query.device)
        else:
            shifted_query = query
            attn_mask = None
        query_windows = window_partition(shifted_query, ws).view(-1, ws ** 2, C)
        attn_windows = self.attn(query_windows, mask=attn_mask)
        attn_windows = attn_windows.view(-1, ws, ws, C)
        shifted_x = window_reverse(attn_windows, H_pad, W_pad, ws)
        if self.shift_size > 0:
            x = torch.roll(shifted_x, shifts=(self.shift_size, self.shift_size), dims=(1, 2))
        else:
            x = shifted_x
        if pad_r > 0 or pad_b > 0:
            x = x[:, :H, :W, :].contiguous()
        return x.view(B, H * W, C)

    def forward(self, x, hw_shape):
        identity = x
        x = self.norm1(x)
        x = self.shift_window_msa(x, hw_shape)
        x = x + identity
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim: int, eps: float, q):
        super().__init__()
        self.q = q
        self.norm = LayerNorm(4 * dim, eps)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x, hw_shape):
        H, W = hw_shape
        B, L, C = x.shape
        x = x.view(B, H, W, C)
        if (H % 2 == 1) or (W % 2 == 1):
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x0 = x[:, 0::2, 0::2, :]
        x1 = x[:, 1::2, 0::2, :]
        x2 = x[:, 0::2, 1::2, :]
        x3 = x[:, 1::2, 1::2, :]
        x = torch.cat([x0, x1, x2, x3], -1)
        out_hw = (x.shape[1], x.shape[2])
        x = self.norm(x.view(B, -1, 4 * C))
        return F.linear(self.q(x), self.q(self.reduction.weight)), out_hw


class Stage(nn.Module):
    def __init__(self, dim: int, depth: int, num_heads: int, mlp_dim: int,
                 window_size: int, eps: float, merge: bool, q):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dim, num_heads, mlp_dim, window_size, i % 2 == 1, eps, q)
            for i in range(depth))
        self.downsample = PatchMerging(dim, eps, q) if merge else None


class PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch: int, eps: float, q):
        super().__init__()
        self.patch = patch
        self.q = q
        self.proj = nn.Module()
        self.proj.weight = nn.Parameter(torch.empty(dim, 3, patch, patch))
        self.proj.bias = nn.Parameter(torch.zeros(dim))
        self.norm = LayerNorm(dim, eps)

    def forward(self, x):  # NHWC → (B, L, C), (h, w)
        _, H, W, _ = x.shape
        x = nets.nchw(x)
        if W % self.patch != 0:
            x = F.pad(x, (0, self.patch - W % self.patch))
        if H % self.patch != 0:
            x = F.pad(x, (0, 0, 0, self.patch - H % self.patch))
        x = F.conv2d(self.q(x), self.q(self.proj.weight), self.proj.bias, stride=self.patch)
        hw = (x.shape[2], x.shape[3])
        x = x.flatten(2).transpose(1, 2)
        return self.norm(x), hw


class SwinTransformer(nn.Module):
    """(B, H, W, 3) → (B, H/16, W/16, C) NHWC after stage ``out_stage``'s
    norm; ``b``: the configuration's ``backbone`` block."""

    def __init__(self, b: Dict, frozen: bool = False, q=lambda x: x):
        super().__init__()
        self.frozen = frozen
        D, eps, n = b["embed_dim"], b["ln_eps"], b["out_stage"]
        self.patch_embed = PatchEmbed(D, b["patch_size"], eps, q)
        self.stages = nn.ModuleList(
            Stage(D * 2 ** i, b["depths"][i], b["num_heads"][i],
                  int(D * 2 ** i * b["mlp_ratio"]), b["window_size"], eps, i < n - 1, q)
            for i in range(n))
        self.out_norm = f"norm{n - 1}"
        setattr(self, self.out_norm, LayerNorm(D * 2 ** (n - 1), eps))

    def forward(self, x):
        B = x.shape[0]
        x, hw = self.patch_embed(x)
        for stage in self.stages:
            for blk in stage.blocks:
                x = blk(x, hw)
            if stage.downsample is not None:
                x, hw = stage.downsample(x, hw)
        x = getattr(self, self.out_norm)(x).view(B, hw[0], hw[1], -1)
        return x.detach() if self.frozen else x


class RefSwinFGN(RefFGN):
    """``RefFGN`` with the Swin as its backbone: ``model_cfg`` and
    ``backbone_cfg`` are the configuration's ``model`` and ``backbone``
    blocks. The C4 map's width enters ``rpn_conv`` and res5's first block
    (a projection shortcut to 1024); the support and RoI features keep
    res5's width."""

    def __init__(self, model_cfg: Dict, backbone_cfg: Dict, precision: str = "f32"):
        super().__init__(model_cfg, precision)
        q = QUANTIZERS[precision]
        b = backbone_cfg
        c4 = b["embed_dim"] * 2 ** (b["out_stage"] - 1)
        self.backbone = SwinTransformer(b, frozen=model_cfg["backbone_frozen"], q=q)
        self.rpn_conv = nets.Conv2d(c4, self.c["feat_channels"], 3, q=q)
        self.shared5.res5 = nets.ResLayer(c4, 512, 3, 1, expansion=2,
                                          norm=self.c.get("res5_norm", "gn"), q=q)

    def count_spp(self, spp, spp_boxes, spp_masks):
        """→ support maps (B, N, 7, 7, 1024), mask-pooled vectors (B, N, 1024)."""
        B, N, K, hs, ws, C = spp.shape
        S = spp_masks.shape[-1]
        rois = spp_boxes.reshape(B * N * K, 1, 4).to(torch.float32)
        masks = ops.roi_align(_mask_float(spp_masks).reshape(B * N * K, S, S, 1),
                              rois, ROI_OUT, 1.0)
        fm = ops.roi_align(spp.reshape(B * N * K, hs, ws, C), rois, ROI_OUT,
                           1.0 / self.c["stride"])
        feats = self.shared5(fm.reshape(B * N * K, ROI_OUT, ROI_OUT, C))
        feats = feats.reshape(B, N, K, ROI_OUT, ROI_OUT, -1)
        vecs = (feats * masks.reshape(B, N, K, ROI_OUT, ROI_OUT, 1)).mean(dim=(2, 3, 4))
        return feats.mean(dim=2), vecs

    def bbox_feats(self, qry, rois):
        B, R = rois.shape[:2]
        C = qry.shape[-1]
        f = ops.roi_align(qry, rois, ROI_OUT, 1.0 / self.c["stride"])
        return self.shared5(f.reshape(B * R, ROI_OUT, ROI_OUT, C)).reshape(
            B, R, ROI_OUT, ROI_OUT, -1)
