"""ViTDet's plain ViT backbone (Li, Mao, Girshick, He, ECCV 2022,
arXiv:2203.16527) as FGN's C4 map, in PyTorch.

The equations are detectron2 ``modeling/backbone/vit.py``'s:

  * a 16×16 stride-16 patch convolution with bias, plus the absolute
    position table (its cls slot dropped, its pretraining grid resized
    bicubically to the input's, ``align_corners=False``);
  * each block ``x + Attn(LN1(x))``, then ``x + fc2(GELU(fc1(LN2(x))))``,
    GELU exact, pre-norm LayerNorm;
  * window blocks zero-pad the normed map at the bottom and right to a
    multiple of the window, attend within each window, the padded tokens
    being keys and values (their qkv is the bias alone, not masked), and
    crop back after ``proj``; the blocks of ``global_blocks`` attend over
    the whole map;
  * every block adds the decomposed relative positions to its scores:
    ``S = (q/√d)·kᵀ + q·Rh[row(q), row(k)] + q·Rw[col(q), col(k)]`` with q
    unscaled, each table resized linearly where its length differs from
    2·size − 1 (a global block over a grid other than ``img_size``'s);
  * the output is the last block's map, (B, h, w, C) NHWC, no final norm.

Compute runs in ``dtype`` (the model's compute dtype): the patch
convolution, the LayerNorms' outputs, every linear layer, GELU and the
attention; parameters are held in float32 and cast at use, as in the rest
of the port. The residual stream (the patch embedding plus the position
table, and each block's two sums) stays float32, as under detectron2's
mixed precision, where a float32 shortcut plus a half-precision branch
gives float32: rounding it to bfloat16 at each of the 48 sums compounds
through the depth. The map goes to the heads in ``dtype``. LayerNorm
takes its statistics in float32 (PyTorch's kernels accumulate a bf16
input in float32), and so does the attention's softmax.

Attention runs K4 (``ops/vit_attention_cuda.py``, ``csrc/vit_attention.cu``)
on the card: one kernel that builds the relative-position terms inside its
tiles and reads q, k and v through the qkv projection's permuted view. On
the CPU it runs the plain version: the bias built in memory
(``Attention.rel_bias``) and an f32 softmax. ``Attention.attend`` covers
the work from q, k and v to the heads' output before ``proj``, inside the
span ``attn_window`` or ``attn_global``; the counters ``vit.attn_scores``
(Σ B·heads·Tq·Tk), ``vit.attn_tokens`` (Σ B·heads·T), ``vit.bias_bytes``
(bias materialised in memory: the plain route's only), ``k4.launches`` and
``vit.pad_tokens`` (tokens the window padding adds) count it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fgn_torch.config.vit import ViTDetConfig
from fgn_torch.models.resnet import Linear, _nchw, _nhwc
from fgn_torch.ops.vit_attention_cuda import rel_bias, vit_attention
from fgn_torch.utils.profiling import count, span


def window_partition(x, ws: int):
    """(B, H, W, C) → (B·nW, ws, ws, C) windows of the map zero-padded at
    the bottom and right to multiples of ``ws``, and the padded (Hp, Wp)."""
    B, H, W, C = x.shape
    ph, pw = -H % ws, -W % ws
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    Hp, Wp = H + ph, W + pw
    x = x.view(B, Hp // ws, ws, Wp // ws, ws, C).transpose(2, 3)
    return x.reshape(-1, ws, ws, C), (Hp, Wp)


def window_unpartition(x, ws: int, pad_hw, hw):
    """``window_partition``'s inverse, cropped back to ``hw``."""
    (Hp, Wp), (H, W) = pad_hw, hw
    B = x.shape[0] // ((Hp // ws) * (Wp // ws))
    x = x.view(B, Hp // ws, Wp // ws, ws, ws, -1).transpose(2, 3)
    return x.reshape(B, Hp, Wp, -1)[:, :H, :W]


def rel_table(table, size: int):
    """detectron2's ``get_rel_pos`` for queries and keys along one axis of
    ``size`` positions: (size, size, C) rows ``table[i − j + size − 1]``,
    the (L, C) table first resized linearly to 2·size − 1 rows where L
    differs. In float32."""
    n = 2 * size - 1
    if table.shape[0] != n:
        table = F.interpolate(table.t()[None], size=n, mode="linear")[0].t()
    pos = torch.arange(size, device=table.device)
    return table[pos[:, None] - pos[None, :] + size - 1]


def abs_pos(table, grid: int, h: int, w: int):
    """detectron2's ``get_abs_pos``: the (1, grid² + 1, C) table without its
    cls slot, resized bicubically to h×w where it differs → (1, h, w, C),
    float32."""
    pos = table[:, 1:].reshape(1, grid, grid, -1)
    if (grid, grid) == (h, w):
        return pos
    pos = F.interpolate(pos.permute(0, 3, 1, 2), size=(h, w), mode="bicubic",
                        align_corners=False)
    return pos.permute(0, 2, 3, 1)


class PatchEmbed(nn.Module):
    """A ``patch``×``patch`` convolution of stride ``patch``, unpadded, with
    bias: (B, H, W, 3) → (B, H/patch, W/patch, C), both NHWC."""

    def __init__(self, dim: int, patch: int, dtype=torch.float32):
        super().__init__()
        self.patch = patch
        self.dt = dtype
        self.weight = nn.Parameter(torch.empty(dim, 3, patch, patch))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        y = F.conv2d(_nchw(x.contiguous()).to(self.dt), self.weight.to(self.dt),
                     self.bias.to(self.dt), stride=self.patch)
        return _nhwc(y)


class LayerNorm(nn.Module):
    """LayerNorm of the float32 residual stream, in ``dtype``."""

    def __init__(self, dim: int, eps: float, dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.dt = dtype
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return F.layer_norm(x.to(self.dt), x.shape[-1:], self.weight.to(self.dt),
                            self.bias.to(self.dt), self.eps)


class Attention(nn.Module):
    """Multi-head self-attention over (Bw, h, w, C) maps with decomposed
    relative positions; ``window`` 0 marks a global block."""

    def __init__(self, dim: int, heads: int, rel_len: int, window: int,
                 dtype=torch.float32):
        super().__init__()
        self.heads = heads
        self.window = window
        self.dt = dtype
        self.qkv = Linear(dim, 3 * dim, dtype)
        self.proj = Linear(dim, dim, dtype)
        self.rel_pos_h = nn.Parameter(torch.zeros(rel_len, dim // heads))
        self.rel_pos_w = nn.Parameter(torch.zeros(rel_len, dim // heads))

    def forward(self, x):
        Bw, h, w, C = x.shape
        qkv = self.qkv(x).reshape(Bw, h * w, 3, self.heads, C // self.heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)  # (Bw, heads, T, d)
        rh = rel_table(self.rel_pos_h, h).to(self.dt)
        rw = rel_table(self.rel_pos_w, w).to(self.dt)
        out = self.attend(q, k, v, rh, rw)
        return self.proj(out.transpose(1, 2).reshape(Bw, h, w, C))

    def rel_bias(self, q, rh, rw):
        """The additive bias (Bw, heads, T, T) of the plain route: q·Rh[row(q),
        row(k)] + q·Rw[col(q), col(k)], q unscaled (detectron2's
        ``add_decomposed_rel_pos``); ``rh`` (h, h, d), ``rw`` (w, w, d)."""
        return rel_bias(q, rh, rw)

    def attend(self, q, k, v, rh, rw):
        """softmax(q·kᵀ/√d + bias)·v → (Bw, heads, T, d)."""
        with span("attn_window" if self.window else "attn_global"):
            out = vit_attention(q, k, v, rh, rw, self.rel_bias)
        Bw, nh, T, _ = q.shape
        count("vit.attn_scores", Bw * nh * T * T)
        count("vit.attn_tokens", Bw * nh * T)
        return out


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype=torch.float32):
        super().__init__()
        self.fc1 = Linear(dim, hidden, dtype)
        self.fc2 = Linear(hidden, dim, dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, cfg: ViTDetConfig, window: int, rel_len: int,
                 dtype=torch.float32):
        super().__init__()
        self.window = window
        self.norm1 = LayerNorm(cfg.embed_dim, cfg.ln_eps, dtype)
        self.attn = Attention(cfg.embed_dim, cfg.num_heads, rel_len, window, dtype)
        self.norm2 = LayerNorm(cfg.embed_dim, cfg.ln_eps, dtype)
        self.mlp = Mlp(cfg.embed_dim, cfg.mlp_dim, dtype)

    def forward(self, x):  # (B, H, W, C) float32
        B, H, W, _ = x.shape
        y = self.norm1(x)
        if self.window:
            y, pad_hw = window_partition(y, self.window)
            count("vit.pad_tokens", B * (pad_hw[0] * pad_hw[1] - H * W))
        y = self.attn(y)
        if self.window:
            y = window_unpartition(y, self.window, pad_hw, (H, W))
        x = x + y
        return x + self.mlp(self.norm2(x))


class ViT(nn.Module):
    """(B, H, W, 3) normalized images, H and W multiples of the patch →
    (B, H/16, W/16, C) NHWC. ``frozen=True`` detaches the output."""

    def __init__(self, cfg: ViTDetConfig, frozen: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.frozen = frozen
        self.dt = dtype
        self.res_dt = torch.promote_types(dtype, torch.float32)  # the residual stream's
        D, P = cfg.embed_dim, cfg.patch_size
        self.patch_embed = PatchEmbed(D, P, dtype)
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.pretrain_grid ** 2 + 1, D))
        grid = cfg.img_size // P
        for i in range(cfg.depth):
            glob = i in cfg.global_blocks
            window = 0 if glob else cfg.window_size
            setattr(self, f"block{i}", Block(
                cfg, window, 2 * (grid if glob else window) - 1, dtype))

    def forward(self, x):  # NHWC
        x = self.patch_embed(x)
        h, w = x.shape[1:3]
        x = x.to(self.res_dt) + abs_pos(self.pos_embed, self.cfg.pretrain_grid, h, w)
        for i in range(self.cfg.depth):
            x = getattr(self, f"block{i}")(x)
        x = x.to(self.dt)
        return x.detach() if self.frozen else x
