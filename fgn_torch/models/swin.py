"""The Swin Transformer backbone (Liu et al., ICCV 2021, arXiv:2103.14030)
as FGN's C4 map, in PyTorch.

The equations are those of Swin's detection code (mmdetection
``models/backbones/swin.py``, ``Swin-Transformer-Object-Detection``
``mmdet/models/backbones/swin_transformer.py``), which pads every grid to
a multiple of the window and shifts every odd block, whatever the grid's
size:

  * a ``patch``×``patch`` stride-``patch`` convolution with bias over the
    input zero-padded at the bottom and right to a multiple of the patch,
    then LayerNorm; no absolute position table;
  * block j of a stage (C channels, C/32 heads, window w, shift s = w/2
    when j is odd, else 0): ``x + A(LN1(x))``, then
    ``x + fc2(GELU(fc1(LN2(x))))``, GELU exact. A zero-pads the normed map
    at the bottom and right to multiples of w (the padded tokens are keys
    and values, not masked), rolls it by (−s, −s), attends within each
    w×w window with ``softmax(q·kᵀ/√d + B[h] (+ M))·v``, and undoes the
    windows, the roll and the padding. B[h][i, j] is row
    ``(r_i − r_j + w − 1)·(2w − 1) + (c_i − c_j + w − 1)`` of the head's
    column of the learned (2w − 1)²-row table; M (shifted blocks only) is
    −100 between two tokens of a window that lie in different regions of
    the padded grid cut at −w and −s on each axis, and 0 within one;
  * PatchMerging after every stage but the last built: an odd side
    zero-padded by one, the 2×2 neighbours concatenated (x[0::2, 0::2],
    x[1::2, 0::2], x[0::2, 1::2], x[1::2, 1::2]) to 4C, LayerNorm, then a
    linear map to 2C without bias;
  * the output is stage ``out_stage``'s map after its LayerNorm (the
    detection variant's ``norm{i}``), (B, H/16, W/16, C) NHWC; the stages
    after it are not built.

Precision follows ``models/vit.py``: parameters are float32 and cast at
use; the patch convolution, every linear layer, GELU and the attention run
in ``dtype``; the residual stream (the patch embedding's norm, each
block's two sums, each merge's output) stays float32, LayerNorm takes its
statistics in float32 and the plain route's softmax runs in float32. The
map goes to the heads in ``dtype``.

Attention (``WindowAttention.swin_attend``: from q, k and v to the heads'
output before ``proj``, inside the span ``swin_attn_w`` or
``swin_attn_sw``) runs PyTorch's ``scaled_dot_product_attention`` on the
card, the gathered bias (and, in a shifted block, the region mask) added
as its attention mask in ``dtype``; the CPU runs the same mathematics in
plain form, in float32. Each shape's relative index and region mask are
built once and cached. Spans ``swin_stage1``… cover each stage's blocks,
``swin_merge`` each PatchMerging; the counters ``swin.attn_scores``
(Σ windows·heads·N², padded tokens included), ``swin.pad_tokens`` (tokens
the window padding adds), ``swin.shift_calls`` (shifted blocks run) and
``swin.bias_bytes`` (bias and mask bytes built in memory) count the work.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fgn_torch.config.swin import SwinConfig
from fgn_torch.models.resnet import Linear
from fgn_torch.models.vit import (
    LayerNorm, Mlp, PatchEmbed, window_partition, window_unpartition,
)
from fgn_torch.utils.profiling import count, span

MASK = -100.0  # the score between two regions of a shifted window
_CACHE: Dict[Tuple, torch.Tensor] = {}


def rel_index(w: int, device) -> torch.Tensor:
    """(w², w²) rows of the (2w − 1)²-row table: for tokens i, j of a w×w
    window at (r, c), ``(r_i − r_j + w − 1)·(2w − 1) + (c_i − c_j + w − 1)``."""
    key = ("index", w, str(device))
    if key not in _CACHE:
        pos = torch.arange(w * w, device=device)
        r, c = pos // w, pos % w
        _CACHE[key] = ((r[:, None] - r[None, :] + w - 1) * (2 * w - 1)
                       + c[:, None] - c[None, :] + w - 1)
    return _CACHE[key]


def region_labels(Hp: int, Wp: int, w: int, s: int, device) -> torch.Tensor:
    """(Hp, Wp) labels 0-8 of the padded grid's regions: rows (and columns)
    below ``Hp − w`` are 0, below ``Hp − s`` 1, the rest 2; a token's label
    is 3·row's + column's."""
    def axis(n):
        i = torch.arange(n, device=device)
        return (i >= n - w).long() + (i >= n - s).long()
    return 3 * axis(Hp)[:, None] + axis(Wp)[None, :]


def shift_mask(Hp: int, Wp: int, w: int, s: int, device) -> torch.Tensor:
    """(nW, w², w²) float32: ``MASK`` between tokens of a window whose
    regions differ, 0 within one; windows in ``window_partition``'s order."""
    key = ("mask", Hp, Wp, w, s, str(device))
    if key not in _CACHE:
        lab = region_labels(Hp, Wp, w, s, device)
        lab = lab.view(Hp // w, w, Wp // w, w).transpose(1, 2).reshape(-1, w * w)
        same = lab[:, :, None] == lab[:, None, :]
        _CACHE[key] = torch.where(same, 0.0, MASK).to(torch.float32)
    return _CACHE[key]


class WindowAttention(nn.Module):
    """Multi-head self-attention within w×w windows with the learned
    relative-position table: (B, nW, N, C) windows in and out."""

    def __init__(self, dim: int, heads: int, window: int, dtype=torch.float32):
        super().__init__()
        self.heads = heads
        self.window = window
        self.dt = dtype
        self.qkv = Linear(dim, 3 * dim, dtype)
        self.proj = Linear(dim, dim, dtype)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        B, nW, N, C = x.shape
        qkv = self.qkv(x).view(B, nW, N, 3, self.heads, C // self.heads)
        q, k, v = qkv.permute(3, 0, 1, 4, 2, 5).unbind(0)  # (B, nW, heads, N, d)
        out = self.swin_attend(q, k, v, self.relative_position_bias_table, mask)
        return self.proj(out.transpose(2, 3).reshape(B, nW, N, C))

    def swin_attend(self, q, k, v, table, mask):
        """softmax(q·kᵀ/√d + B[h] (+ M))·v → (B, nW, heads, N, d); ``table``
        the ((2w − 1)², heads) parameter, ``mask`` (nW, N, N) or None."""
        B, nW, nh, N, d = q.shape
        with span("swin_attn_sw" if mask is not None else "swin_attn_w"):
            bias = table.t()[:, rel_index(self.window, table.device)]  # (heads, N, N)
            built = bias.numel() * bias.element_size()
            if q.is_cuda:
                if mask is None:
                    m = bias.to(q.dtype)[None]  # broadcast over every window
                else:  # every window of every image: SDPA's mask has one batch axis
                    m = bias.to(q.dtype)[None] + mask.to(q.dtype)[:, None]
                    built += m.numel() * m.element_size()
                    m = m.expand(B, -1, -1, -1, -1).reshape(B * nW, nh, N, N)
                built += m.numel() * m.element_size()
                out = F.scaled_dot_product_attention(
                    q.reshape(B * nW, nh, N, d), k.reshape(B * nW, nh, N, d),
                    v.reshape(B * nW, nh, N, d), attn_mask=m).view(B, nW, nh, N, d)
            else:
                ft = torch.promote_types(q.dtype, torch.float32)
                s = (q.to(ft) * d ** -0.5) @ k.to(ft).transpose(-2, -1) + bias
                if mask is not None:
                    s = s + mask[:, None]
                out = (s.softmax(dim=-1) @ v.to(ft)).to(q.dtype)
        count("swin.attn_scores", B * nW * nh * N * N)
        count("swin.bias_bytes", built)
        return out


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, shift: int, cfg: SwinConfig,
                 dtype=torch.float32):
        super().__init__()
        self.window = window
        self.shift = shift
        self.norm1 = LayerNorm(dim, cfg.ln_eps, dtype)
        self.attn = WindowAttention(dim, heads, window, dtype)
        self.norm2 = LayerNorm(dim, cfg.ln_eps, dtype)
        self.mlp = Mlp(dim, int(dim * cfg.mlp_ratio), dtype)

    def forward(self, x):  # (B, H, W, C) float32
        B, H, W, C = x.shape
        w, s = self.window, self.shift
        y = self.norm1(x)
        ph, pw = -H % w, -W % w
        if ph or pw:
            y = F.pad(y, (0, 0, 0, pw, 0, ph))
        Hp, Wp = H + ph, W + pw
        count("swin.pad_tokens", B * (Hp * Wp - H * W))
        mask = None
        if s:
            y = torch.roll(y, (-s, -s), (1, 2))
            mask = shift_mask(Hp, Wp, w, s, y.device)
            count("swin.shift_calls")
        y = window_partition(y, w)[0].view(B, -1, w * w, C)
        y = self.attn(y, mask).view(-1, w, w, C)
        y = window_unpartition(y, w, (Hp, Wp), (Hp, Wp))
        if s:
            y = torch.roll(y, (s, s), (1, 2))
        x = x + y[:, :H, :W]
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    """(B, H, W, C) float32 → (B, ⌈H/2⌉, ⌈W/2⌉, 2C) float32."""

    def __init__(self, dim: int, eps: float, dtype=torch.float32):
        super().__init__()
        self.dt = dtype
        self.res_dt = torch.promote_types(dtype, torch.float32)
        self.norm = LayerNorm(4 * dim, eps, dtype)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        with span("swin_merge"):
            H, W = x.shape[1:3]
            x = x.to(self.dt)
            if H % 2 or W % 2:
                x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
            x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                           x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
            y = F.linear(self.norm(x), self.reduction.weight.to(self.dt))
            return y.to(self.res_dt)


class SwinStage(nn.Module):
    """A stage's blocks, W-MSA and SW-MSA in turn, then its PatchMerging
    where ``merge``."""

    def __init__(self, cfg: SwinConfig, i: int, merge: bool, dtype=torch.float32):
        super().__init__()
        dim, w = cfg.dim(i), cfg.window_size
        self.blocks = nn.ModuleList(
            SwinBlock(dim, cfg.num_heads[i], w, w // 2 if j % 2 else 0, cfg, dtype)
            for j in range(cfg.depths[i]))
        self.downsample = PatchMerging(dim, cfg.ln_eps, dtype) if merge else None


class Swin(nn.Module):
    """(B, H, W, 3) normalized images → (B, H/16, W/16, C) NHWC, C the
    out stage's width (768 for Swin-L). ``frozen=True`` detaches the
    output."""

    def __init__(self, cfg: SwinConfig, frozen: bool = False, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.frozen = frozen
        self.dt = dtype
        res_dt = torch.promote_types(dtype, torch.float32)  # the residual stream's
        self.patch_embed = nn.Module()
        self.patch_embed.proj = PatchEmbed(cfg.embed_dim, cfg.patch_size, dtype)
        self.patch_embed.norm = LayerNorm(cfg.embed_dim, cfg.ln_eps, res_dt)
        n = cfg.out_stage
        self.stages = nn.ModuleList(SwinStage(cfg, i, i < n - 1, dtype) for i in range(n))
        self.out_norm = f"norm{n - 1}"
        setattr(self, self.out_norm, LayerNorm(cfg.out_channels, cfg.ln_eps, dtype))

    def forward(self, x):  # NHWC
        p = self.cfg.patch_size
        H, W = x.shape[1:3]
        if H % p or W % p:
            x = F.pad(x, (0, 0, 0, -W % p, 0, -H % p))
        x = self.patch_embed.norm(self.patch_embed.proj(x))
        for i, stage in enumerate(self.stages):
            with span(f"swin_stage{i + 1}"):
                for blk in stage.blocks:
                    x = blk(x)
            if stage.downsample is not None:
                x = stage.downsample(x)
        x = getattr(self, self.out_norm)(x)
        return x.detach() if self.frozen else x
