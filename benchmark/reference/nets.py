"""Layers of the plain reference: ResNet-50-C4, the shared res5 head and
the FGN heads' convolutions, in float32 PyTorch.

Frozen from the port's ``models/resnet.py`` and ``models/fgn.py`` layers;
the module names are the port's, so one state dict loads into both. Every
parameter is float32 and every operation runs in float32; the caller turns
TF32 off (``reference.precision.strict_f32``).

Each convolution and linear layer takes a quantizer ``q`` (identity for
the reference itself) that it applies to its input and its weight: the
lower-precision control passes ``precision.fp8`` there.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _same(x):
    return x


def _same_pads(size: int, k: int, s: int):
    """flax 'SAME' padding, asymmetric for stride 2 (lo = total // 2)."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class Conv2d(nn.Module):
    """'SAME'-padded convolution on NCHW tensors; weight OIHW."""

    def __init__(self, cin, cout, k, stride=1, bias=True, q=_same):
        super().__init__()
        self.stride = stride
        self.q = q
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        k = self.weight.shape[-1]
        (pt, pb), (pl, pr) = (_same_pads(x.shape[2], k, self.stride),
                              _same_pads(x.shape[3], k, self.stride))
        x = F.pad(x, (pl, pr, pt, pb))
        return F.conv2d(self.q(x), self.q(self.weight), self.bias,
                        stride=self.stride)


class ConvTranspose2d(nn.Module):
    """Transposed convolution with kernel = stride; weight (in, out, k, k)."""

    def __init__(self, cin, cout, k, q=_same):
        super().__init__()
        self.q = q
        self.weight = nn.Parameter(torch.empty(cin, cout, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        k = self.weight.shape[-1]
        return F.conv_transpose2d(self.q(x), self.q(self.weight), self.bias,
                                  stride=k)


class Linear(nn.Module):
    """Dense layer; weight (out, in)."""

    def __init__(self, cin, cout, q=_same):
        super().__init__()
        self.q = q
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return F.linear(self.q(x), self.q(self.weight), self.bias)


def conv1x1_nhwc(conv: Conv2d, x):
    """A 1×1 convolution on the channel axis of an NHWC tensor of any rank."""
    w = conv.weight[:, :, 0, 0]
    return F.linear(conv.q(x), conv.q(w), conv.bias)


class GroupNorm(nn.Module):
    def __init__(self, num_groups, features, eps=1e-5):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):  # NCHW
        return F.group_norm(x, self.num_groups, self.weight, self.bias,
                            self.eps)


class FrozenAffine(nn.Module):
    """A folded BatchNorm: per-channel scale and bias."""

    def __init__(self, features):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):  # NCHW
        return x * self.weight[:, None, None] + self.bias[:, None, None]


def make_norm(norm: str, features: int):
    if norm == "gn":
        return GroupNorm(32 if features % 32 == 0 else features, features)
    if norm in ("frozen_bn", "bn"):
        return FrozenAffine(features)
    raise ValueError(f"unknown norm {norm!r}")


class Bottleneck(nn.Module):
    """Stride on the 3×3 convolution; avg-down shortcut when asked."""

    def __init__(self, inplanes, planes, stride, expansion, norm, avg_down,
                 has_downsample, q):
        super().__init__()
        out_ch = planes * expansion
        self.stride = stride
        self.avg_down = avg_down
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False, q=q)
        self.bn1 = make_norm(norm, planes)
        self.conv2 = Conv2d(planes, planes, 3, stride, bias=False, q=q)
        self.bn2 = make_norm(norm, planes)
        self.conv3 = Conv2d(planes, out_ch, 1, bias=False, q=q)
        self.bn3 = make_norm(norm, out_ch)
        self.has_downsample = has_downsample
        if has_downsample:
            ds_stride = 1 if (avg_down and stride > 1) else stride
            self.ds_conv = Conv2d(inplanes, out_ch, 1, ds_stride, bias=False,
                                  q=q)
            self.ds_bn = make_norm(norm, out_ch)

    def forward(self, x):
        identity = x
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.has_downsample:
            if self.avg_down and self.stride > 1:
                identity = F.avg_pool2d(identity, self.stride, self.stride)
            identity = self.ds_bn(self.ds_conv(identity))
        return F.relu(y + identity)


class ResLayer(nn.Module):
    def __init__(self, inplanes, planes, num_blocks, stride=1, expansion=4,
                 norm="gn", avg_down=False, q=_same):
        super().__init__()
        out_ch = planes * expansion
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            s = stride if i == 0 else 1
            cin = inplanes if i == 0 else out_ch
            has_ds = i == 0 and (s != 1 or inplanes != out_ch)
            setattr(self, f"block{i}", Bottleneck(
                cin, planes, s, expansion, norm, avg_down, has_ds, q))

    def forward(self, x):
        for i in range(self.num_blocks):
            x = getattr(self, f"block{i}")(x)
        return x


def nchw(x):
    return x.permute(0, 3, 1, 2)


def nhwc(x):
    return x.permute(0, 2, 3, 1)


class ResNetC4(nn.Module):
    """Stem and stages 1-3: (B, H, W, 3) → (B, H/16, W/16, 1024), NHWC.
    A frozen backbone passes no gradient."""

    def __init__(self, norm="gn", frozen=False, deep_stem=False,
                 avg_down=False, q=_same):
        super().__init__()
        self.frozen = frozen
        self.deep_stem = deep_stem
        if deep_stem:
            self.stem_conv1 = Conv2d(3, 32, 3, 2, bias=False, q=q)
            self.stem_bn1 = make_norm(norm, 32)
            self.stem_conv2 = Conv2d(32, 32, 3, bias=False, q=q)
            self.stem_bn2 = make_norm(norm, 32)
            self.stem_conv3 = Conv2d(32, 64, 3, bias=False, q=q)
            self.stem_bn3 = make_norm(norm, 64)
        else:
            self.conv1 = Conv2d(3, 64, 7, 2, bias=False, q=q)
            self.bn1 = make_norm(norm, 64)
        self.layer1 = ResLayer(64, 64, 3, 1, norm=norm, avg_down=avg_down,
                               q=q)
        self.layer2 = ResLayer(256, 128, 4, 2, norm=norm, avg_down=avg_down,
                               q=q)
        self.layer3 = ResLayer(512, 256, 6, 2, norm=norm, avg_down=avg_down,
                               q=q)

    def forward(self, x):  # NHWC
        x = nchw(x)
        if self.deep_stem:
            x = F.relu(self.stem_bn1(self.stem_conv1(x)))
            x = F.relu(self.stem_bn2(self.stem_conv2(x)))
            x = F.relu(self.stem_bn3(self.stem_conv3(x)))
        else:
            x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        x = self.layer3(self.layer2(self.layer1(x)))
        if self.frozen:
            x = x.detach()
        return nhwc(x)


class SharedRes5(nn.Module):
    """res5 with expansion 2, stride 1: (P, 7, 7, 1024) NHWC in and out."""

    def __init__(self, norm="gn", q=_same):
        super().__init__()
        self.res5 = ResLayer(1024, 512, 3, 1, expansion=2, norm=norm, q=q)

    def forward(self, x):
        return nhwc(self.res5(nchw(x)))
