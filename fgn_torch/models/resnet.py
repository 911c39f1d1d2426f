"""ResNet-50-C4 backbone and the FGN shared res5 head, in PyTorch, and the
layers the FGN heads and the ViT backbone share (``Conv2d``, ``Linear``).

Port of the JAX package's ``models/resnet.py``. Module names are the flax
ones (``conv1``, ``bn1``, ``layer{1..3}.block{i}.{conv,bn}{1..3}``,
``ds_conv``, ``ds_bn``, ``res5``) so ``bridge.py`` maps the param trees
name for name.

Public ``forward``s take and return NHWC tensors, as the JAX modules do;
inside, convolutions run on the NCHW view of that memory (channels_last),
an input of other strides made contiguous first: the GroupNorm kernel
takes channels_last maps only.
Params are held in float32 and cast to the compute dtype at use, as
flax's ``dtype=`` does. Convolutions pad like flax's ``'SAME'``, which is
asymmetric for stride 2 (lo = total // 2): symmetric torch padding would
differ by up to 4 in the stem.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fgn_torch.ops.group_norm_cuda import group_norm


def _same_pads(size: int, k: int, s: int):
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class Conv2d(nn.Module):
    """flax ``nn.Conv`` with 'SAME' padding on NCHW tensors. Weight OIHW."""

    def __init__(self, cin, cout, k, stride=1, bias=True,
                 dtype=torch.float32):
        super().__init__()
        self.stride = stride
        self.dt = dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        k = self.weight.shape[-1]
        (pt, pb), (pl, pr) = (
            _same_pads(x.shape[2], k, self.stride),
            _same_pads(x.shape[3], k, self.stride),
        )
        pad = (pt, pl)
        if pt != pb or pl != pr:
            x = F.pad(x, (pl, pr, pt, pb))
            pad = 0
        b = None if self.bias is None else self.bias.to(self.dt)
        return F.conv2d(x.to(self.dt), self.weight.to(self.dt), b,
                        stride=self.stride, padding=pad)


class Linear(nn.Module):
    """flax ``nn.Dense``: weight (out, in) held in f32, cast at use."""

    def __init__(self, cin, cout, dtype=torch.float32):
        super().__init__()
        self.dt = dtype
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return F.linear(x.to(self.dt), self.weight.to(self.dt),
                        self.bias.to(self.dt))


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm``: statistics and affine in f32 (f64 for an f64
    input), result cast to the compute dtype; then ``+ residual`` and a
    ReLU where asked. On the card one kernel does all of it
    (``ops/group_norm_cuda.py``, K3)."""

    def __init__(self, num_groups, features, eps=1e-5, dtype=torch.float32):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.dt = dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x, residual=None, relu=False):  # NCHW
        return group_norm(x, self.num_groups, self.weight, self.bias,
                          self.eps, self.dt, residual, relu)


class FrozenAffine(nn.Module):
    """Per-channel scale + bias (a folded BatchNorm), in the input dtype;
    then ``+ residual`` and a ReLU where asked, as ``GroupNorm``."""

    def __init__(self, features):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x, residual=None, relu=False):  # NCHW
        dt = x.dtype
        y = (x * self.weight.to(dt)[:, None, None]
             + self.bias.to(dt)[:, None, None])
        if residual is not None:
            y = y + residual
        return F.relu(y) if relu else y


def make_norm(norm: str, features: int, dtype=torch.float32):
    if norm == "gn":
        groups = 32 if features % 32 == 0 else features
        return GroupNorm(groups, features, 1e-5, dtype)
    if norm in ("frozen_bn", "bn"):
        return FrozenAffine(features)
    raise ValueError(f"unknown norm {norm!r}")


class Bottleneck(nn.Module):
    """mmdet 'pytorch'-style bottleneck: stride on conv2 (3×3)."""

    def __init__(self, inplanes, planes, stride=1, expansion=4, norm="gn",
                 avg_down=False, has_downsample=False, dtype=torch.float32):
        super().__init__()
        out_ch = planes * expansion
        self.stride = stride
        self.avg_down = avg_down
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False, dtype=dtype)
        self.bn1 = make_norm(norm, planes, dtype)
        self.conv2 = Conv2d(planes, planes, 3, stride, bias=False, dtype=dtype)
        self.bn2 = make_norm(norm, planes, dtype)
        self.conv3 = Conv2d(planes, out_ch, 1, bias=False, dtype=dtype)
        self.bn3 = make_norm(norm, out_ch, dtype)
        self.has_downsample = has_downsample
        if has_downsample:
            ds_stride = 1 if (avg_down and stride > 1) else stride
            self.ds_conv = Conv2d(inplanes, out_ch, 1, ds_stride, bias=False,
                                  dtype=dtype)
            self.ds_bn = make_norm(norm, out_ch, dtype)

    def forward(self, x):  # NCHW
        y = self.bn1(self.conv1(x), relu=True)
        y = self.conv3(self.bn2(self.conv2(y), relu=True))
        identity = x
        if self.has_downsample:
            if self.avg_down and self.stride > 1:
                identity = F.avg_pool2d(identity, self.stride, self.stride)
            identity = self.ds_bn(self.ds_conv(identity))
        return self.bn3(y, identity, relu=True)


class ResLayer(nn.Module):
    def __init__(self, inplanes, planes, num_blocks, stride=1, expansion=4,
                 norm="gn", avg_down=False, dtype=torch.float32):
        super().__init__()
        out_ch = planes * expansion
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            s = stride if i == 0 else 1
            cin = inplanes if i == 0 else out_ch
            has_ds = i == 0 and (s != 1 or inplanes != out_ch)
            setattr(self, f"block{i}", Bottleneck(
                cin, planes, s, expansion, norm, avg_down, has_ds, dtype
            ))

    def forward(self, x):
        for i in range(self.num_blocks):
            x = getattr(self, f"block{i}")(x)
        return x


def _nchw(x):  # NHWC tensor → NCHW view of the same memory
    return x.permute(0, 3, 1, 2)


def _nhwc(x):  # NCHW → NHWC (a view when x is channels_last)
    return x.permute(0, 2, 3, 1)


class ResNetC4(nn.Module):
    """Stem + stages 1-3: (B, H, W, 3) → (B, H/16, W/16, 1024), NHWC.

    ``frozen=True`` detaches the output."""

    def __init__(self, norm="gn", frozen=False, deep_stem=False,
                 avg_down=False, dtype=torch.float32):
        super().__init__()
        self.frozen = frozen
        self.deep_stem = deep_stem
        if deep_stem:
            self.stem_conv1 = Conv2d(3, 32, 3, 2, bias=False, dtype=dtype)
            self.stem_bn1 = make_norm(norm, 32, dtype)
            self.stem_conv2 = Conv2d(32, 32, 3, bias=False, dtype=dtype)
            self.stem_bn2 = make_norm(norm, 32, dtype)
            self.stem_conv3 = Conv2d(32, 64, 3, bias=False, dtype=dtype)
            self.stem_bn3 = make_norm(norm, 64, dtype)
        else:
            self.conv1 = Conv2d(3, 64, 7, 2, bias=False, dtype=dtype)
            self.bn1 = make_norm(norm, 64, dtype)
        self.layer1 = ResLayer(64, 64, 3, 1, norm=norm, avg_down=avg_down,
                               dtype=dtype)
        self.layer2 = ResLayer(256, 128, 4, 2, norm=norm, avg_down=avg_down,
                               dtype=dtype)
        self.layer3 = ResLayer(512, 256, 6, 2, norm=norm, avg_down=avg_down,
                               dtype=dtype)

    def forward(self, x):  # NHWC
        x = _nchw(x.contiguous())
        if self.deep_stem:
            x = self.stem_bn1(self.stem_conv1(x), relu=True)
            x = self.stem_bn2(self.stem_conv2(x), relu=True)
            x = self.stem_bn3(self.stem_conv3(x), relu=True)
        else:
            x = self.bn1(self.conv1(x), relu=True)
        x = F.max_pool2d(x, 3, 2, padding=1)
        x = self.layer3(self.layer2(self.layer1(x)))
        if self.frozen:
            x = x.detach()
        return _nhwc(x).contiguous()


class SharedRes5(nn.Module):
    """FGN shared head: res5 ResLayer with expansion 2, stride 1,
    ``in_channels`` → 1024. (P, 7, 7, in_channels) NHWC in, (P, 7, 7, 1024)
    out; a width other than 1024 gives the first block a projection
    shortcut."""

    def __init__(self, norm="gn", dtype=torch.float32, in_channels=1024):
        super().__init__()
        self.res5 = ResLayer(in_channels, 512, 3, 1, expansion=2, norm=norm,
                             dtype=dtype)

    def forward(self, x):  # NHWC
        return _nhwc(self.res5(_nchw(x.contiguous()))).contiguous()
