"""The least work of DCNv3's core, from its shapes: the softmax over each
group's k² mask logits, the bilinear sample of every point and channel at
its learned location, and the weighted sum, counted on the mathematics,
whatever computes it (a composition of library ops that builds its
corners' rows and weights in memory, or one kernel that keeps them in
registers).

FLOPs: 10 a sample and channel, a sample being one point of one group at
one pixel (B·H·W·G·k²) and a channel one of its group's 16: the bilinear
interpolation's 4 multiply-adds (8) and the point's weighting and sum
(2). Bytes: the value map read once, the offsets and the mask logits read
once and the output (the value map's shape and dtype) written once. The
least time is the larger of FLOPs over the card's peak and bytes over its
bandwidth.
"""

from __future__ import annotations

from typing import Dict, Sequence

FLOPS = 10  # a sample and channel: bilinear 8, weighting and sum 2
GROUP_CHANNELS = 16


def _numel(shape: Sequence[int]) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def dcn_samples(value: Sequence[int], mask: Sequence[int]) -> int:
    """B·H·W·G·k²: ``value`` (B, H, W, C), ``mask`` (B, H, W, G·k²)."""
    return _numel(value[:3]) * mask[3]


def dcn_flops(value: Sequence[int], mask: Sequence[int]) -> int:
    return FLOPS * GROUP_CHANNELS * dcn_samples(value, mask)


def dcn_bytes(value: Dict, offset: Dict, mask: Dict) -> int:
    """Each a call's record of its shape and item size."""
    def nbytes(d):
        return d["itemsize"] * _numel(d["shape"])
    return 2 * nbytes(value) + nbytes(offset) + nbytes(mask)


def roofline_s(call: Dict, peak_flops: float, hbm_bytes_s: float) -> float:
    """The least seconds of one ``DCNv3.dcn_core`` call, from the span's
    record of its arguments (value, offset, mask logits)."""
    value, offset, mask = call["args"][:3]
    return max(dcn_flops(value["shape"], mask["shape"]) / peak_flops,
               dcn_bytes(value, offset, mask) / hbm_bytes_s)


def grids(H: int, W: int, stages: int):
    """The (h, w) of each stage's map for an H×W input: the stem's two and
    each downsampling's stride-2, pad-1 3×3 convolutions halve a side,
    rounding up."""
    h, w = -(-H // 4), -(-W // 4)
    out = []
    for _ in range(stages):
        out.append((h, w))
        h, w = -(-h // 2), -(-w // 2)
    return out


def backbone_flops(backbone: Dict, H: int, W: int) -> int:
    """The DCN cores' FLOPs of one H×W image through the built stages:
    every block's, at its stage's grid and width."""
    b = backbone
    k2 = b["kernel_size"] ** 2
    return sum(FLOPS * b["depths"][s] * h * w * k2 * b["channels"] * 2 ** s
               for s, (h, w) in enumerate(grids(H, W, b["out_stage"])))
