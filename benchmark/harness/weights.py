"""Seeded random weights, made on the device in a few large calls.

Every parameter named by the reference model gets a value: biases 0,
norm scales (1-D tensors that are not biases) 1, and every kernel a
normal truncated at two standard deviations. The heads that mmdet 2.x
initialises by a fixed normal (``HEAD_STD``: its ``RPNHead``, std 0.01;
``BBoxHead``'s ``fc_cls`` 0.01 and ``fc_reg`` 0.001, as the upstream
FGN, built on mmdet 2.18, inherits them) take that standard deviation;
every other kernel has variance 1/fan_in (flax's lecun-normal, the
port's own initialiser), fan_in being a kernel's entries per output
channel (per input channel for a transposed convolution, whose weight is
(in, out, k, k)). Without the heads' small scales, the random RPN's
logits saturate the sigmoid and its box deltas reach the clip, so that
scores tie and boxes land on the image's border. One truncated-normal
draw fills all kernels at once. The same state dict loads into the program
(``load_state_dict(strict=True)``) and into the reference.
"""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.harness.data import mix

_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated at ±2
HEAD_STD = {"rpn_conv.weight": 0.01, "rpn_cls.weight": 0.01, "rpn_reg.weight": 0.001,
            "fc_cls.weight": 0.01, "fc_reg.weight": 0.001}


def fan_in(name: str, shape) -> int:
    if name.startswith("mask_deconv.") and len(shape) == 4:
        return shape[0] * shape[2] * shape[3]
    n = 1
    for s in shape[1:]:
        n *= s
    return n


def make_state_dict(shapes: Dict[str, torch.Size], seed: int, dev) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on ``dev``} for the given parameter shapes."""
    kernels = [(n, s) for n, s in shapes.items()
               if not n.endswith("bias") and len(s) > 1]
    sizes = [torch.Size(s).numel() for _, s in kernels]
    g = torch.Generator(device=dev).manual_seed(mix(seed, "weights"))
    flat = torch.empty(sum(sizes), device=dev, dtype=torch.float32)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=g)
    stds = torch.tensor([HEAD_STD.get(n, (1.0 / fan_in(n, s)) ** 0.5) / _TRUNC_STD
                         for n, s in kernels], device=dev)
    flat.mul_(torch.repeat_interleave(stds, torch.tensor(sizes, device=dev)))
    out = {}
    for (n, s), part in zip(kernels, flat.split(sizes)):
        out[n] = part.view(s)
    for n, s in shapes.items():
        if n not in out:
            out[n] = (torch.zeros(s, device=dev) if n.endswith("bias")
                      else torch.ones(s, device=dev))
    return {n: out[n] for n in shapes}
