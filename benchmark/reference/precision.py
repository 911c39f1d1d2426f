"""Numeric settings of the reference and of its lower-precision control."""

from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0  # the largest finite float8_e4m3fn


@contextlib.contextmanager
def strict_f32():
    """TF32 off and deterministic cuDNN while the reference runs; the
    settings before are restored after, so the program runs with PyTorch's
    defaults."""
    b = torch.backends
    saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,
             b.cudnn.deterministic, b.cudnn.benchmark)
    b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = False
    b.cudnn.deterministic, b.cudnn.benchmark = True, False
    try:
        yield
    finally:
        (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,
         b.cudnn.deterministic, b.cudnn.benchmark) = saved


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale (its largest
    magnitude onto 448), back in ``x``'s dtype; the gradient passes
    straight through. The control applies it to every convolution's and
    linear layer's input and weight: a bfloat16 model computed one
    precision lower."""
    d = x.detach()
    scale = FP8_MAX / d.abs().amax().clamp(min=1e-30)
    q = (d * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale
    return x + (q - d)


def bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16, back in ``x``'s dtype, the gradient
    passing straight through: the configuration's own precision, for a
    look at what its rounding alone does."""
    d = x.detach()
    return x + (d.to(torch.bfloat16).to(x.dtype) - d)


QUANTIZERS = {"f32": lambda x: x, "fp8": fp8, "bf16": bf16}
