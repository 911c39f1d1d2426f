"""fgn_torch — FGN few-shot instance segmentation in PyTorch, with
hand-written CUDA kernels for Hopper (H100).

A port of the JAX package that sits beside it in this repository. It
imports torch, numpy, the standard library and, in its episode engine,
cv2; never JAX or the JAX package. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; on a CUDA tensor every
kernel wrapper launches its kernel or raises.
"""

from fgn_torch.config import FGNConfig

__all__ = ["FGNConfig"]
