"""Settings of a Swin Transformer backbone for FGN (``FGN(cfg, backbone=...)``).

A port-only dataclass, as ``ViTDetConfig`` is: ``FGNConfig`` mirrors the
JAX package's fields one for one, and that package has no Swin. The
defaults are Swin-L as its paper and its detection settings publish it
(Liu et al., arXiv:2103.14030, §3.3: C = 192, layer numbers {2, 2, 18, 2};
mmdetection ``configs/mask2former/mask2former_swin-l-p4-w12-384-in21k_*.py``
with ``models/backbones/swin.py``: heads (6, 12, 24, 48), window 12,
mlp_ratio 4, qkv bias, patch norm, no absolute position table).

``out_stage`` is the stage whose map FGN takes as its C4 map; the stages
after it are not built. Stage 3 (1-based) has stride 16 and
``embed_dim · 4`` channels: 768 for Swin-L.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    embed_dim: int = 192
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    num_heads: Tuple[int, ...] = (6, 12, 24, 48)
    window_size: int = 12
    mlp_ratio: float = 4.0
    patch_size: int = 4
    ln_eps: float = 1e-5
    out_stage: int = 3  # 1-based: the stride-16 stage that feeds FGN's heads

    def dim(self, stage: int) -> int:
        """Channels of 0-based ``stage``: ``embed_dim · 2^stage``."""
        return self.embed_dim * 2 ** stage

    @property
    def out_channels(self) -> int:
        return self.dim(self.out_stage - 1)

    @property
    def stride(self) -> int:
        return self.patch_size * 2 ** (self.out_stage - 1)
