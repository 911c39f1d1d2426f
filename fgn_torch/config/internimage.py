"""Settings of an InternImage backbone for FGN (``FGN(cfg, backbone=...)``).

A port-only dataclass, as ``SwinConfig`` is: ``FGNConfig`` mirrors the
JAX package's fields one for one, and that package has no InternImage.
The defaults are InternImage-L as its paper and its detection settings
publish it (Wang et al., arXiv:2211.05778: C₁ = 160, depths (5, 5, 22, 5),
groups (10, 20, 40, 80), 16 channels a group; OpenGVLab/InternImage
``detection/configs/coco/cascade_internimage_l_fpn_3x_coco.py``: core op
DCNv3, mlp_ratio 4, layer_scale 1.0, offset_scale 2.0, post_norm True).

``out_stage`` is the stage whose map FGN takes as its C4 map; the stages
after it are not built. Stage s (1-based) has ``channels · 2^(s−1)``
channels at stride ``4 · 2^(s−1)``: stage 3 of InternImage-L has 640
channels at stride 16.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class InternImageConfig:
    channels: int = 160
    depths: Tuple[int, ...] = (5, 5, 22, 5)
    groups: Tuple[int, ...] = (10, 20, 40, 80)
    mlp_ratio: float = 4.0
    kernel_size: int = 3
    offset_scale: float = 2.0
    layer_scale: float = 1.0
    post_norm: bool = True
    ln_eps: float = 1e-6
    out_stage: int = 3  # 1-based: the stride-16 stage that feeds FGN's heads

    def dim(self, stage: int) -> int:
        """Channels of 0-based ``stage``: ``channels · 2^stage``."""
        return self.channels * 2 ** stage

    @property
    def out_channels(self) -> int:
        return self.dim(self.out_stage - 1)

    @property
    def stride(self) -> int:
        return 4 * 2 ** (self.out_stage - 1)
