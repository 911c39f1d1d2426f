"""Settings of a ViTDet plain-ViT backbone for FGN (``FGN(cfg, backbone=...)``).

A port-only dataclass: ``FGNConfig`` mirrors the JAX package's fields one
for one, and that package has no ViT. The defaults are ViT-L as ViTDet
publishes it (Li et al., arXiv:2203.16527; detectron2
``projects/ViTDet/configs/COCO/mask_rcnn_vitdet_l_100ep.py`` over
``mask_rcnn_vitdet_b_100ep.py``, module ``modeling/backbone/vit.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ViTDetConfig:
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    window_size: int = 14  # window attention in every block not in global_blocks
    global_blocks: Tuple[int, ...] = (5, 11, 17, 23)
    patch_size: int = 16
    pretrain_grid: int = 14  # the position table's grid: 224 px / patch 16
    img_size: int = 1024  # sets the global blocks' relative tables: 2·64 − 1 rows
    ln_eps: float = 1e-6

    @property
    def mlp_dim(self) -> int:
        return int(self.embed_dim * self.mlp_ratio)
