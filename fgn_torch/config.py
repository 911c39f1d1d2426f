"""Model + train/test hyperparameters of FGN, for the PyTorch port.

A copy of ``FGNConfig`` from the JAX package's ``models/fgn.py``, kept
here so the port imports nothing of that package. Field names and
defaults are the same, so one set of values drives both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class FGNConfig:
    """Values mirror the reference config (fgn_r50_c4_densecl.py) with two
    documented deviations: ``rpn_*_nms_pre`` is a static top-k (4096 —
    covers the ~13.5k anchors of 480px inputs; raise for COCO-scale
    800×1333 maps), and RoIAlign uses static sampling_ratio 2 instead of
    adaptive 0."""

    n_ways: int = 3
    k_shots: int = 3
    guidance: bool = True  # False = plain Faster/Mask R-CNN (sp01 mode)
    backbone_norm: str = "gn"
    res5_norm: str = "gn"
    backbone_frozen: bool = False
    deep_stem: bool = False
    avg_down: bool = False
    feat_channels: int = 1024
    stride: int = 16
    anchor_scales: Tuple[float, ...] = (2, 4, 8, 16, 32)
    anchor_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    # train_cfg (reference fgn_r50_c4_densecl.py:131-173)
    rpn_pos_iou: float = 0.5
    rpn_neg_iou: float = 0.3
    rpn_min_pos_iou: float = 0.3
    rpn_num_samples: int = 64
    rpn_pos_fraction: float = 0.5
    rpn_train_nms_pre: int = 4096
    rpn_train_max_per_img: int = 2000
    rpn_nms_iou: float = 0.7
    rpn_min_bbox_size: float = 0.0
    rcnn_pos_iou: float = 0.5
    rcnn_neg_iou: float = 0.5
    rcnn_min_pos_iou: float = 0.5
    rcnn_num_samples: int = 128
    rcnn_pos_fraction: float = 0.25
    mask_size: int = 14
    # test_cfg (reference :174-186)
    rpn_test_nms_pre: int = 4096
    rpn_test_max_per_img: int = 300
    rcnn_score_thr: float = 0.05
    rcnn_nms_iou: float = 0.5
    rcnn_max_per_img: int = 100
    mask_thr: float = 0.5
    rcnn_bbox_stds: Tuple[float, ...] = (0.1, 0.1, 0.2, 0.2)
    compute_dtype: str = "float32"
    # Rematerialization of named blocks in the training step; no effect on
    # inference (kept so the same config values load).
    remat: str = ""
    # Accepted and ignored: a CUDA tensor always goes to the hand-written
    # kernel (ops/roi_align_cuda.py, ops/nms_cuda.py) and a CPU tensor to
    # its plain version; there is no switch between them.
    use_pallas_roi_align: Optional[bool] = None
    use_pallas_nms: Optional[bool] = None

    @property
    def num_anchors(self) -> int:
        return len(self.anchor_scales) * len(self.anchor_ratios)
