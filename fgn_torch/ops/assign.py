"""MaxIoU assignment as a static-shape op with a leading batch dimension.

Port of the JAX package's ``ops/assign.py`` (mmdet's MaxIoUAssigner), with
any leading batch dimensions in place of ``vmap``:

  1. every box starts ignored (-1);
  2. boxes whose best IoU < neg_iou_thr become negative (0);
  3. boxes whose best IoU >= pos_iou_thr are assigned to their argmax gt;
  4. with ``match_low_quality``, each gt also claims every box that ties its
     own best IoU (>= min_pos_iou); for a box claimed by several gts the
     *last* one wins, as mmdet overwrites in gt order.

Invalid gt rows (padding) never match; boxes with ``box_valid`` False are
forced to ignore. With no valid gt every valid box is negative.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from fgn_torch.ops.boxes import box_iou


class AssignResult(NamedTuple):
    # For each box: -1 ignore, 0 negative, g+1 assigned to gt g.
    assigned_gt_inds: torch.Tensor  # (..., A) int32
    max_overlaps: torch.Tensor  # (..., A) float32
    pos_mask: torch.Tensor  # (..., A) bool
    neg_mask: torch.Tensor  # (..., A) bool


def max_iou_assign(
    boxes: torch.Tensor,  # (..., A, 4) XYXY
    gt_boxes: torch.Tensor,  # (..., G, 4) XYXY (padded)
    gt_valid: torch.Tensor,  # (..., G) bool
    pos_iou_thr: float,
    neg_iou_thr: float,
    min_pos_iou: float,
    match_low_quality: bool = True,
    box_valid: Optional[torch.Tensor] = None,  # (..., A) bool
) -> AssignResult:
    """Leading dimensions of the three inputs broadcast against each other."""
    gt_valid = gt_valid.to(torch.bool)
    ious = box_iou(gt_boxes, boxes)  # (..., G, A)
    zero = torch.zeros((), dtype=ious.dtype, device=ious.device)
    ious = torch.where(gt_valid[..., :, None], ious, zero)

    max_overlaps = ious.amax(dim=-2).clamp(min=0.0)  # (..., A)
    argmax_overlaps = ious.argmax(dim=-2).to(torch.int32)  # first max wins

    assigned = torch.full(max_overlaps.shape, -1, dtype=torch.int32,
                          device=ious.device)
    assigned = torch.where(max_overlaps < neg_iou_thr, 0, assigned)
    assigned = torch.where(max_overlaps >= pos_iou_thr, argmax_overlaps + 1,
                           assigned)

    if match_low_quality:
        gt_max = ious.amax(dim=-1, keepdim=True)  # (..., G, 1)
        eligible = ((ious == gt_max) & (gt_max >= min_pos_iou)
                    & gt_valid[..., :, None] & (ious > 0))  # (..., G, A)
        G = ious.shape[-2]
        g_ids = torch.arange(1, G + 1, dtype=torch.int32, device=ious.device)
        last_g = torch.where(eligible, g_ids[:, None],
                             torch.zeros((), dtype=torch.int32,
                                         device=ious.device)).amax(dim=-2)
        assigned = torch.where(last_g > 0, last_g, assigned)

    if box_valid is not None:
        box_valid = box_valid.to(torch.bool)
        assigned = torch.where(box_valid, assigned, -1)
        max_overlaps = torch.where(box_valid, max_overlaps, -1.0)

    return AssignResult(
        assigned_gt_inds=assigned,
        max_overlaps=max_overlaps,
        pos_mask=assigned > 0,
        neg_mask=assigned == 0,
    )
