"""The reference put in the program's place: ``test_forward``'s outputs and
the training step's proposals computed by ``RefFGN`` with a plain greedy
NMS. Only the lower-precision control runs this (``benchmark/calibrate.py``
and the tests); the comparison never needs it.

Greedy NMS: candidates in descending score order (stable), each kept
unless a kept one overlaps it by more than the threshold; the kept fill
``max_out`` slots in score order, the rest zero and invalid. Per-class NMS
offsets each class's boxes so that classes never overlap.
"""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.reference import ops

CLASS_OFFSET = 1e4


def greedy_nms(boxes, scores, valid, iou_thr: float, max_out: int):
    """One image: boxes (M, 4), scores (M,), valid (M,) → kept indices in
    score order (at most ``max_out``)."""
    s = torch.where(valid, scores, torch.full((), float("-inf"), device=scores.device))
    order = torch.sort(s, descending=True, stable=True)[1]
    order = order[torch.isfinite(s[order])]
    b = boxes[order]
    keep = []
    removed = torch.zeros(len(order), dtype=torch.bool, device=boxes.device)
    block = 512
    for lo in range(0, len(order), block):
        hi = min(lo + block, len(order))
        iou = ops.box_iou(b[lo:hi], b) > iou_thr  # (blk, M)
        for i in range(lo, hi):
            if removed[i]:
                continue
            keep.append(i)
            if len(keep) == max_out:
                return order[torch.tensor(keep, device=boxes.device)]
            removed |= iou[i - lo]
            removed[i] = True
    if not keep:
        return order[:0]
    return order[torch.tensor(keep, device=boxes.device)]


def _fill(idx, max_out, *values):
    out = []
    n = len(idx)
    for v in values:
        z = torch.zeros((max_out,) + v.shape[1:], dtype=v.dtype, device=v.device)
        z[:n] = v[idx]
        out.append(z)
    valid = torch.arange(max_out, device=idx.device) < n
    return out, valid


def proposals(ref, cls, reg, img_hw, nms_pre: int, max_out: int):
    """The RPN's proposals (B, max_out, 4), scores, valid."""
    m = ref.c
    s_all, b_all, v_all = ref.rpn_candidates(cls, reg, img_hw)
    outs = []
    for b in range(s_all.shape[0]):
        s, bx, v = s_all[b], b_all[b], v_all[b]
        top = torch.sort(s, descending=True, stable=True)[1][:nms_pre]
        keep = top[greedy_nms(bx[top], s[top], v[top], m["rpn_nms_iou"], max_out)]
        (pb, ps), pv = _fill(keep, max_out, bx, s)
        outs.append((pb, ps, pv))
    return tuple(torch.stack(t) for t in zip(*outs))


def test_forward(ref, batch) -> Dict[str, torch.Tensor]:
    """The outputs of the program's ``test_forward``, by the reference."""
    m = ref.c
    N = m["n_ways"]
    with torch.no_grad():
        qry, spp = ref.extract(batch)
        cls, reg = ref.rpn(qry, spp)
        props, pscores, pvalid = proposals(ref, cls, reg, batch.img_hw,
                                           m["rpn_test_nms_pre"], m["rpn_test_max_per_img"])
        spp_maps, spp_vecs = ref.count_spp(spp, batch.spp_boxes, batch.spp_masks)
        sc, bx = ref.det_candidates(batch, qry, spp_maps, props)
        D = m["rcnn_max_per_img"]
        dets = []
        for b in range(sc.shape[0]):
            s = sc[b].reshape(-1)
            cats = torch.arange(N, device=s.device).repeat(sc.shape[1])
            boxes = bx[b].reshape(-1, 4)
            ok = pvalid[b].repeat_interleave(N) & (s > m["rcnn_score_thr"])
            keep = greedy_nms(boxes + cats[:, None] * CLASS_OFFSET, s, ok,
                              m["rcnn_nms_iou"], D)
            (db, ds, dc), dv = _fill(keep, D, boxes, s, cats.to(torch.int32))
            dets.append((db, ds, dc, dv))
        db, ds, dc, dv = (torch.stack(t) for t in zip(*dets))
        ml = ref.det_masks(qry, spp_vecs, db, dc)
    return {"proposals": props, "prop_scores": pscores, "prop_valid": pvalid,
            "dt_boxes": db, "dt_scores": ds, "dt_cats": dc, "dt_valid": dv,
            "dt_mask_logits": ml}
