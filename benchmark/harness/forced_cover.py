"""``cover_gap`` with the detections' score margin measured on every
candidate, not only on the kept ones.

``compare.cover_gap`` spares a candidate whose reference score clears the
program's cut-off by less than a margin of twice the image's widest kept
score error. At a full image (every detection slot taken) the cut-off is
the lowest kept score, and under random weights the relation head's
scores crowd within a few hundredths of it. A candidate the program did
not keep can then carry a wider rounding error than any kept one: its
own score falls under the cut-off, greedy NMS rightly leaves it out, and
the kept errors' margin is too narrow to spare it.

``cover_gap_all`` reads the same gap with the detections' margin taken
from the program's own score of every candidate: its box head run again
on its own proposals (``scores``, teacher-forced as ``compare.py`` is),
against the reference's, over each image's valid candidates. The
proposals' stage is ``compare.prop_cover_gap`` as it stands. Everything
else, the candidates that must be covered, the cut-offs and the kept
boxes, is ``compare.py``'s.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from benchmark.harness import compare
from benchmark.reference import ops
from benchmark.reference.precision import strict_f32
from benchmark.reference.serve import CLASS_OFFSET


def cover_gap_all(ref, cfg: Dict, batch, out: Dict[str, torch.Tensor],
                  scores: Callable) -> float:
    """One request: the largest over its images and both stages.
    ``scores(batch, proposals)`` → the program's class scores (B, P, N) of
    every proposal and way."""
    m = cfg["model"]
    gap = 0.0
    with torch.no_grad(), strict_f32():
        qry, spp = ref.extract(batch)
        cls, reg = ref.rpn(qry, spp)
        s_all, b_all, v_all = ref.rpn_candidates(cls, reg, batch.img_hw)
        a_size = compare._size(ops.anchors(cls.shape[2], cls.shape[3], m["stride"],
                                           m["anchor_scales"], m["anchor_ratios"], cls.device))
        del cls, reg
        for b in range(s_all.shape[0]):
            n = int(out["prop_valid"][b].sum())
            if n == 0:
                continue
            kept, kept_s = out["proposals"][b, :n], out["prop_scores"][b, :n]
            idx, d = compare.identify(kept, kept_s, n, b_all[b], s_all[b], a_size)
            err = float((kept_s - s_all[b][idx]).abs().max())
            gap = max(gap, compare.prop_cover_gap(
                m, s_all[b], b_all[b], v_all[b], a_size, kept, kept_s, m["rpn_test_nms_pre"],
                m["rpn_test_max_per_img"], err, float(d.max())))
        del s_all, b_all, v_all
        spp_maps, _ = ref.count_spp(spp, batch.spp_boxes, batch.spp_masks)
    return max(gap, det_gap(ref, cfg, batch, qry, spp_maps, out, scores))


def det_gap(ref, cfg: Dict, batch, qry, spp_maps, out: Dict[str, torch.Tensor],
            scores: Callable) -> float:
    """The detections' stage: ``compare.serve_readings``' own, the margin
    twice the wider of the kept errors and every valid candidate's
    program error, + ``compare.MARGIN_FLOOR``."""
    m = cfg["model"]
    prog = scores(batch, out["proposals"]).to(torch.float32)
    gap = 0.0
    with torch.no_grad(), strict_f32():
        sc, bx = ref.det_candidates(batch, qry, spp_maps, out["proposals"])
        N = m["n_ways"]
        cats = torch.arange(N, device=sc.device, dtype=torch.float32)
        for b in range(sc.shape[0]):
            n = int(out["dt_valid"][b].sum())
            if n == 0:
                continue
            s = sc[b].reshape(-1)
            ok = out["prop_valid"][b].repeat_interleave(N)
            boxes = (bx[b] + cats[None, :, None] * CLASS_OFFSET).reshape(-1, 4)
            chosen = out["dt_boxes"][b] + out["dt_cats"][b].to(torch.float32)[:, None] * CLASS_OFFSET
            p_size = compare._size(out["proposals"][b]).repeat_interleave(N)
            idx, _ = compare.identify(chosen, out["dt_scores"][b], n, boxes, s, p_size)
            kept_s = out["dt_scores"][b, :n]
            err = max(float((kept_s - s[idx]).abs().max()),
                      float((prog[b].reshape(-1) - s)[ok].abs().max()))
            gap = max(gap, compare.cover_gap(
                boxes, s, p_size, ok, chosen[:n], kept_s, m["rcnn_nms_iou"],
                compare._floor(kept_s, n, m["rcnn_max_per_img"], m["rcnn_score_thr"]),
                compare.MARGIN_ERRS * err + compare.MARGIN_FLOOR))
    return gap
