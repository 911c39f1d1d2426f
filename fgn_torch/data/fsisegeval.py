"""Episodic COCO-style evaluation (mAP / mAR @ IoU 0.5).

A copy of the JAX package's ``data/fsisegeval.py``: a self-contained
rebuild of the reference's ``FSISEGEval(COCOeval)``
(datasets/fewshotiseg/fsisegeval.py) without pycocotools: greedy
highest-IoU matching per image/category with crowd IoF semantics, then
PR accumulation. Episodic parameters are baked in like the reference
(:108-117): iouThrs = [0.5], maxDets = [100], a single all-area range,
catIds = 0..N-1 (episode-remapped ids).

AP interpolation uses COCOeval's exact 101-point recall grid
(``_RECALL_POINTS`` below), matching pycocotools' ``Params.recThrs`` —
cross-checked against hand-computed PR curves in tests/test_fsisegeval.py.

Input results are the per-episode dicts the evaluator writes
(train/evaluator.py): YXYX boxes, episode cat ids, RLE masks.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

from fgn_torch.data import rle as RLE
from fgn_torch.utils.io import read_pkl

IOU_THR = 0.5
MAX_DETS = 100
# COCOeval's 101-point recall grid (pycocotools Params.recThrs);
# matches the reference FSISEGEval(COCOeval) interpolation exactly.
_RECALL_POINTS = np.linspace(0.0, 1.0, 101)


def _yxyx_to_xywh(boxes: np.ndarray) -> np.ndarray:
    boxes = np.asarray(boxes, np.float64).reshape(-1, 4)
    y1, x1, y2, x2 = boxes.T
    return np.stack([x1, y1, x2 - x1, y2 - y1], axis=1)


def _xywh_iou(dts, gts, iscrowd) -> np.ndarray:
    """Box IoU matrix (D, G), XYWH; crowd gt → IoF (pycocotools
    ``bbIou`` convention)."""
    d = np.asarray(dts, np.float64).reshape(-1, 4)
    g = np.asarray(gts, np.float64).reshape(-1, 4)
    if len(d) == 0 or len(g) == 0:
        return np.zeros((len(d), len(g)), np.float64)
    dx1, dy1, dw, dh = d.T
    gx1, gy1, gw, gh = g.T
    ix = np.maximum(
        0,
        np.minimum(dx1[:, None] + dw[:, None], gx1[None] + gw[None])
        - np.maximum(dx1[:, None], gx1[None]),
    )
    iy = np.maximum(
        0,
        np.minimum(dy1[:, None] + dh[:, None], gy1[None] + gh[None])
        - np.maximum(dy1[:, None], gy1[None]),
    )
    inter = ix * iy
    da = (dw * dh)[:, None]
    ga = (gw * gh)[None]
    crowd = np.asarray(iscrowd, bool)[None]
    union = np.where(crowd, da, da + ga - inter)
    return inter / np.maximum(union, 1e-12)


class FSISEGEval:
    def __init__(
        self,
        results: Optional[Sequence[Dict]] = None,
        results_pkl_dir_fp: Optional[str] = None,
        n_ways: int = 3,
        iou_type: str = "bbox",
    ):
        assert iou_type in ("bbox", "segm")
        assert (results is None) ^ (results_pkl_dir_fp is None)
        if results is None:
            results = []
            for fn in sorted(os.listdir(results_pkl_dir_fp)):
                if fn.endswith(".pkl"):
                    results.extend(
                        read_pkl(os.path.join(results_pkl_dir_fp, fn))
                    )
        self.results = list(results)
        self.n_ways = n_ways
        self.iou_type = iou_type

    # -- matching ----------------------------------------------------------

    def _match_image_cat(self, res: Dict, cat: int):
        """Greedy per-image matching (COCOeval.evaluateImg semantics).

        Returns (dt_scores, dt_matched, n_gt) for this image/category."""
        gt_sel = np.asarray(res["qry_cat_ids"]) == cat
        dt_sel = np.asarray(res["dt_cat_ids"]) == cat
        n_gt = int(gt_sel.sum())
        dt_scores = np.asarray(res["dt_scores"], np.float64)[dt_sel]
        order = np.argsort(-dt_scores, kind="stable")[:MAX_DETS]
        dt_scores = dt_scores[order]
        n_dt = len(dt_scores)
        if n_dt == 0:
            return dt_scores, np.zeros(0, bool), n_gt
        if n_gt == 0:
            return dt_scores, np.zeros(n_dt, bool), 0

        iscrowd = [0] * n_gt  # episodic gts are never crowd
        if self.iou_type == "bbox":
            dts = _yxyx_to_xywh(np.asarray(res["dt_bboxes"])[dt_sel][order])
            gts = _yxyx_to_xywh(np.asarray(res["qry_bboxes"])[gt_sel])
            ious = _xywh_iou(dts, gts, iscrowd)
        else:
            dt_rles = [
                r for r, s in zip(res["dt_isegmaps_rle"], dt_sel) if s
            ]
            dt_rles = [dt_rles[i] for i in order]
            gt_rles = [
                r for r, s in zip(res["qry_isegmaps_rle"], gt_sel) if s
            ]
            ious = RLE.iou(dt_rles, gt_rles, iscrowd)

        gt_used = np.zeros(n_gt, bool)
        matched = np.zeros(n_dt, bool)
        for di in range(n_dt):
            best, best_iou = -1, IOU_THR
            for gi in range(n_gt):
                if gt_used[gi]:
                    continue
                if ious[di, gi] >= best_iou:
                    best, best_iou = gi, ious[di, gi]
            if best >= 0:
                gt_used[best] = True
                matched[di] = True
        return dt_scores, matched, n_gt

    # -- accumulate ----------------------------------------------------------

    def run(self) -> Dict[str, float]:
        aps, ars = [], []
        for cat in range(self.n_ways):
            scores, matched, total_gt = [], [], 0
            for res in self.results:
                s, m, g = self._match_image_cat(res, cat)
                scores.append(s)
                matched.append(m)
                total_gt += g
            if total_gt == 0:
                continue  # category absent from the gt: excluded
            scores = np.concatenate(scores) if scores else np.zeros(0)
            matched = np.concatenate(matched) if matched else np.zeros(0, bool)
            order = np.argsort(-scores, kind="stable")
            tp = matched[order]
            fp = ~tp
            ctp = np.cumsum(tp)
            cfp = np.cumsum(fp)
            recall = ctp / total_gt
            precision = ctp / np.maximum(ctp + cfp, 1)
            # interpolated precision (monotone from the right)
            for i in range(len(precision) - 2, -1, -1):
                precision[i] = max(precision[i], precision[i + 1])
            ap = 0.0
            for r in _RECALL_POINTS:
                p = precision[recall >= r][:1]
                ap += float(p[0]) if len(p) else 0.0
            aps.append(ap / len(_RECALL_POINTS))
            ars.append(float(recall[-1]) if len(recall) else 0.0)
        if not aps:
            return {"mAP": 0.0, "mAR": 0.0}
        return {"mAP": float(np.mean(aps)), "mAR": float(np.mean(ars))}

    def summarize_short(self) -> Dict[str, float]:
        return self.run()
