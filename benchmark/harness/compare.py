"""The comparison that decides ``correct``: the program's outputs against
the float32 reference, and the numbers it reads.

Serving. The reference computes, in float32, the score and the box of
every candidate the program chose its outputs from (every anchor, for
the proposals; every proposal and way, for the detections), and finds
the candidate each output came from (``identify``): teacher-forced on the
program's own choices, as a served model's tokens are judged, it never
makes a discrete choice of its own. The mask logits are compared at the
program's own detections.

Numbers a request gives (the run's number is the largest over the
requests checked):

  * ``score_err``: the widest |program score − reference score| of a
    kept proposal or detection (both are probabilities);
  * ``box_err``: the widest distance (L∞) from a kept box to the nearest
    reference box of the same class, over the longer side of that
    candidate's anchor (a proposal) or proposal (a detection): the box
    deltas' error;
  * ``mask_err``: the widest |program − reference| mask logit at the
    program's detections, over the image's largest reference logit;
  * ``unanswered``: queries given no proposal, or no detection, where the
    reference has a candidate (above the score threshold) (exact: 0);
  * ``overlap``: pairs of kept proposals, or of kept detections of one
    class, that overlap above the NMS threshold: greedy NMS keeps none
    (exact: 0);
  * ``cover_gap``: whether the program kept the right candidates, as a
    set that near-ties cannot upset. Greedy NMS leaves every candidate
    it reached either kept or suppressed by a kept box of at least its
    score that overlaps it above the threshold. Each candidate whose
    reference score clears the program's cut-offs (the pre-NMS top-k's
    last score, the score threshold, the lowest kept score where every
    slot is full) by a margin of twice the image's widest kept score
    error (``MARGIN_ERRS``, + ``MARGIN_FLOOR``) must therefore overlap a
    kept box whose score is at least its own less that margin, or be one
    (a kept box within ``NEAR`` of its scale, as ``identify`` has it: a
    sliver clipped at the border overlaps its own kept copy little); the
    number is the widest shortfall of such a candidate's best overlap
    below the threshold (0 where every one is covered). A proposal
    candidate counts only where its shorter side clears the minimum size
    by twice the image's widest kept box error, so that the program's
    rounding cannot have made it invalid. Keeping too few, the wrong
    ones, or the low-scoring ones reads up to the threshold itself; ties
    within the margins read nothing.

Whether the program kept the candidates in exactly the reference's order
is not compared: under random weights the candidates' scores lie close
together, so any precision reorders them.

Training. The reference follows the program's first three steps from the
same weights, inputs and draws, with the second stage's proposals taken
from the program (``FGN.get_proposals``'s outputs, themselves checked at
the first step as in serving: ``prop_score_err``, ``prop_box_err``,
``prop_overlap``, ``prop_cover_gap``). ``loss_err`` is the widest relative
gap of a step's total loss. A leaf's gap is |program norm − reference
norm| over the reference's norm of that leaf or of the median leaf,
whichever is larger, for the first gradient (``grad_*``) and for the
parameters' change after the three steps (``delta_*``); ``*_err`` is the
worst leaf's, ``*_med_err`` the median leaf's, ``delta_group_err`` the
largest over the model's three parts (``module_group``: backbone, RPN,
RoI head, the parts the optimizer treats apart) of the part's median
leaf's, measured within the part. Leaves whose reference gradient is
under a thousandth of the median leaf's move by round-off alone and are
left out of ``delta_*``. Compared: ``loss_err``, ``delta_group_err`` (a
part left unmoved reads up to 1, a part moved at ten times its rate up
to 9) and the proposals' numbers. The worst leaf swings from seed to
seed with bfloat16's rounding (the reference rounded to bfloat16 reads
the same gaps), so ``grad_err`` and ``delta_err`` are printed, and
``grad_med_err``, which no fault separates, too (PERF.md gives the
readings).
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional

import torch

from benchmark.reference import ops
from benchmark.reference.optim import ROI_HEAD_MODULES
from benchmark.reference.precision import strict_f32
from benchmark.reference.serve import CLASS_OFFSET

NEAR = 0.1  # a candidate's box this close, in units of its scale, may be the one chosen
ROUNDING = 1e-6  # an IoU this close to the threshold may round to either side
MARGIN_ERRS = 2.0  # ``cover_gap``'s score margin, in the image's widest kept score errors
MARGIN_FLOOR = 1e-3  # ... plus this


def identify(chosen: torch.Tensor, chosen_scores, n_chosen: int, cand_boxes,
             cand_scores, cand_scale):
    """One image. ``chosen`` (K, 4) and ``chosen_scores`` (K,): the
    program's kept boxes and their scores, the first ``n_chosen`` valid.
    ``cand_*`` (Mc, ...): every candidate's reference box and score, and
    the size its box's error scales with (its anchor's or its proposal's
    longer side). Each chosen box is the candidate whose box lies within
    ``NEAR`` of its scale and whose score is closest (clipping makes
    neighbours' boxes alike; their scores tell them apart), else the
    nearest box. → (the candidates' indices, each chosen box's distance to
    the nearest candidate over that candidate's scale)."""
    ch = chosen[:n_chosen]
    dist = (ch[:, None, :] - cand_boxes[None]).abs().amax(-1) / cand_scale[None]
    nearest = dist.argmin(dim=1)
    off = (chosen_scores[:n_chosen, None] - cand_scores[None]).abs()
    off = torch.where(dist <= NEAR, off, torch.full((), float("inf"), device=off.device))
    idx = torch.where(torch.isfinite(off.amin(dim=1)), off.argmin(dim=1), nearest)
    return idx, dist.gather(1, nearest[:, None])[:, 0]


def overlaps(boxes, valid, iou_thr: float) -> int:
    """Pairs of kept boxes (``valid`` rows) that overlap above the
    NMS threshold: greedy NMS never keeps one, so any is a fault. Boxes of
    different classes carry ``CLASS_OFFSET``; ``ROUNDING`` spares a pair
    whose IoU rounds to either side of the threshold."""
    kept = boxes[valid]
    if kept.shape[0] < 2:
        return 0
    iou = ops.box_iou(kept, kept).triu(1)
    return int((iou > iou_thr + ROUNDING).sum())


def cover_gap(cand_boxes, cand_scores, cand_scale, cand_ok, kept_boxes, kept_scores,
              iou_thr: float, floor: float, margin: float) -> float:
    """One image and stage: the candidates ``cand_ok`` whose reference
    score is above ``floor + margin`` against the program's kept boxes
    and scores. → the widest shortfall, below ``iou_thr``, of such a
    candidate's best overlap with a kept box of score ≥ its own − margin,
    a kept box within ``NEAR`` of the candidate's scale counting as an
    overlap of 1 (see the module's docstring)."""
    sel = cand_ok & (cand_scores > floor + margin)
    if not bool(sel.any()):
        return 0.0
    if kept_boxes.shape[0] == 0:
        return float(iou_thr)
    c_b, c_s, c_n = cand_boxes[sel], cand_scores[sel], cand_scale[sel]
    worst = 1.0
    for lo in range(0, c_b.shape[0], 4096):
        b = c_b[lo:lo + 4096]
        iou = ops.box_iou(b, kept_boxes)
        same = (b[:, None, :] - kept_boxes[None]).abs().amax(-1) <= NEAR * c_n[lo:lo + 4096, None]
        ok = kept_scores[None, :] >= c_s[lo:lo + 4096, None] - margin
        cover = torch.where(same, torch.ones((), device=iou.device), iou)
        best = torch.where(ok, cover, torch.zeros((), device=iou.device)).amax(dim=1)
        worst = min(worst, float(best.min()))
    return max(0.0, iou_thr - worst)


def _floor(kept_scores, n: int, max_out: int, cut: float) -> float:
    """The lowest score the program had to reach: ``cut``, or its lowest
    kept score where it filled every slot."""
    return max(cut, float(kept_scores[:n].min())) if n == max_out else cut


def _size(b):
    return (b[..., 2:] - b[..., :2]).amax(-1).clamp(min=1.0)


def serve_readings(ref, cfg: Dict, batch, out: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The numbers of one request: ``batch`` and the program's outputs
    ``out`` on the reference's device."""
    m = cfg["model"]
    r = dict(score_err=0.0, box_err=0.0, mask_err=0.0, unanswered=0, overlap=0, cover_gap=0.0)
    unanswered = set()
    with torch.no_grad(), strict_f32():
        qry, spp = ref.extract(batch)
        cls, reg = ref.rpn(qry, spp)
        s_all, b_all, v_all = ref.rpn_candidates(cls, reg, batch.img_hw)
        a_size = _size(ops.anchors(cls.shape[2], cls.shape[3], m["stride"], m["anchor_scales"],
                                   m["anchor_ratios"], cls.device))
        del cls, reg
        B = s_all.shape[0]
        for b in range(B):
            n = int(out["prop_valid"][b].sum())
            r["overlap"] += overlaps(out["proposals"][b], out["prop_valid"][b], m["rpn_nms_iou"])
            if n == 0:
                if bool(v_all[b].any()):
                    unanswered.add(b)
                continue
            idx, d = identify(out["proposals"][b], out["prop_scores"][b], n, b_all[b],
                              s_all[b], a_size)
            err = float((out["prop_scores"][b, :n] - s_all[b][idx]).abs().max())
            r["score_err"] = max(r["score_err"], err)
            r["box_err"] = max(r["box_err"], float(d.max()))
            r["cover_gap"] = max(r["cover_gap"], prop_cover_gap(
                m, s_all[b], b_all[b], v_all[b], a_size, out["proposals"][b, :n],
                out["prop_scores"][b, :n], m["rpn_test_nms_pre"], m["rpn_test_max_per_img"],
                err, float(d.max())))
        del s_all, b_all, v_all
        spp_maps, spp_vecs = ref.count_spp(spp, batch.spp_boxes, batch.spp_masks)
        del spp
        sc, bx = ref.det_candidates(batch, qry, spp_maps, out["proposals"])
        N = m["n_ways"]
        cats = torch.arange(N, device=sc.device, dtype=torch.float32)
        for b in range(B):
            s = sc[b].reshape(-1)
            boxes = (bx[b] + cats[None, :, None] * CLASS_OFFSET).reshape(-1, 4)
            n = int(out["dt_valid"][b].sum())
            chosen = out["dt_boxes"][b] + out["dt_cats"][b].to(torch.float32)[:, None] * CLASS_OFFSET
            r["overlap"] += overlaps(chosen, out["dt_valid"][b], m["rcnn_nms_iou"])
            if n == 0:
                ok = out["prop_valid"][b].repeat_interleave(N) & (s > m["rcnn_score_thr"])
                if bool(ok.any()):
                    unanswered.add(b)
                continue
            p_size = _size(out["proposals"][b]).repeat_interleave(N)
            idx, d = identify(chosen, out["dt_scores"][b], n, boxes, s, p_size)
            err = float((out["dt_scores"][b, :n] - s[idx]).abs().max())
            r["score_err"] = max(r["score_err"], err)
            r["box_err"] = max(r["box_err"], float(d.max()))
            kept_s = out["dt_scores"][b, :n]
            r["cover_gap"] = max(r["cover_gap"], cover_gap(
                boxes, s, p_size, out["prop_valid"][b].repeat_interleave(N), chosen[:n], kept_s,
                m["rcnn_nms_iou"], _floor(kept_s, n, m["rcnn_max_per_img"], m["rcnn_score_thr"]),
                MARGIN_ERRS * err + MARGIN_FLOOR))
        del sc, bx
        r["unanswered"] = len(unanswered)
        ml = ref.det_masks(qry, spp_vecs, out["dt_boxes"], out["dt_cats"])
        for b in range(B):
            n = int(out["dt_valid"][b].sum())
            if n:
                got, want = out["dt_mask_logits"][b, :n], ml[b, :n]
                r["mask_err"] = max(r["mask_err"], float(
                    (got - want).abs().max() / want.abs().max().clamp(min=1e-6)))
    return r


def prop_cover_gap(m: Dict, s_all, b_all, v_all, a_size, kept_boxes, kept_scores,
                   nms_pre: int, max_out: int, err: float, box_err: float) -> float:
    """``cover_gap`` of one image's proposals: the RPN's candidates are
    every anchor (``a_size``: its longer side), cut to the ``nms_pre``
    best scores before NMS; ``err`` and ``box_err`` the image's widest
    kept score and box errors."""
    cut = float("-inf")
    if s_all.shape[0] > nms_pre:
        cut = float(torch.topk(s_all, nms_pre).values[-1])
    side = (b_all[:, 2:] - b_all[:, :2]).amin(-1)
    sure = v_all & (side > m.get("rpn_min_bbox_size", 0.0) + MARGIN_ERRS * box_err * a_size)
    return cover_gap(b_all, s_all, a_size, sure, kept_boxes, kept_scores, m["rpn_nms_iou"],
                     _floor(kept_scores, kept_boxes.shape[0], max_out, cut),
                     MARGIN_ERRS * err + MARGIN_FLOOR)


def module_group(name: str) -> str:
    """The part of the model a parameter belongs to, as the optimizer
    treats them apart: the backbone, the RoI head (its own learning
    rate), the RPN (the rest)."""
    top = name.split(".", 1)[0]
    if top == "backbone":
        return "backbone"
    return "roi head" if top in ROI_HEAD_MODULES else "rpn"


def group_medians(prog: Dict[str, float], ref: Dict[str, float],
                  keep: List[str]) -> Dict[str, float]:
    """Each part's median leaf gap (``leaf_gaps`` within the part, so the
    RoI head's smaller steps are measured against its own)."""
    groups: Dict[str, List[str]] = {}
    for n in keep:
        groups.setdefault(module_group(n), []).append(n)
    return {k: statistics.median(leaf_gaps({n: prog[n] for n in v}, {n: ref[n] for n in v}).values())
            for k, v in groups.items()}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep: Optional[List[str]] = None) -> Dict[str, float]:
    """Each leaf's |program norm − reference norm| over the larger of the
    reference's norm of that leaf and of the median leaf."""
    names = list(ref) if keep is None else keep
    med = statistics.median(ref.values())
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names}


def moved_leaves(ref_grad: Dict[str, float]) -> List[str]:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    med = statistics.median(ref_grad.values())
    return [n for n, g in ref_grad.items() if g >= 1e-3 * med]


def train_readings(prog: Dict, ref_run: Dict) -> Dict[str, float]:
    """``prog`` and ``ref_run``: {"losses": [3 floats], "grad": {leaf:
    norm}, "delta": {leaf: norm}}; ``ref_run`` also the proposals' errors
    (``proposal_errors``)."""
    loss_err = max(abs(p - q) / max(abs(q), 1e-30)
                   for p, q in zip(prog["losses"], ref_run["losses"]))
    grad = leaf_gaps(prog["grad"], ref_run["grad"])
    moved = moved_leaves(ref_run["grad"])
    delta = leaf_gaps(prog["delta"], ref_run["delta"], moved)
    worst_g = max(grad, key=grad.get)
    worst_d = max(delta, key=delta.get)
    parts = group_medians(prog["delta"], ref_run["delta"], moved)
    return dict(
        loss_err=loss_err,
        grad_err=grad[worst_g], grad_med_err=statistics.median(grad.values()),
        delta_err=delta[worst_d], delta_med_err=statistics.median(delta.values()),
        delta_group_err=max(parts.values()),
        **{f"delta_med_err.{k.replace(' ', '_')}": v for k, v in parts.items()},
        prop_score_err=ref_run["prop_score_err"], prop_box_err=ref_run["prop_box_err"],
        prop_overlap=ref_run["prop_overlap"], prop_cover_gap=ref_run["prop_cover_gap"],
        worst_grad_leaf=worst_g, worst_delta_leaf=worst_d,
    )


def proposal_errors(ref, cfg: Dict, batch, props, prop_scores,
                    prop_valid) -> Dict[str, float]:
    """``score_err``, ``box_err`` and ``overlap`` of the proposals that the
    program's training step took, at the reference's current weights."""
    m = cfg["model"]
    r = {"prop_score_err": 0.0, "prop_box_err": 0.0, "prop_overlap": 0, "prop_cover_gap": 0.0}
    with torch.no_grad(), strict_f32():
        qry, spp = ref.extract(batch)
        cls, reg = ref.rpn(qry, spp)
        s_all, b_all, v_all = ref.rpn_candidates(cls, reg, batch.img_hw)
        a_size = _size(ops.anchors(cls.shape[2], cls.shape[3], m["stride"], m["anchor_scales"],
                                   m["anchor_ratios"], cls.device))
        for b in range(s_all.shape[0]):
            n = int(prop_valid[b].sum())
            r["prop_overlap"] += overlaps(props[b], prop_valid[b], m["rpn_nms_iou"])
            if n:
                idx, d = identify(props[b], prop_scores[b], n, b_all[b], s_all[b], a_size)
                err = float((prop_scores[b, :n] - s_all[b][idx]).abs().max())
                r["prop_score_err"] = max(r["prop_score_err"], err)
                r["prop_box_err"] = max(r["prop_box_err"], float(d.max()))
                r["prop_cover_gap"] = max(r["prop_cover_gap"], prop_cover_gap(
                    m, s_all[b], b_all[b], v_all[b], a_size, props[b, :n], prop_scores[b, :n],
                    m["rpn_train_nms_pre"], m["rpn_train_max_per_img"], err, float(d.max())))
    return r
