"""Detector diagnostics on a trained checkpoint.

The port's counterpart of the JAX package's ``tools/diagnose_detector.py``.
Reports the stage-wise health the reference tracked via its rpn_log_* TB
scalars: proposal recall at IoU 0.5, the detection score distribution,
per-stage counts (gt boxes, valid proposals, detections a query) — and
writes detection/gt renders (the dataset's ``visualize_result``, the
Evaluator's render: gt left, detections right).

    python -m fgn_torch.tools.diagnose_detector \\
        fgn_torch/configs/fgn_train_mnistiseg_n1k1.py [n_batches] [--device cpu]

The checkpoint is the latest in the config's ``work_dir``. Runs on ``cuda``
unless given ``--device cpu``; without a GPU the default raises.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List

import numpy as np

BATCH = 2


def new_stats() -> Dict:
    return dict(prop_hits=0, prop_total=0, det_hits=0, det_total=0,
                det_right_cls=0, n_props=[], n_dets=[], scores=[])


def add_batch(stats: Dict, out: Dict[str, np.ndarray], meta) -> None:
    """Fold one batch's ``test_forward`` outputs (host arrays) and its meta
    into ``stats``; queries without gt are skipped, as in the reference."""
    from fgn_torch.ops.boxes import box_iou_np, xyxy_to_yxyx

    for b in range(out["dt_valid"].shape[0]):
        # the (y, x) swap is its own inverse: yxyx → xyxy
        gt = xyxy_to_yxyx(np.asarray(meta.qry_bboxes_yxyx[b]))
        gt_cats = np.asarray(meta.qry_cat_ids[b])
        if not len(gt):
            continue
        props = out["proposals"][b][np.asarray(out["prop_valid"][b])]
        stats["n_props"].append(len(props))
        if len(props):
            ious = box_iou_np(gt, props)
            stats["prop_hits"] += int((ious.max(axis=1) > 0.5).sum())
        stats["prop_total"] += len(gt)

        dv = np.asarray(out["dt_valid"][b])
        dets = out["dt_boxes"][b][dv]
        dcls = out["dt_cats"][b][dv]
        dscore = out["dt_scores"][b][dv]
        stats["n_dets"].append(len(dets))
        stats["scores"].extend(dscore.tolist())
        if len(dets):
            ious = box_iou_np(gt, dets)
            best = ious.argmax(axis=1)
            hit = ious.max(axis=1) > 0.5
            stats["det_hits"] += int(hit.sum())
            stats["det_right_cls"] += int((hit & (dcls[best] == gt_cats)).sum())
        stats["det_total"] += len(gt)


def summary(stats: Dict) -> Dict:
    """The numbers the report prints."""
    s = np.asarray(stats["scores"], np.float64)
    hist, _ = np.histogram(s, bins=10, range=(0.0, 1.0))
    return dict(
        prop_recall=stats["prop_hits"] / max(stats["prop_total"], 1),
        det_recall=stats["det_hits"] / max(stats["det_total"], 1),
        det_recall_cls=stats["det_right_cls"] / max(stats["det_total"], 1),
        props_per_img=float(np.mean(stats["n_props"])),
        dets_per_img=float(np.mean(stats["n_dets"])),
        score_p50=float(np.percentile(s, 50)) if len(s) else float("nan"),
        score_p90=float(np.percentile(s, 90)) if len(s) else float("nan"),
        score_max=float(np.max(s)) if len(s) else float("nan"),
        score_hist=hist.tolist(),
    )


def report(stats: Dict) -> List[str]:
    m = summary(stats)
    return [
        f"proposal recall@0.5: {stats['prop_hits']}/{stats['prop_total']} = "
        f"{m['prop_recall']:.3f}",
        f"detection recall@0.5 (any class): {stats['det_hits']}/"
        f"{stats['det_total']} = {m['det_recall']:.3f}",
        f"detection recall@0.5 (right class): {stats['det_right_cls']}/"
        f"{stats['det_total']} = {m['det_recall_cls']:.3f}",
        f"dets/img: mean {m['dets_per_img']:.1f}; score dist p50/p90/max: "
        f"{m['score_p50']:.3f}/{m['score_p90']:.3f}/{m['score_max']:.3f}",
        f"per-stage counts: {len(stats['n_props'])} queries, "
        f"{stats['prop_total']} gt, {sum(stats['n_props'])} proposals "
        f"({m['props_per_img']:.1f}/img), {sum(stats['n_dets'])} detections",
        f"score histogram (10 bins over [0, 1]): {m['score_hist']}",
    ]


def render(ds, out: Dict[str, np.ndarray], batch, meta, b: int,
           out_dir: str, name: str) -> str:
    """gt | detections of query ``b`` through the dataset's
    ``visualize_result``. → the file written."""
    from fgn_torch.ops.boxes import xyxy_to_yxyx

    dv = np.asarray(out["dt_valid"][b])
    h, w = (int(v) for v in np.asarray(batch.img_hw[b]))
    res = {
        "qry_img_shape": np.array([h, w, 3]),
        "qry_bboxes": np.asarray(meta.qry_bboxes_yxyx[b]),
        "qry_cat_ids": np.asarray(meta.qry_cat_ids[b]),
        "dt_bboxes": xyxy_to_yxyx(out["dt_boxes"][b][dv]),
        "dt_cat_ids": out["dt_cats"][b][dv],
        "dt_scores": out["dt_scores"][b][dv],
    }
    ds.visualize_result(res, out_dir, name)
    return os.path.join(out_dir, name)


def main(cfg_fp: str, n_batches: int = 8, device="cuda", n_renders: int = 2):
    """→ (the stats, the renders written)."""
    import torch

    from fgn_torch.config import Config
    from fgn_torch.data.batching import EpisodeLoader, from_numpy, to_device
    from fgn_torch.data.fst_bindings import init_ds_class_by_config
    from fgn_torch.main import _device, model_config_from_cfg
    from fgn_torch.models.fgn import build_model
    from fgn_torch.train.checkpoints import CheckpointManager

    dev = _device(device)
    cfg = Config.from_file(cfg_fp)
    mcfg = model_config_from_cfg(cfg)
    eval_ds = init_ds_class_by_config(cfg.eval_ds_cfg0)
    model = build_model(mcfg, dev, seed=0).eval()
    loaded = CheckpointManager(str(cfg.work_dir)).load_model(map_location=dev)
    assert loaded is not None, "no checkpoint found"
    step, state = loaded
    model.load_state_dict(state)
    print(f"loaded checkpoint step {step}")

    out_dir = os.path.join(str(cfg.work_dir), "diagnose")
    loader = EpisodeLoader(eval_ds, BATCH, max_gt=int(cfg.get("max_gt", 30)))
    stats, renders = new_stats(), []
    for bi, (batch, meta) in enumerate(loader):
        if bi >= n_batches:
            break
        with torch.no_grad():
            out = model.test_forward(to_device(
                from_numpy(**batch._asdict()), dev))
        out = {k: v.cpu().numpy() for k, v in out.items()}
        add_batch(stats, out, meta)
        for b in range(out["dt_valid"].shape[0]):
            if len(renders) < n_renders:
                renders.append(render(eval_ds, out, batch, meta, b, out_dir,
                                      f"diag_{bi:03}_{b}.png"))
    for line in report(stats):
        print(line)
    print(f"renders: {renders}")
    return stats, renders


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config")
    ap.add_argument("n_batches", nargs="?", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu to run on the CPU)")
    args = ap.parse_args()
    main(args.config, args.n_batches, device=args.device)
