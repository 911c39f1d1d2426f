"""A toy copy of the benchmark's files for the CPU tests: the real
configuration at 64 px queries, 32 px supports and a few proposals and
detections, with every traffic and metric file of the checkout."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

from benchmark.harness import common

TOY_GEOMETRY = {"H": 64, "W": 96, "img_h": 64, "img_w": 90, "S": 32, "max_gt": 4}
TOY_MODEL = {"rpn_test_nms_pre": 128, "rpn_test_max_per_img": 12,
             "rcnn_max_per_img": 6, "rpn_train_nms_pre": 128,
             "rpn_train_max_per_img": 16, "rcnn_num_samples": 8,
             "rpn_num_samples": 16}
TOY_TRAFFIC = {"pool": 3, "warmup": 1, "check": 1, "profile": 1, "timed": 1}


def make(tmp: Path, limits=None, batch=None) -> dict:
    """Copy the checkout's benchmark files into ``tmp`` at toy size.
    → the toy spec (also written as ``tmp/BENCHMARK.json``)."""
    spec = copy.deepcopy(common.load_spec())
    bench = tmp / "benchmark"
    for sub in ("traffic", "metrics", "configs", "limits"):
        shutil.copytree(common.BENCH_DIR / sub, bench / sub)
    for c in spec["configs"]:
        path = tmp / c["file"]
        cfg = json.loads(path.read_text())
        cfg["geometry"] = dict(TOY_GEOMETRY)
        cfg["model"].update(TOY_MODEL)
        cfg["model"]["compute_dtype"] = "float32"
        path.write_text(json.dumps(cfg))
    for p in (bench / "traffic").glob("*.json"):
        t = json.loads(p.read_text())
        t.update(TOY_TRAFFIC)
        t["batch"] = batch or min(t["batch"], 2)
        p.write_text(json.dumps(t))
    if limits is not None:
        for p in (bench / "limits").glob("*.json"):
            p.write_text(json.dumps(limits))
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return spec
