"""CPU tests of the benchmark's yardstick: the window's statistics, the
idle share, the kernels' byte bounds, the FLOP count, the guard against
JAX, and a cell, configuration and metric added as files only.

Run from the repository's root: ``python -m pytest benchmark/tests -q``.
"""

from __future__ import annotations

import ast
import json
import sys
import time
from pathlib import Path

import pytest
import torch

from benchmark import run as bench_run
from benchmark.harness import common, flops, trace
from benchmark.loops import serve
from benchmark.tests import toy

BENCH = common.BENCH_DIR


# -- the window's statistics --------------------------------------------------

class _Stalling:
    """A server whose requests take 2 ms, one of them 60 ms."""

    def __init__(self):
        self.n = 0

    def request(self, pinned):
        self.n += 1
        time.sleep(0.060 if self.n == 5 else 0.002)
        return {}


def test_rate_and_p95_take_every_request_of_the_window():
    pool = [toy_batch(3)] * 2
    outs, lat, imgs, window_s = serve.serve_window(_Stalling(), pool, 0.3)
    assert len(outs) == len(lat) and imgs == 3 * len(outs)
    # the rate is the whole window's, the stall included
    assert imgs / window_s == pytest.approx(3 * len(lat) / sum(lat), rel=0.05)
    assert window_s >= 0.3 and sum(lat) <= window_s
    # the tail is of every request: with one stall in ~100, p95 sits below
    # it and the maximum is it
    assert max(lat) >= 0.06
    assert common.quantile(lat, 0.95) < 0.06
    assert common.quantile(lat, 1.0) == max(lat)


def test_quantile_interpolates_between_order_statistics():
    v = [5.0, 1.0, 3.0, 2.0, 4.0]
    assert common.quantile(v, 0.5) == 3.0
    assert common.quantile(v, 0.95) == pytest.approx(4.8)
    with pytest.raises(ValueError):
        common.quantile([], 0.5)


def toy_batch(nb):
    from benchmark.harness.data import Batch

    z = torch.zeros
    return Batch(z(nb, 4, 4, 3, dtype=torch.uint8), z(nb, 1, 4), z(nb, 1),
                 z(nb, 1), z(nb, 1, 1, 1), z(nb, 1, 4, 4, 3), z(nb, 1, 4),
                 z(nb, 1, 4, 4), z(nb, 2), z(3), z(3))


# -- the idle share -----------------------------------------------------------

def test_idle_share_is_the_window_that_no_device_event_covers():
    rec = trace.Records()
    rec.host_window_s = 1e-3
    # overlapping and nested intervals count once
    rec.device_intervals = [(50, 150), (120, 300), (200, 250), (600, 700),
                            (1050, 1300), (1500, 1600)]
    assert rec.busy_s == pytest.approx((250 + 100 + 250 + 100) / 1e6)
    idle = common.load_metric("idle.serve").read(rec)
    assert idle == pytest.approx(30.0)
    assert common.load_metric("idle.serve").read(trace.Records()) is None


# -- the kernels' byte bounds ---------------------------------------------------

def _desc(shape, itemsize):
    return {"shape": shape, "itemsize": itemsize, "dtype": ""}


def test_k1_bound_at_the_serving_call():
    """0.0763 ms: K1 at b8, R 300, a 30×30×1024 bf16 map at 3.35 TB/s."""
    rec = trace.Records()
    rec.hbm_bytes_s = 3.35e12
    rec.calls["_roi_align_fmap"] = [{
        "args": [_desc((8, 30, 30, 1024), 2), _desc((8, 300, 4), 4), None],
        "out": _desc((8, 300, 7, 7, 1024), 2)}]
    rec.span_device_us["_roi_align_fmap"] = [76.3]
    share = common.load_metric("k1_roofline.serve").read(rec)
    assert share == pytest.approx(100.0, abs=0.1)
    rec.span_device_us["_roi_align_fmap"] = [200.0]  # the kernel's time
    assert common.load_metric("k1_roofline.serve").read(rec) == pytest.approx(38.1, abs=0.1)


def test_k1_bwd_bound_at_the_training_call():
    """0.0526 ms: K1-bwd at b12, R 128, a 30×30×1024 bf16 map."""
    reader = common.load_metric("k1_bwd_roofline.train")
    rec = trace.Records()
    rec.hbm_bytes_s = 3.35e12
    rec.calls["_roi_align_fmap"] = [{
        "args": [_desc((12, 30, 30, 1024), 2), _desc((12, 128, 4), 4), None],
        "out": _desc((12, 128, 7, 7, 1024), 2)}]
    rec.node_device_us[reader.NODE] = [52.6]
    assert reader.read(rec) == pytest.approx(100.0, abs=0.1)
    rec.node_device_us.clear()
    assert reader.read(rec) is None


# -- the FLOP count -------------------------------------------------------------

def test_flop_count_on_meta_equals_a_count_with_data():
    """The reference counted on the meta device is the count of a real
    forward on the CPU, and a convolution counts 2·k²·cin·cout·h·w."""
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference import nets

    conv = nets.Conv2d(3, 32, 3, 2, bias=False)
    torch.nn.init.normal_(conv.weight)
    counter = FlopCounterMode(display=False)
    with counter:
        conv(torch.zeros(2, 3, 64, 64))
    assert counter.get_total_flops() == 2 * 9 * 3 * 32 * 32 * 32 * 2

    cfg = json.loads((BENCH / "configs" / "omniiseg-n3k3-480.json").read_text())
    cfg["geometry"] = dict(toy.TOY_GEOMETRY)
    cfg["model"].update(toy.TOY_MODEL)
    meta = flops.serve_flops_per_img(cfg, 2)
    ref = common.reference_model(cfg, 1, "cpu")
    b = flops.meta_batch(cfg, 2, False)
    b = type(b)(*(torch.zeros(t.shape, dtype=t.dtype) for t in b))
    b = b._replace(norm_std=torch.ones(3))
    m = cfg["model"]
    props = torch.tensor([0.0, 0.0, 8.0, 8.0]).expand(2, m["rpn_test_max_per_img"], 4)
    dets = torch.tensor([0.0, 0.0, 8.0, 8.0]).expand(2, m["rcnn_max_per_img"], 4)
    cats = torch.zeros(2, m["rcnn_max_per_img"], dtype=torch.int32)
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        ref.serve_all(b, props, dets, cats)
    shapes_only = meta * 2 - counter.get_total_flops()
    # what the counter cannot see is counted from shapes: RoIAlign and NMS
    NK, C = m["n_ways"] * m["k_shots"], m["feat_channels"]
    roi = 32 * 49 * 2 * (NK * (C + 1) + (m["rpn_test_max_per_img"] + m["rcnn_max_per_img"]) * C)
    nms = 12 * 2 * (m["rpn_test_nms_pre"] + m["rpn_test_max_per_img"] * m["n_ways"])
    assert shapes_only == roi + nms


def test_flop_count_at_the_cells_shapes():
    cfg = json.loads((BENCH / "configs" / "omniiseg-n3k3-480.json").read_text())
    per_img = flops.serve_flops_per_img(cfg, 8)
    # the port's own count at 480 px without the deep stem was 585.4
    # GFLOP an image (FlopCounterMode over test_forward, kernels apart)
    assert 585e9 < per_img < 595e9
    assert flops.serve_flops_per_img(cfg, 1) == pytest.approx(per_img)


# -- the result line and the guard ----------------------------------------------

def test_guard_compares_whole_top_level_names(monkeypatch):
    for name in ("jax.numpy", "jaxlib", "flax.linen", "fgn_tpu.models"):
        monkeypatch.setitem(sys.modules, name, object())
    monkeypatch.setitem(sys.modules, "fgn_tpu_like", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_stub", object())
    assert common.banned_modules() == ["fgn_tpu", "flax", "jax", "jaxlib"]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def _harness_files():
    return [p for p in BENCH.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts]


def test_nothing_the_harness_runs_imports_jax_or_the_old_benches():
    banned = {"jax", "jaxlib", "flax", "fgn_tpu", "chip_smoke", "twin_sensitivity"}
    for path in _harness_files():
        for mod in _imports(path):
            assert mod.split(".")[0] not in banned, (path, mod)
            assert mod != "fgn_torch.bench", (path, mod)


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        for mod in _imports(path):
            assert mod.split(".")[0] != "fgn_torch", (path, mod)


def test_a_run_loads_no_jax():
    import subprocess

    code = ("import sys; sys.argv=['x']; import benchmark.run, benchmark.calibrate, "
            "benchmark.loops.serve, benchmark.loops.train, fgn_torch.models.fgn, "
            "fgn_torch.train.train_step; from benchmark.harness import common; "
            "[common.load_metric(m['name']) for m in common.load_spec()['per_layer']]; "
            "print(common.banned_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=common.ROOT, timeout=300, check=True).stdout
    assert out.strip() == "[]"


def test_without_a_card_a_run_exits_with_no_result(tmp_path):
    import subprocess

    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "omniiseg-serve-b8", "--seed", str(2**31 + 7), "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=common.ROOT, timeout=300,
                       env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                            "HOME": str(tmp_path)})
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_spec_meets_its_own_rules():
    spec = common.load_spec()
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names))
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    for w in spec["workloads"]:
        cell = common.Cell.load(w["name"], spec)
        assert "setup_s" in cell.e2e and len(cell.e2e) >= 2 and cell.per_layer
        assert w["chips"] == 1
        assert set(cell.limits) and all(v >= 0 for v in cell.limits.values())
    for m in spec["per_layer"]:
        reader = common.load_metric(m["name"])
        assert (reader.LAYER, reader.UNIT, reader.MOVES) == (m["layer"], m["unit"], m["moves"])
        for w in m["workloads"]:
            assert m["moves"] in common.Cell.load(w, spec).e2e
    for c in spec["configs"]:
        cfg = json.loads((common.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"] == []
    assert e2e["setup_s"]["bound"] == 0.25


# -- discovery by name ------------------------------------------------------------

NEW_METRIC = '''"""Requests in the traced stretch (a test's metric)."""

LAYER = "model step"
UNIT = "requests"
MOVES = "serve_imgs_s"


def read(rec):
    return float(rec.units) if rec.units else None
'''


def test_a_cell_config_and_metric_added_as_files_run(tmp_path):
    spec = toy.make(tmp_path, limits={"score_err": 10,
                                      "box_err": 10, "mask_err": 10, "unanswered": 0})
    bench = tmp_path / "benchmark"
    cfg = json.loads((tmp_path / spec["configs"][0]["file"]).read_text())
    cfg["name"] = "toy-copy"
    (bench / "configs" / "toy-copy.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "closed-b3.json").write_text(json.dumps(
        {"loop": "serve", "batch": 3, **toy.TOY_TRAFFIC}))
    (bench / "metrics" / "requests.serve.py").write_text(NEW_METRIC)
    (bench / "limits" / "toy-copy-b3.json").write_text(json.dumps({"mask_err": 10}))
    spec["configs"].append({"name": "toy-copy", "source": "a test",
                            "file": "benchmark/configs/toy-copy.json", "reduced": []})
    spec["workloads"].append({"name": "toy-copy-b3", "config": "toy-copy",
                              "traffic": "closed-b3", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"]:
        if "workloads" in m and "omniiseg-serve-b8" in m["workloads"]:
            m["workloads"].append("toy-copy-b3")
    spec["per_layer"].append({"name": "requests.serve", "unit": "requests",
                              "better": "higher", "source": "program_counter",
                              "layer": "model step", "moves": "serve_imgs_s"})
    line, notes, tail = bench_run.run_cell("toy-copy-b3", 2**31 + 5, 0.5, True, "cpu",
                                           time.time(), spec, tmp_path, bench)
    assert line["metrics"]["requests.serve"] == {"value": 1.0, "unit": "requests"}
    assert line["attempted"] >= 1 and list(line["checks"]) == ["mask_err"]


def test_the_result_lines_keys(tmp_path):
    spec = toy.make(tmp_path, limits={"score_err": 10,
                                      "box_err": 10, "mask_err": 10, "unanswered": 0})
    bench = tmp_path / "benchmark"
    line, notes, tail = bench_run.run_cell("omniiseg-serve-b1", 2**33 + 1, 0.5, False,
                                           "cpu", time.time(), spec, tmp_path, bench)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(line["metrics"]) == {"serve_imgs_s", "serve_p95_ms", "setup_s"}
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert line["correct"] is True and line["failed"] == 0
    assert [t.split(":")[0] for t in tail] == [f"check {k}" for k in line["checks"]]
    line, _, _ = bench_run.run_cell("omniiseg-serve-b1", 2**33 + 1, 0.5, True,
                                    "cpu", time.time(), spec, tmp_path, bench)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device",
                          "breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    # readers with nothing to read on the CPU leave their metric out
    assert set(line["metrics"]) <= {"mfu.serve", "idle.serve", "extract_ms.serve",
                                    "bbox_feats_ms.serve", "k1_roofline.serve"}
