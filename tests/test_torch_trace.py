"""The port's recorder (``fgn_torch/utils/profiling.py``) on the CPU: off
without a profiler, the spans of a toy request and train step nested as the
program runs them, their host times on the profiler's clock, syncs counted
by site, the launch counters, a toy traced cell of the benchmark recording
its requests, and the benchmark's eight readers of the recorder."""

import inspect
import json
import os
import time
import warnings
from unittest import mock

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fgn_torch.config import FGNConfig
from fgn_torch.data.batching import from_numpy
from fgn_torch.models.fgn import build_model
from fgn_torch.ops import anchors
from fgn_torch.train.optim import build_optimizer
from fgn_torch.train.train_step import make_train_step
from fgn_torch.utils import profiling

torch.set_num_threads(2)

# tests/test_torch_model.py's SMALL configuration
SMALL = dict(
    n_ways=3, k_shots=1, backbone_norm="gn", backbone_frozen=False,
    rpn_train_nms_pre=256, rpn_train_max_per_img=64, rpn_test_nms_pre=256,
    rpn_test_max_per_img=32, rcnn_num_samples=16, rpn_num_samples=16,
    rcnn_max_per_img=8,
)
REQUEST = ("extract", "rpn", "support", "roi", "box_head", "mask_head")
FORWARD = ("extract", "rpn", "rpn_loss", "sample", "support", "roi",
           "box_head", "mask_head")
COUNTERS = ("k1.staged", "k1.direct", "k1_bwd.staged", "k1_bwd.atomic",
            "k2.staged", "k2.unstaged")


def _batch(seed=0, B=2, H=64, W=64, G=4, N=3, S=32):
    rng = np.random.RandomState(seed)
    boxes = np.zeros((B, G, 4), np.float32)
    cats = np.zeros((B, G), np.int32)
    valid = np.zeros((B, G), bool)
    masks = np.zeros((B, G, H // 4, W // 4), np.uint8)
    for b in range(B):
        for g in range(2):
            x1, y1 = rng.randint(0, W // 2, 2)
            bw, bh = rng.randint(12, 28, 2)
            boxes[b, g] = [x1, y1, min(x1 + bw, W - 1), min(y1 + bh, H - 1)]
            cats[b, g], valid[b, g] = g % N, True
            x0, y0, x1, y1 = (boxes[b, g] / 4).astype(int)
            masks[b, g, y0:y1, x0:x1] = 255
    spp_masks = np.zeros((B, N, S, S), np.uint8)
    spp_masks[:, :, 8:-8, 8:-8] = 255
    return from_numpy(
        qry_img=(rng.rand(B, H, W, 3) * 255).astype(np.uint8),
        qry_boxes=boxes, qry_cats=cats, qry_valid=valid, qry_masks=masks,
        spp_imgs=(rng.rand(B, N, S, S, 3) * 255).astype(np.uint8),
        spp_boxes=np.tile(np.array([4, 4, S - 4, S - 4], np.float32),
                          (B, N, 1)),
        spp_masks=spp_masks,
        img_hw=np.tile(np.array([H, W], np.int32), (B, 1)),
        norm_mean=np.full(3, 127.0, np.float32),
        norm_std=np.full(3, 64.0, np.float32))


@pytest.fixture(scope="module")
def toy():
    """A toy model, its train step and a batch."""
    model = build_model(FGNConfig(**SMALL), device="cpu", seed=0)
    step = make_train_step(model, build_optimizer(model, base_lr=1e-3))
    return model, step, _batch()


@pytest.fixture(autouse=True)
def fresh():
    profiling.reset()
    yield
    profiling.reset()


def _run(model, step, batch):
    model.eval()
    model.test_forward(batch)
    model.train()
    step(batch, draws=lambda name, shape: torch.rand(
        shape, generator=torch.Generator().manual_seed(len(shape))))
    model.eval()


def _fgn_paths(events):
    """Each ``fgn/`` host event's path through its ``fgn/`` ancestors."""
    out = []
    for e in events:
        if not e.name.startswith(profiling.PREFIX):
            continue
        names, p = [], e
        while p is not None:
            if p.name.startswith(profiling.PREFIX):
                names.append(p.name[len(profiling.PREFIX):])
            p = p.cpu_parent
        out.append("/".join(reversed(names)))
    return out


def test_off_a_span_is_one_shared_object_and_records_nothing(toy):
    model, step, batch = toy
    fake = mock.MagicMock()
    with mock.patch.object(profiling, "_Range", fake), \
            mock.patch.object(torch.profiler, "record_function", fake), \
            mock.patch.object(torch.cuda, "Event", fake):
        first = profiling.span("rpn")
        assert profiling.span("box_head") is first
        assert profiling.unit("request") is first
        with first:
            pass
        _run(model, step, batch)
    assert not fake.called
    for kind in ("request", "step"):
        assert profiling.summary(kind) == {"units": 0, "spans": {},
                                           "syncs": {}}


def test_a_request_and_a_step_nest_as_the_program_runs_them(toy):
    model, step, batch = toy
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run(model, step, batch)
    req, stp = profiling.summary("request"), profiling.summary("step")
    assert req["units"] == 1 and stp["units"] == 1
    want = ({"request"} | {f"request/{s}" for s in REQUEST}
            | {"request/mask_head/roi"}
            | {"step", "step/forward", "step/backward", "step/optimizer"}
            | {f"step/forward/{s}" for s in FORWARD})
    assert set(req["spans"]) | set(stp["spans"]) == want
    # the profiler's fgn/ ranges nest the same way
    assert set(_fgn_paths(prof.events())) == want
    for s, kind in ((req, "request"), (stp, "step"), (stp, "step/forward")):
        whole = s["spans"][kind]
        children = sum(v["host_ms"] for p, v in s["spans"].items()
                       if p.rpartition("/")[0] == kind)
        assert children >= 0.95 * whole["host_ms"], (kind, children, whole)
        assert whole["self_host_ms"] == pytest.approx(
            whole["host_ms"] - children, abs=1e-9)
        assert whole["stream_ms"] is None  # no CUDA events on the CPU
    # the step's optimizer span is its zero_grad and its step, summed
    assert stp["spans"]["step/optimizer"]["host_ms"] > 0
    assert req["syncs"] == {} and stp["syncs"] == {}


def test_span_host_times_agree_with_the_profilers_events(toy):
    model, step, batch = toy
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run(model, step, batch)
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    events = {}
    for e in prof.events():
        if e.name.startswith(profiling.PREFIX):
            events.setdefault(e.name, []).append(e)
    spans = {}
    for u in profiling._REC.units:
        for path, parent, t0, t1, _, _ in u.spans:
            spans.setdefault(profiling.PREFIX + path.rsplit("/", 1)[-1],
                             []).append((t0, t1))
    assert set(spans) == set(events)
    for name, mine in spans.items():
        theirs = sorted(events[name], key=lambda e: e.time_range.start)
        assert len(mine) == len(theirs), name
        for (t0, t1), e in zip(sorted(mine), theirs):
            host_us = (t1 - t0) / 1e3
            event_us = e.time_range.elapsed_us()
            assert abs(host_us - event_us) <= max(0.05 * event_us, 20.0), (
                name, host_us, event_us)
            # one clock: the span's start is the event's, in Unix-epoch ns
            assert abs(t0 - (start_ns + e.time_range.start * 1e3)) < 1e6, name


def test_a_sync_inside_a_unit_is_counted_at_its_site():
    """torch's own warning, raised under ``generate_anchors``'s copy of its
    numpy anchors, counts at that line; one outside a unit does not, and
    other warnings pass on."""
    real = torch.tensor

    def syncing(*a, **k):
        warnings.warn("called a synchronizing CUDA operation", UserWarning)
        return real(*a, **k)

    src, first = inspect.getsourcelines(anchors.generate_anchors)
    line = first + next(i for i, s in enumerate(src) if "torch.tensor(" in s)
    with profile(activities=[ProfilerActivity.CPU]), \
            warnings.catch_warnings(record=True) as seen, \
            mock.patch("torch.tensor", syncing):
        warnings.simplefilter("always")
        anchors.generate_anchors(2, 2, 16)  # outside a unit: shown
        with profiling.unit("request"):
            anchors.generate_anchors(2, 2, 16)
            anchors.generate_anchors(3, 2, 16)
            warnings.warn("another warning", RuntimeWarning)
    s = profiling.summary("request")
    assert s["syncs"] == {f"ops/anchors.py:{line}": 2.0}
    assert [str(w.message) for w in seen] == [
        "called a synchronizing CUDA operation", "another warning"]


def test_launch_counters_count_by_name_and_cpu_routes_launch_nothing(toy):
    model, step, batch = toy
    profiling.count("k2.staged")
    profiling.count("k2.staged", 2)
    assert profiling.counts() == {"k2.staged": 3}
    profiling.reset()
    assert profiling.counts() == {}
    # on CPU tensors every wrapper takes its plain version: no counter moves
    with profile(activities=[ProfilerActivity.CPU]):
        _run(model, step, batch)
    assert not set(profiling.counts()) & set(COUNTERS)


def test_device_trace_carries_the_programs_spans(toy, tmp_path):
    model, _, batch = toy
    with profiling.device_trace(str(tmp_path)):
        model.test_forward(batch)
    with open(tmp_path / f"trace_{os.getpid()}.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {profiling.PREFIX + s for s in ("request",) + REQUEST} <= names
    assert profiling.summary("request")["units"] == 1


def test_a_toy_traced_cell_records_its_requests_and_reports_no_card_metric(
        tmp_path):
    """The benchmark's traced pass on the CPU records the cell's request in
    the program's recorder (host ms, no sync, no stream ms); the eight
    readers report nothing without a card, as the harness's readers with
    nothing to read leave their metric out."""
    from benchmark import run as bench_run
    from benchmark.tests import toy as bench_toy

    spec = bench_toy.make(tmp_path, limits={"score_err": 10, "box_err": 10,
                                            "mask_err": 10, "unanswered": 0})
    line, _, _ = bench_run.run_cell("omniiseg-serve-b1", 2**31 + 11, 0.5, True,
                                    "cpu", time.time(), spec, tmp_path,
                                    tmp_path / "benchmark")
    s = profiling.summary("request")
    assert s["units"] == 1 and s["syncs"] == {}
    assert s["spans"]["request"]["host_ms"] > 0
    assert s["spans"]["request"]["stream_ms"] is None
    assert set(s["spans"]) == ({"request", "request/mask_head/roi"}
                               | {f"request/{x}" for x in REQUEST})
    new = {"rpn_ms.serve", "box_head_ms.serve", "mask_head_ms.serve",
           "host_ms.serve", "syncs.serve", "forward_ms.train",
           "host_ms.train", "syncs.train"}
    assert new <= {m["name"] for m in spec["per_layer"]}
    assert line["correct"] is True and not new & set(line["metrics"])


# what each of the benchmark's readers of the recorder reads: (unit, span
# path or None for the syncs, field)
READS = {"rpn_ms.serve": ("request", "request/rpn", "stream_ms"),
         "box_head_ms.serve": ("request", "request/box_head", "stream_ms"),
         "mask_head_ms.serve": ("request", "request/mask_head", "stream_ms"),
         "host_ms.serve": ("request", "request", "host_ms"),
         "syncs.serve": ("request", None, "syncs"),
         "forward_ms.train": ("step", "step/forward", "stream_ms"),
         "host_ms.train": ("step", "step", "host_ms"),
         "syncs.train": ("step", None, "syncs")}


@pytest.mark.parametrize("name", sorted(READS))
def test_each_reader_reads_its_span_or_count(name, monkeypatch):
    from benchmark.harness import common

    reader = common.load_metric(name)
    kind, path, field = READS[name]
    times = {"host_ms": 31.5, "stream_ms": 29.25, "self_host_ms": 1.0,
             "self_stream_ms": 0.5}
    card = {"units": 4, "spans": {kind: dict(times)},
            "syncs": {"ops/anchors.py:59": 1.0, "ops/nms.py:124": 2.0}}
    if path:
        card["spans"][path] = {k: v / 2 for k, v in times.items()}
    empty = {"units": 0, "spans": {}, "syncs": {}}
    monkeypatch.setattr(profiling, "summary",
                        lambda k: card if k == kind else empty)
    want = 3.0 if field == "syncs" else card["spans"][path][field]
    assert reader.read(None) == want
    # without a card (no CUDA events) nothing is measured
    for v in card["spans"].values():
        v["stream_ms"] = v["self_stream_ms"] = None
    assert reader.read(None) is None
    monkeypatch.setattr(profiling, "summary", lambda k: empty)
    assert reader.read(None) is None
    # a program without the recorder
    monkeypatch.delattr(profiling, "summary")
    assert reader.read(None) is None
