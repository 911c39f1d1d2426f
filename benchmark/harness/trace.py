"""The traced stretch of a ``--trace 1`` run: spans wrapped around the
program's methods from the benchmark's files, ``torch.profiler`` over a
dozen requests or steps, and what the per-layer readers read from it.

A span is a ``record_function`` range named ``bench/<attr>`` around a
method of the program, patched on its class only while the stretch runs;
each call's tensor arguments and result are kept by shape and dtype, so a
reader can work out the bytes and operations a call needs. A span's device
time is the device time of the kernels launched inside it, as the profiler
attributes them (``device_time_total`` of the range). The device is busy
where any device event (kernel, copy, fill) runs; the window spans the
stretch's requests or steps on the host clock, which the profiler aligns
with the device's.
"""

from __future__ import annotations

import importlib
from collections import defaultdict
from contextlib import ExitStack
from typing import Callable, Dict, List, Optional, Sequence, Tuple
from unittest import mock

import numpy as np
import torch

Span = Tuple[str, str, str]  # (module, class, attribute)
GAPS_NAMED = 3000  # the longest idle gaps are named by the host's operation


def _desc(x):
    if isinstance(x, torch.Tensor):
        return {"shape": tuple(x.shape), "itemsize": x.element_size(),
                "dtype": str(x.dtype)}
    if isinstance(x, (tuple, list)):
        return [_desc(v) for v in x]
    return None


class Records:
    """What the readers read: spans, device events, counts, rates."""

    def __init__(self):
        self.calls: Dict[str, List[Dict]] = defaultdict(list)  # span → calls
        self.span_device_us: Dict[str, List[float]] = defaultdict(list)
        self.node_device_us: Dict[str, List[float]] = defaultdict(list)
        self.device_intervals: List[Tuple[float, float]] = []
        self.window_us: Tuple[float, float] = (0.0, 0.0)
        self.host_window_s: Optional[float] = None
        self.units = 0  # requests or steps profiled
        self.rate_imgs_s: Optional[float] = None  # the untraced stretch's
        self.flops_per_img: Optional[float] = None
        self.peak_flops: Optional[float] = None
        self.hbm_bytes_s: Optional[float] = None
        self.timings_ms: Dict[str, List[float]] = defaultdict(list)
        self.breakdown: Dict[str, list] = {}

    @property
    def window_s(self) -> float:
        """The stretch's host-clock seconds (the device-only pass's, on a
        card), else the span of its units."""
        if self.host_window_s is not None:
            return self.host_window_s
        return (self.window_us[1] - self.window_us[0]) / 1e6

    @property
    def busy_s(self) -> float:
        """Seconds in which some device event ran: the union of their
        intervals."""
        busy, end = 0.0, float("-inf")
        for a, b in sorted(self.device_intervals):
            if b <= end:
                continue
            busy += b - max(a, end)
            end = b
        return busy / 1e6


def span_wrapper(name: str, fn: Callable, rec: Records):
    def wrapped(*a, **k):
        with torch.profiler.record_function(f"bench/{name}"):
            out = fn(*a, **k)
        rec.calls[name].append({"args": [_desc(x) for x in a[1:]],
                                "out": _desc(out)})
        return out
    return wrapped


def _device_us(e) -> float:
    v = getattr(e, "device_time_total", None)
    return float(v if v is not None else e.cuda_time_total)


def _on_device(e) -> bool:
    return e.device_type.name in ("CUDA", "PrivateUse1") and not e.is_user_annotation


def profile(run_units: Callable[[Records], None], spans: Sequence[Span],
            rec: Records, nodes: Sequence[str] = ()) -> Records:
    """Profile ``run_units(rec)``, which runs the stretch's requests or
    steps inside ``bench/unit`` ranges and counts them in ``rec.units``
    (``run_units(None)``: the same, uncounted). On a card it runs twice:
    first under the device's profiler alone, for the busy time against
    the host clock's window; then with the host's operations too and each
    span wrapped, for the spans, the ``nodes`` (autograd nodes, by their
    profiler range's name) and the breakdown."""
    import time

    from torch.profiler import ProfilerActivity, profile as tprofile

    cuda = torch.cuda.is_available()
    if cuda:  # the device alone: busy and idle, with little host overhead
        with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run_units(None)
            torch.cuda.synchronize()
            rec.host_window_s = time.perf_counter() - t0
        rec.device_intervals = [(e.time_range.start, e.time_range.end)
                                for e in prof.events() if _on_device(e)]
    with ExitStack() as stack:
        for mod, cls, attr in spans:
            owner = getattr(importlib.import_module(mod), cls)
            stack.enter_context(mock.patch.object(
                owner, attr, span_wrapper(attr, getattr(owner, attr), rec)))
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with tprofile(activities=acts) as prof:
            run_units(rec)
            if cuda:
                torch.cuda.synchronize()
    events = prof.events()
    units = [e for e in events if e.name == "bench/unit" and not _on_device(e)
             and e.device_type.name == "CPU"]
    if units:
        rec.window_us = (min(e.time_range.start for e in units),
                         max(e.time_range.end for e in units))
    for e in events:
        if e.device_type.name != "CPU":
            continue
        if e.name.startswith("bench/") and e.name != "bench/unit":
            rec.span_device_us[e.name[6:]].append(_device_us(e))
        elif e.name in nodes:
            rec.node_device_us[e.name].append(_device_us(e))
    rec.breakdown = breakdown(events, rec)
    return rec


def breakdown(events, rec: Records, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, and the device's idle
    gaps inside the window summed by what the host was doing meanwhile
    (the innermost host operation running at the gap's midpoint)."""
    by_op: Dict[str, float] = defaultdict(float)
    lo, hi = rec.window_us
    dev = []
    for e in events:
        if _on_device(e) and e.time_range.end > lo and e.time_range.start < hi:
            by_op[e.name] += (e.time_range.end - e.time_range.start) / 1e6
            dev.append((e.time_range.start, e.time_range.end))
    dev.sort()
    gaps, end = [], lo
    for a, b in dev:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if hi > end:
        gaps.append((end, hi))
    host = [(e.time_range.start, e.time_range.end, e.name) for e in events
            if e.device_type.name == "CPU" and e.name != "bench/unit"
            and e.time_range.end > lo and e.time_range.start < hi]
    starts = np.array([h[0] for h in host], dtype=np.float64)
    ends = np.array([h[1] for h in host], dtype=np.float64)
    by_host: Dict[str, float] = defaultdict(float)
    gaps.sort(key=lambda g: g[0] - g[1])
    for a, b in gaps[:GAPS_NAMED]:
        mid = (a + b) / 2
        cover = (starts <= mid) & (ends >= mid)
        name = "(no host op)"
        if cover.any():
            i = np.flatnonzero(cover)[np.argmin((ends - starts)[cover])]
            name = host[i][2]
        by_host[name] += (b - a) / 1e6
    rest = sum(b - a for a, b in gaps[GAPS_NAMED:]) / 1e6
    if rest:
        by_host["(shorter gaps)"] += rest
    ops_top = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    gaps_top = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops_top],
            "idle_gaps": [[k, v] for k, v in gaps_top]}


class EventTimer:
    """CUDA events around calls of the program's methods: device ms a call,
    by label (``timed(label, fn)``)."""

    def __init__(self):
        self.marks: Dict[str, list] = defaultdict(list)

    def timed(self, label: str, fn: Callable):
        def wrapped(*a, **k):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*a, **k)
            e.record()
            self.marks[label].append((s, e))
            return out
        return wrapped

    def ms(self) -> Dict[str, List[float]]:
        torch.cuda.synchronize()
        return {k: [s.elapsed_time(e) for s, e in v] for k, v in self.marks.items()}
