"""The port's recorder: spans and counters inside the program, and a
Chrome-trace exporter.

Spans record only while a ``torch.profiler`` runs (any profiler: the
benchmark's traced passes, ``device_trace``, an operator's own). With none
running, ``span(name)`` reads one module bool and returns a shared no-op
object: it allocates nothing, opens no profiler range and makes no CUDA
event.

While a profiler runs, a span records

  * a profiler range named ``fgn/<name>``, so a trace nests the program's
    layers with the device's kernels on one clock;
  * its start and end on the host in Unix-epoch ns (``time.time_ns``), the
    axis the profiler puts its host events on once it converts its tick
    counts (``torch._C._profiler._get_approximate_time`` reads TSC ticks
    on x86, not ns);
  * on a CUDA device, a pair of timing events on the current stream: their
    ``elapsed_time`` is the span's stream ms, from when the stream finishes
    the work queued before the span to when it finishes the span's own,
    idle time inside included;
  * its parent span and the id of its unit.

A unit is the outermost span: ``unit("request")`` is the body of
``FGN.test_forward``, ``unit("step")`` that of ``make_train_step``'s
``step``. While a unit records on a CUDA device, every synchronizing CUDA
operation (``torch.cuda.set_sync_debug_mode("warn")``) is counted by its
site, the innermost frame under ``fgn_torch/``. Spans are named by their
path from the unit (``request/mask_head/roi``). CUDA events are resolved
when a summary is asked for; the last ``KEEP`` units are kept.

``count(name, n)`` is an always-on process counter: the kernels' wrappers
count their launches by route (``k1.staged``, ``k1.direct``,
``k1_bwd.staged``, ``k1_bwd.atomic``, ``k2.staged``, ``k2.unstaged``,
``gn.onepass``, ``gn.split``; ``gn.autograd`` counts the GroupNorm calls
that took the library composition because autograd records them).
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time
import warnings
from collections import Counter, deque
from typing import Dict, Iterator, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

try:  # a profiler range at a few µs a span; record_function costs tens
    from torch._C._profiler import _RecordFunctionFast as _Range
except ImportError:  # older torch
    _Range = torch.profiler.record_function

KEEP = 256  # units kept in memory
PREFIX = "fgn/"  # profiler ranges of the program's spans
_SYNC_MESSAGE = "called a synchronizing CUDA operation"
_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__))) + os.sep
_HERE = os.path.abspath(__file__)


class _Off:
    """The span of a process with no profiler running: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Unit:
    """One request or step: its spans in order of opening (the unit's own
    first), each ``[path, parent index, host t0 ns, host t1 ns, start event,
    end event]``, and its syncs by site."""

    __slots__ = ("kind", "id", "spans", "syncs", "cuda")

    def __init__(self, kind: str, uid: int):
        self.kind = kind
        self.id = uid
        self.spans: List[list] = []
        self.syncs: Counter = Counter()
        # CUDA events and sync counting where the process uses a card
        self.cuda = torch.cuda.is_available() and torch.cuda.is_initialized()


class _Span:
    """A recording span: of the open unit, else a unit of its own when
    ``opens_unit``, else a bare profiler range."""

    __slots__ = ("rec", "name", "opens_unit", "unit", "index", "range",
                 "sync_mode", "catch")

    def __init__(self, rec: "Recorder", name: str, opens_unit: bool = False):
        self.rec = rec
        self.name = name
        self.opens_unit = opens_unit
        self.unit = None
        self.sync_mode = None
        self.catch = None

    def __enter__(self):
        rec = self.rec
        stack = rec._stack()
        if stack:
            self.unit, parent = stack[-1]
            path = self.unit.spans[parent][0] + "/" + self.name
        elif self.opens_unit:
            self.unit, parent, path = rec._open(self.name), -1, self.name
            self._watch_syncs()
        self.range = _Range(PREFIX + self.name)
        self.range.__enter__()
        if self.unit is not None:
            self.index = len(self.unit.spans)
            start = end = None
            if self.unit.cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            self.unit.spans.append(
                [path, parent, time.time_ns(), 0, start, end])
            stack.append((self.unit, self.index))
        return self

    def __exit__(self, *exc):
        if self.unit is not None:
            s = self.unit.spans[self.index]
            if s[5] is not None:
                s[5].record()
            s[3] = time.time_ns()
            self.rec._stack().pop()
        self.range.__exit__(None, None, None)
        if self.catch is not None:
            self.catch.__exit__(None, None, None)
            if self.sync_mode is not None:
                torch.cuda.set_sync_debug_mode(self.sync_mode)
        return False

    def _watch_syncs(self):
        """Count the unit's synchronizing CUDA operations: torch warns at
        each once its sync debug mode is "warn" (on a CUDA build only)."""
        unit = self.unit
        self.catch = warnings.catch_warnings()
        self.catch.__enter__()
        shown = warnings.showwarning

        def show(message, category, filename, lineno, file=None, line=None):
            if str(message).startswith(_SYNC_MESSAGE):
                unit.syncs[_site(sys._getframe(1))] += 1
            else:
                shown(message, category, filename, lineno, file, line)

        warnings.filterwarnings("always", message=_SYNC_MESSAGE)
        warnings.showwarning = show
        if unit.cuda:
            self.sync_mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")


def _site(frame) -> str:
    """``file:line`` of the innermost frame under ``fgn_torch/`` (this
    module's own left out), relative to the package."""
    while frame is not None:
        f = frame.f_code.co_filename
        if f.startswith(_PACKAGE) and f != _HERE:
            return f"{f[len(_PACKAGE):]}:{frame.f_lineno}"
        frame = frame.f_back
    return "(outside fgn_torch)"


class Recorder:
    """Spans of the last ``KEEP`` units and the process's counters."""

    def __init__(self):
        self.units: deque = deque(maxlen=KEEP)
        self.counts: Dict[str, int] = {}
        self._local = threading.local()
        self._next_id = 0

    def _stack(self) -> list:
        """The open spans of this thread: (unit, index) pairs."""
        s = getattr(self._local, "stack", None)
        if s is None:
            s = self._local.stack = []
        return s

    def _open(self, kind: str) -> _Unit:
        u = _Unit(kind, self._next_id)
        self._next_id += 1
        self.units.append(u)
        return u

    def summary(self, kind: str) -> Dict:
        """Means over the recorded units of ``kind``: ``units`` (their
        number); ``spans``: by path, ``host_ms``, ``stream_ms`` (None
        without CUDA events), ``self_host_ms`` and ``self_stream_ms`` (the
        span's time less its child spans'), a unit (a path that occurs
        more than once in a unit is summed within it); ``syncs``: by site,
        a unit."""
        units = [u for u in self.units if u.kind == kind and u.spans[0][3]]
        n = len(units)
        totals: Dict[str, List[Optional[float]]] = {}
        syncs: Counter = Counter()
        _resolve(units)
        for u in units:
            syncs.update(u.syncs)
            child_host = [0.0] * len(u.spans)
            child_stream = [0.0] * len(u.spans)
            for path, parent, t0, t1, ms, _ in u.spans:
                if parent >= 0:
                    child_host[parent] += (t1 - t0) / 1e6
                    child_stream[parent] += ms or 0.0
            for i, (path, parent, t0, t1, ms, _) in enumerate(u.spans):
                t = totals.setdefault(path, [0.0, None, 0.0, None])
                host = (t1 - t0) / 1e6
                t[0] += host
                t[2] += host - child_host[i]
                if ms is not None:
                    t[1] = (t[1] or 0.0) + ms
                    t[3] = (t[3] or 0.0) + ms - child_stream[i]
        spans = {p: {"host_ms": t[0] / n,
                     "stream_ms": None if t[1] is None else t[1] / n,
                     "self_host_ms": t[2] / n,
                     "self_stream_ms": None if t[3] is None else t[3] / n}
                 for p, t in totals.items()}
        return {"units": n, "spans": spans,
                "syncs": {k: v / n for k, v in syncs.items()}}


def _resolve(units) -> None:
    """Replace each span's pair of CUDA events by its stream ms."""
    pending = [s for u in units for s in u.spans if s[5] is not None]
    if pending:
        torch.cuda.synchronize()
    for s in pending:
        s[4], s[5] = s[4].elapsed_time(s[5]), None


_REC = Recorder()


def span(name: str):
    """A span named ``name`` (``with span("rpn"): ...``); see the module's
    docstring."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(_REC, name)


def unit(kind: str):
    """The outermost span of a ``kind`` unit, "request" or "step"; inside
    another unit, a span of it."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(_REC, kind, opens_unit=True)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the process counter ``name``."""
    _REC.counts[name] = _REC.counts.get(name, 0) + n


def counts() -> Dict[str, int]:
    """A copy of the process counters."""
    return dict(_REC.counts)


def summary(kind: str) -> Dict:
    """``Recorder.summary`` of the process's recorder."""
    return _REC.summary(kind)


def reset() -> None:
    """Forget the recorded units and zero the counters."""
    _REC.units.clear()
    _REC.counts.clear()


@contextlib.contextmanager
def device_trace(log_dir: str, enabled: bool = True) -> Iterator[None]:
    """Trace the block with ``torch.profiler`` (the CPU, and CUDA where
    there is a device) into ``log_dir/trace_<pid>.json``; the program's
    spans record meanwhile."""
    if not enabled:
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}.json"))
