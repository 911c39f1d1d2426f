"""Run one cell of the benchmark once and print one result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the program (``fgn_torch``).
Everything a cell is made of is found by name from ``BENCHMARK.json``:
its configuration (``configs/<config>.json``), its traffic
(``traffic/<traffic>.json``, whose ``loop`` names ``loops/<loop>.py``),
its limits (``limits/<cell>.json``) and, with ``--trace 1``, a reader a
per-layer metric (``metrics/<metric>.py``).

A run sets up (kernels, weights made on the card from the seed, the
request pool, warm-up), measures for ``--seconds``, then, with
``--trace 1``, profiles a short stretch for the per-layer metrics, and
last compares the window's outputs with the float32 reference. The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the end-to-end ones, or the per-layer ones with
``--trace 1``), ``device``, ``breakdown`` (traced runs) and ``checks``,
each number compared beside its limit. Standard error ends with the same
numbers and limits. Exit codes: 0 a result; 2 no card, or fewer than the
cell asks for; 3 no program in the checkout; 4 JAX or the JAX package was
loaded.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.harness import common  # noqa: E402
from benchmark.harness.common import log  # noqa: E402


def run_cell(name: str, seed: int, seconds: float, trace: bool, dev, t_start: float,
             spec=None, root=common.ROOT, bench_dir=common.BENCH_DIR):
    """One run of cell ``name`` on ``dev``. → (the result line's object,
    earlier lines for standard output, the last lines for standard
    error). ``spec``, ``root`` and ``bench_dir`` default to this
    checkout's."""
    import torch

    spec = spec or common.load_spec()
    cell = common.Cell.load(name, spec, root, bench_dir)
    ctx = common.Ctx(cell=cell, seed=seed, seconds=seconds, trace=trace,
                     dev=torch.device(dev), t_start=t_start)
    readers = {}
    if trace:
        for m in cell.per_layer:
            readers[m] = common.load_metric(m, bench_dir)
            for s in getattr(readers[m], "SPANS", ()):
                if tuple(s) not in ctx.spans:
                    ctx.spans.append(tuple(s))
            for n in getattr(readers[m], "NODES", ()):
                if n not in ctx.nodes:
                    ctx.nodes.append(n)
    loop = importlib.import_module(f"benchmark.loops.{cell.traffic['loop']}")
    out = loop.run(ctx)

    units = {m["name"]: m["unit"] for m in spec["end_to_end"] + spec["per_layer"]}
    metrics = {}
    if trace:
        for m, reader in readers.items():
            v = reader.read(out.rec)
            if v is not None:
                metrics[m] = {"value": v, "unit": units[m]}
    else:
        for m in cell.e2e:
            metrics[m] = {"value": out.metrics[m], "unit": units[m]}
    checks = {}
    for k, limit in cell.limits.items():
        checks[k] = {"value": out.readings[k], "limit": limit}
    correct = bool(checks) and all(c["value"] <= c["limit"] for c in checks.values())
    cuda = ctx.dev.type == "cuda"
    device = {"platform": "gpu" if cuda else ctx.dev.type,
              "kind": torch.cuda.get_device_name(ctx.dev) if cuda else "cpu",
              "count": cell.chips, "memory_peak_bytes": out.peak_bytes}
    line = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = out.rec.busy_s
        device["window_s"] = out.rec.window_s
        line["breakdown"] = out.rec.breakdown
    line["checks"] = checks
    notes = list(out.notes) + [f"card at {w}: {r}" for w, r in ctx.cards]
    tail = [f"check {k}: {c['value']!r} limit {c['limit']!r}" for k, c in checks.items()]
    return line, notes, tail


def main(argv=None) -> int:
    t_start = common.process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    common.set_cache_dirs()
    import torch

    spec = common.load_spec()
    chips = common.find(spec["workloads"], args.workload, "workload")["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"benchmark: the cell needs {chips} CUDA device(s); "
            f"{torch.cuda.device_count()} available")
        return 2
    try:
        import fgn_torch  # noqa: F401  the program under test
    except ImportError as e:
        log(f"benchmark: the program is not in this checkout ({e})")
        return 3
    line, notes, tail = run_cell(args.workload, args.seed, args.seconds,
                                 bool(args.trace), "cuda", t_start, spec)
    banned = common.banned_modules()
    if banned:
        log(f"benchmark: loaded in this process: {', '.join(banned)}")
        return 4
    for n in notes:
        print(n, flush=True)
    for t in tail:
        log(t)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
