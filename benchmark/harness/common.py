"""What every run shares: the files it reads by name, the program's model
with the seeded weights, the card's readings, the guard against JAX."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
CACHE = BENCH_DIR / ".cache"
BANNED = ("jax", "jaxlib", "flax", "fgn_tpu")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def set_cache_dirs() -> None:
    """Every build and kernel cache the program or PyTorch may write, at
    fixed paths inside the checkout (the port's own nvcc outputs stay in
    ``fgn_torch/_build/``, also inside the checkout)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        path = CACHE / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)


def process_start() -> float:
    """The process's start on ``time.time()``'s clock (Linux: from
    ``/proc``; elsewhere: now)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_spec() -> Dict:
    return load_json(ROOT / "BENCHMARK.json")


def find(items: List[Dict], name: str, what: str) -> Dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def applies(metric: Dict, cell: str, e2e_names: List[str]) -> bool:
    """Whether ``metric`` is reported in ``cell``: listed under its
    ``workloads``, or, without that key, wherever the end-to-end metric it
    moves is reported (``e2e_names``: the cell's)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def load_metric(name: str, bench_dir: Path = BENCH_DIR):
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One run's inputs, all read from files named in BENCHMARK.json."""

    name: str
    config: Dict
    traffic: Dict
    limits: Dict[str, float]
    e2e: List[str]
    per_layer: List[str]
    chips: int
    bench_dir: Path = BENCH_DIR

    @classmethod
    def load(cls, name: str, spec: Optional[Dict] = None, root: Path = ROOT,
             bench_dir: Path = BENCH_DIR) -> "Cell":
        """``root``: where the spec's file paths start; ``bench_dir``: the
        folder of traffic, limits and metric files."""
        spec = spec or load_spec()
        wl = find(spec["workloads"], name, "workload")
        conf = find(spec["configs"], wl["config"], "config")
        e2e = [m["name"] for m in spec["end_to_end"]
               if "workloads" not in m or name in m["workloads"]]
        per_layer = [m["name"] for m in spec["per_layer"] if applies(m, name, e2e)]
        return cls(name=name, config=load_json(root / conf["file"]),
                   traffic=load_json(bench_dir / "traffic" / f"{wl['traffic']}.json"),
                   limits=load_json(bench_dir / "limits" / f"{name}.json"),
                   e2e=e2e, per_layer=per_layer, chips=wl["chips"],
                   bench_dir=bench_dir)


def fgn_config(cfg: Dict):
    """The program's ``FGNConfig`` of a configuration file."""
    from fgn_torch.config import FGNConfig

    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg["model"].items()}
    return FGNConfig(**kw)


def param_shapes(cfg: Dict) -> Dict:
    """The reference's parameter names and shapes (no memory: ``meta``)."""
    import torch

    from benchmark.reference.fgn import RefFGN

    with torch.device("meta"):
        ref = RefFGN(cfg["model"])
    return {n: p.shape for n, p in ref.named_parameters()}


def program_model(cfg: Dict, seed: int, dev):
    """The program's FGN with the seeded weights, loaded by name."""
    from fgn_torch.models.fgn import FGN

    from benchmark.harness.weights import make_state_dict

    model = FGN(fgn_config(cfg)).to(dev)
    model.load_state_dict(make_state_dict(param_shapes(cfg), seed, dev), strict=True)
    return model


def reference_model(cfg: Dict, seed: int, dev, precision: str = "f32"):
    from benchmark.harness.weights import make_state_dict
    from benchmark.reference.fgn import RefFGN

    ref = RefFGN(cfg["model"], precision).to(dev)
    ref.load_state_dict(make_state_dict(param_shapes(cfg), seed, dev), strict=True)
    return ref


def card_reading() -> Optional[str]:
    """nvidia-smi's name, SM and memory clocks, power draw and limit and
    temperature of the first card, or None where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.mem,power.draw,"
             "power.limit,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def banned_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(BANNED))


def quantile(values: List[float], q: float) -> float:
    """The q-quantile of all values, linearly interpolated between order
    statistics (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = q * (len(v) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


@dataclasses.dataclass
class Outcome:
    """What a loop hands back: end-to-end metrics, counts, the readings of
    the comparison, the traced stretch's records, the device's peak."""

    metrics: Dict[str, float]
    attempted: int
    failed: int
    readings: Dict[str, float]
    rec: object
    peak_bytes: int
    notes: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Ctx:
    """One run: its cell, seed, window, device and what the traced
    stretch wraps (``spans``: (module, class, attribute); ``nodes``:
    autograd nodes)."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    dev: object
    t_start: float
    spans: List = dataclasses.field(default_factory=list)
    nodes: List = dataclasses.field(default_factory=list)
    cards: List = dataclasses.field(default_factory=list)

    def mark(self, phase: str) -> None:
        """Log the seconds since the process started, as a phase of set-up
        ends."""
        log(f"set-up: {phase} done at {time.time() - self.t_start:.3f} s")

    def card(self, when: str) -> None:
        """nvidia-smi's reading beside the window, on stderr."""
        if self.dev.type != "cuda":
            return
        reading = card_reading()
        self.cards.append((when, reading))
        log(f"card at {when}: {reading}")

    def peak_bytes(self) -> int:
        import torch

        if self.dev.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.dev))

    def free(self) -> None:
        import gc

        import torch

        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
