"""Benchmark: episodic inference and train-step throughput with MFU, on one
NVIDIA GPU.

    python -m fgn_torch.bench

The port's twin of the JAX package's ``bench.py``: the same workloads, the
same environment variables and the same field names in one JSON line.

  * flagship OMNIISEG N3K3 geometry: 480x480 queries, 9 support crops of
    128x128, R50-C4, GN, bf16, seeded random weights, at the serving batch
    ``BENCH_BATCH`` (8: ``value``, ``blocked``, ``mfu``) and
    ``BENCH_BATCH_ALT`` (4: ``value_b4``, ``mfu_b4``);
  * the COCO2VOC geometry: 800x1088 canvases, 256 px supports,
    ``rpn_test_nms_pre=6144``, at ``BENCH_COCO_BATCH`` (4), N1K1 and N3K3
    (``coco2voc_n1k1_*``, ``coco2voc_n3k3_*``; ``BENCH_COCO=0`` skips them);
  * the train step (``train/train_step.py::make_train_step``: forward,
    backward, Adam at ``make_lr_schedule(5e-3, steps_per_epoch=1000)``) on
    the flagship at ``BENCH_TRAIN_BATCH`` (12), with ``FGNConfig.remat``
    from ``BENCH_REMAT`` (``train``, ``train_mfu``).

``BENCH_ITERS`` (20) steps a round and ``BENCH_ROUNDS`` (5) rounds a serving
workload (COCO2VOC: ``max(rounds - 2, 3)``; train: 3 rounds of
``max(iters // 4, 5)`` steps after 2 warm-up steps).

Timing. Each timed forward's query image is the previous one's plus
``max(dt_scores) * 1e-9`` of the previous forward, so every forward depends
on the one before (``chained``). A round is ``n_iters`` chained forwards
between two CUDA events; its rate is ``batch * n_iters / elapsed``. The end
event is recorded after the host has queued the round's last launch, so a
round's time includes the host's gaps wherever the card waits for the host.
``value`` is the median of the rounds, ``blocked`` the same with the chain's
scalar read on the host (``.item()``) after every forward; each median is
printed beside every round's rate (``*_rounds``). One chained forward warms
up first. Train rounds chain through the parameters, which the optimizer
updates in place.

FLOPs. ``ops/flops.py::count_flops`` (``FlopCounterMode``) over one
forward (one train step: forward, backward and optimizer), divided by the
batch: ``flops_per_img``, ``train_flops_per_img`` (GFLOP). The count leaves
out the work inside the kernels' calls (``ops/roi_align_cuda.py``: RoIAlign
and its backward; ``ops/nms_cuda.py``: the greedy-NMS keep mask), so it is
the same through the kernels, which launch through ``ctypes`` where the
counter cannot see them, and through their plain versions on CPU tensors,
whose einsums it counts. Their own work is counted apart from their shapes
(``kernel_flops_per_img``): RoIAlign and its backward a multiply-add for
each of 16 corner weights an output (a gradient) element, the keep mask 12
operations for each IoU a greedy walk of these boxes needs. ``mfu`` is
``value * flops_per_img`` over the card's dense bf16 tensor-core peak
(``PEAK_BF16``); ``train_mfu``, ``mfu_b4`` and ``coco2voc_*_mfu`` alike.

Deliberate differences from ``bench.py``:

  * nothing is swallowed: every failure raises, except a missing
    ``BASELINE.json``, which leaves ``vs_baseline`` null;
  * without CUDA, ``python -m fgn_torch.bench`` writes a message to stderr,
    prints no JSON and exits non-zero; an unknown card raises (no peak is
    assumed);
  * the functions take ``device=``; they time with CUDA events on a card,
    and with ``time.perf_counter`` only when the caller passes the CPU;
  * one card, no mesh; parameters from ``build_model(cfg, device, seed=0)``;
  * the train step's ROI sample comes from one ``torch.Generator`` seeded
    with 2 that runs on from step to step, so each step samples other ROIs;
    ``bench.py`` passes ``PRNGKey(2)`` to every step, which samples the same
    ROIs each time;
  * the line adds the card's ``nvidia-smi`` name and power limit
    (``device``, ``power_limit_w``), every round's rate, the kernels' FLOPs
    and the peak with its source.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from collections import Counter
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from fgn_torch.config import FGNConfig
from fgn_torch.data.batching import EpisodeBatch, to_device, toy_batch
from fgn_torch.entry import FLAGSHIP_CFG
from fgn_torch.models.fgn import FGN, build_model
from fgn_torch.ops.flops import count_flops
from fgn_torch.train.optim import build_optimizer, make_lr_schedule
from fgn_torch.train.train_step import make_train_step

# Dense (no sparsity) bf16 tensor-core peaks by torch.cuda.get_device_name,
# each with its data sheet.
PEAK_BF16 = {
    "H100 80GB HBM3": (989.4e12, "NVIDIA H100 Tensor Core GPU data sheet, "
                                 "H100 SXM5: 1,978.9 TFLOPS BF16 with "
                                 "sparsity, 989.4 dense"),
    "H100 PCIe": (756e12, "NVIDIA H100 Tensor Core GPU data sheet, H100 "
                          "PCIe: 1,513 TFLOPS BF16 with sparsity, 756 dense"),
}

class Geometry(NamedTuple):
    H: int  # query canvas
    W: int
    S: int  # support crop side


FLAGSHIP = Geometry(480, 480, 128)
COCO2VOC = Geometry(800, 1088, 256)
COCO2VOC_NMS_PRE = 6144
COCO2VOC_WAYS = (("n1k1", 1, 1), ("n3k3", 3, 3))


def peak_flops(name: str) -> Tuple[float, str]:
    """(the dense bf16 peak, its source) of the card named ``name``; raises
    for a card not in ``PEAK_BF16``."""
    for key, peak in PEAK_BF16.items():
        if key.lower() in name.lower():
            return peak
    raise KeyError(f"bench: no bf16 peak known for {name!r}; add it to "
                   f"PEAK_BF16 with its data sheet")


def gpu_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def make_model(n_ways: int, k_shots: int, device, **kw) -> FGN:
    """``bench.py``'s model: GN, unfrozen backbone, bf16 compute, seeded
    random weights (seed 0) on ``device``."""
    cfg = FGNConfig(**{**FLAGSHIP_CFG, "n_ways": n_ways, "k_shots": k_shots,
                       **kw})
    return build_model(cfg, device, seed=0)


def make_batch(nb: int, geom: Geometry, n_ways: int, k_shots: int,
               device) -> EpisodeBatch:
    """``toy_batch`` at ``geom`` on ``device`` (float32 query images)."""
    return to_device(toy_batch(B=nb, H=geom.H, W=geom.W, N=n_ways,
                               K=k_shots, S=geom.S), device)


def chained(forward: Callable, batch: EpisodeBatch, bias: torch.Tensor):
    """One forward on ``batch`` with ``bias`` added to its query images.
    → (the next bias, ``max(dt_scores) * 1e-9``; the outputs)."""
    out = forward(batch._replace(qry_img=batch.qry_img + bias))
    return out["dt_scores"].max() * 1e-9, out


def seconds(device, run: Callable[[], None]) -> float:
    """Seconds of ``run()``'s work: between two CUDA events on a card (the
    end event recorded after ``run`` returns, then waited for); on the
    host clock on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    if device.type != "cpu":
        raise ValueError(f"bench: cannot time on {device}")
    t0 = time.perf_counter()
    run()
    return time.perf_counter() - t0


def warm_up(forward: Callable, batch: EpisodeBatch) -> None:
    """One chained forward, its scalar read on the host."""
    bias, _ = chained(forward, batch, batch.qry_img.new_zeros(()))
    float(bias)


def serve_rounds(forward: Callable, batch: EpisodeBatch, n_iters: int,
                 n_rounds: int, device, blocked: bool = False) -> List[float]:
    """Images/s of each of ``n_rounds`` rounds of ``n_iters`` chained
    forwards; ``blocked`` reads the chain's scalar on the host after every
    forward. The chain runs on across rounds."""
    nb = batch.qry_img.shape[0]
    bias = batch.qry_img.new_zeros(())

    def one_round():
        nonlocal bias
        for _ in range(n_iters):
            bias, _ = chained(forward, batch, bias)
            if blocked:
                float(bias)

    return [nb * n_iters / seconds(device, one_round)
            for _ in range(n_rounds)]


def train_rounds(step: Callable, batch: EpisodeBatch,
                 generator: torch.Generator, n_iters: int, n_rounds: int,
                 device) -> List[float]:
    """Images/s of each of ``n_rounds`` rounds of ``n_iters`` train steps
    (``step(batch, generator)``, which updates the parameters in place)."""
    nb = batch.qry_img.shape[0]

    def one_round():
        for _ in range(n_iters):
            step(batch, generator)

    return [nb * n_iters / seconds(device, one_round)
            for _ in range(n_rounds)]


def _per_img(flops: Dict, nb: int) -> Dict:
    return {"batch": nb, "flops_per_img": flops["flops"] / nb,
            "kernel_flops_per_img": flops["kernel_flops"] / nb,
            "flops_by_op_per_img": {op: n / nb
                                    for op, n in flops["by_op"].items()}}


def serve_bench(model: FGN, batch: EpisodeBatch, n_iters: int,
                n_rounds: int, device, blocked: bool = True,
                forward: Optional[Callable] = None) -> Dict:
    """A serving workload: warm-up, rounds of chained forwards (and, with
    ``blocked``, rounds read on the host every forward), and the FLOPs of
    one ``test_forward`` an image. ``forward`` (default
    ``model.test_forward``) is what the rounds time."""
    nb = batch.qry_img.shape[0]
    forward = forward or model.test_forward
    warm_up(forward, batch)
    res = {"rounds": serve_rounds(forward, batch, n_iters, n_rounds, device),
           "hw": "x".join(str(n) for n in batch.qry_img.shape[1:3]),
           "n_iters": n_iters, "n_rounds": n_rounds}
    if blocked:
        res["blocked_rounds"] = serve_rounds(forward, batch, n_iters,
                                             n_rounds, device, blocked=True)
    res.update(_per_img(count_flops(lambda: model.test_forward(batch)), nb))
    return res


def make_train(nb: int, device, remat: str = "", geom: Geometry = FLAGSHIP):
    """``bench.py``'s trainer: the flagship with ``remat``, Adam at
    ``make_lr_schedule(5e-3, steps_per_epoch=1000)``, at batch ``nb``.
    → (model, optimizer, step, batch, generator)."""
    model = make_model(3, 3, device, remat=remat)
    opt = build_optimizer(model, optimizer="adam",
                          schedule=make_lr_schedule(5e-3,
                                                    steps_per_epoch=1000))
    step = make_train_step(model, opt)
    batch = make_batch(nb, geom, 3, 3, device)
    gen = torch.Generator(device=device).manual_seed(2)
    return model, opt, step, batch, gen


def train_bench(model: FGN, step: Callable, batch: EpisodeBatch,
                generator: torch.Generator, n_iters: int, device) -> Dict:
    """The train workload of ``model``'s ``step``: 2 warm-up steps, 3 rounds
    of ``max(n_iters // 4, 5)`` steps, and the FLOPs of one more step an
    image (forward, backward, optimizer)."""
    nb = batch.qry_img.shape[0]
    for _ in range(2):
        float(step(batch, generator)["loss_total"])
    steps = max(n_iters // 4, 5)
    res = {"rounds": train_rounds(step, batch, generator, steps, 3, device),
           "steps_per_round": steps, "remat": model.cfg.remat}
    res.update(_per_img(count_flops(lambda: step(batch, generator)), nb))
    return res


def device_info(device) -> Dict:
    """The card's torch name and ``nvidia-smi`` name and power limit (W);
    for the CPU, its name only."""
    if device.type != "cuda":
        return {"name": str(device), "nvidia_smi": None,
                "power_limit_w": None}
    name, limit = (s.strip() for s in gpu_line().rsplit(",", 1))
    return {"name": torch.cuda.get_device_name(device), "nvidia_smi": name,
            "power_limit_w": float(limit.split()[0])}


def describe(device, peak: Optional[float] = None) -> Dict:
    """The card (``device_info``) and its peak with the peak's source, or
    the ``peak`` the caller gives (the CPU tests)."""
    info = device_info(torch.device(device))
    peak, source = (peak_flops(info["name"]) if peak is None
                    else (peak, "given by the caller"))
    return {"device": info, "peak": peak, "peak_source": source}


def _free(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def run(device="cuda", batch: int = 8, batch_alt: int = 4,
        train_batch: int = 12, n_iters: int = 20, n_rounds: int = 5,
        coco: bool = True, coco_batch: int = 4, remat: str = "",
        flagship: Geometry = FLAGSHIP, coco2voc: Geometry = COCO2VOC,
        peak: Optional[float] = None) -> Dict:
    """Every workload on ``device``. → {workload: its results}, for
    ``report``. ``flagship`` and ``coco2voc`` cut the geometries for the
    CPU tests; ``peak`` is looked up from the card when None."""
    device = torch.device(device)
    res = describe(device, peak)
    model = make_model(3, 3, device)
    for tag, nb in (("flagship", batch), ("flagship_alt", batch_alt)):
        if tag == "flagship_alt" and not (batch_alt and batch_alt != batch):
            continue
        res[tag] = serve_bench(model, make_batch(nb, flagship, 3, 3, device),
                               n_iters, n_rounds, device,
                               blocked=tag == "flagship")
    del model
    _free(device)
    if coco:
        for tag, n, k in COCO2VOC_WAYS:
            model = make_model(n, k, device,
                               rpn_test_nms_pre=COCO2VOC_NMS_PRE)
            res[f"coco2voc_{tag}"] = serve_bench(
                model, make_batch(coco_batch, coco2voc, n, k, device),
                n_iters, max(n_rounds - 2, 3), device, blocked=False)
            del model
            _free(device)
    model, opt, step, tbatch, gen = make_train(train_batch, device, remat,
                                               flagship)
    res["train"] = train_bench(model, step, tbatch, gen, n_iters, device)
    del model, opt, step, tbatch, gen
    _free(device)
    res["batch_alt"] = batch_alt
    return res


def _baseline() -> Optional[float]:
    """BASELINE.json["published"]'s torch-GPU estimate, None when the file
    is missing (run from the repo's root, as ``bench.py``)."""
    try:
        with open("BASELINE.json") as f:
            pub = json.load(f).get("published", {})
    except FileNotFoundError:
        return None
    return float(pub.get("torch_gpu_inference_imgs_s_est", 0)) or None


def report(res: Dict) -> Dict:
    """The JSON line: every field of ``bench.py`` (same names and units),
    plus each median's rounds, the train rounds' steps, the kernels' FLOPs,
    the card's ``nvidia-smi`` name and power limit and the peak with its
    source. The settings come from the workloads' results; ``batch_alt``
    from ``res`` where ``run`` set it (``bench.py`` prints it also when the
    b4 workload is skipped)."""
    peak = res["peak"]
    med = statistics.median

    def mfu(rate, flops_per_img):
        return rate * flops_per_img / peak

    fl, tr = res["flagship"], res["train"]
    value, train = med(fl["rounds"]), med(tr["rounds"])
    alt = res.get("flagship_alt")
    value_b4 = med(alt["rounds"]) if alt else 0.0
    base = _baseline()
    out = {
        "metric": "query imgs/sec/chip (episodic inference, N3K3 480px)",
        "value": value,
        "unit": "imgs/sec/chip",
        "vs_baseline": value / base if base else None,
        "blocked": med(fl["blocked_rounds"]),
        "train": train,
        "train_batch": tr["batch"],
        "train_flops_per_img": tr["flops_per_img"] / 1e9,
        "train_mfu": mfu(train, tr["flops_per_img"]),
        "train_remat": tr["remat"],
        "flops_per_img": fl["flops_per_img"] / 1e9,
        "flops_unit": "GFLOP",
        "mfu": mfu(value, fl["flops_per_img"]),
        "device": res["device"]["name"],
        "batch": fl["batch"],
        "value_b4": value_b4,
        "mfu_b4": mfu(value_b4, alt["flops_per_img"]) if alt else 0.0,
        "batch_alt": res.get("batch_alt", alt["batch"] if alt else 0),
        "iters": fl["n_iters"],
        "rounds": fl["n_rounds"],
        "value_rounds": fl["rounds"],
        "blocked_rounds": fl["blocked_rounds"],
        "value_b4_rounds": alt["rounds"] if alt else [],
        "train_rounds": tr["rounds"],
        "train_steps_per_round": tr["steps_per_round"],
        "kernel_flops_per_img": fl["kernel_flops_per_img"] / 1e9,
        "train_kernel_flops_per_img": tr["kernel_flops_per_img"] / 1e9,
        "nvidia_smi_name": res["device"]["nvidia_smi"],
        "power_limit_w": res["device"]["power_limit_w"],
        "peak_flops": peak,
        "peak_source": res["peak_source"],
    }
    for tag, _n, _k in COCO2VOC_WAYS:
        c = res.get(f"coco2voc_{tag}")
        if c is None:
            continue
        rate = med(c["rounds"])
        out.update({
            f"coco2voc_{tag}_imgs_s": rate,
            f"coco2voc_{tag}_flops_per_img": c["flops_per_img"] / 1e9,
            f"coco2voc_{tag}_mfu": mfu(rate, c["flops_per_img"]),
            f"coco2voc_{tag}_rounds": c["rounds"],
            f"coco2voc_{tag}_kernel_flops_per_img":
                c["kernel_flops_per_img"] / 1e9,
            "coco2voc_batch": c["batch"],
            "coco2voc_hw": c["hw"],
        })
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("fgn_torch.bench: no CUDA device; the bench runs on a card "
              "only", file=sys.stderr)
        return 2
    env = os.environ.get
    res = run(
        "cuda",
        batch=int(env("BENCH_BATCH", 8)),
        batch_alt=int(env("BENCH_BATCH_ALT", 4)),
        train_batch=int(env("BENCH_TRAIN_BATCH", 12)),
        n_iters=int(env("BENCH_ITERS", 20)),
        n_rounds=int(env("BENCH_ROUNDS", 5)),
        coco=env("BENCH_COCO", "1") != "0",
        coco_batch=int(env("BENCH_COCO_BATCH", 4)),
        remat=env("BENCH_REMAT", ""),
    )
    print(json.dumps(report(res)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
