#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA GPU.

    python3 chip_smoke.py

Builds fgn_torch's CUDA kernels from ``fgn_torch/csrc`` with nvcc (sm_90a),
holds each kernel against its plain PyTorch version at the shapes of the
episodic inference path, drives ``FGN.test_forward`` (R50-C4, N3K3, 480 px,
batch 8, bf16, seeded random weights) through the kernels with launch
counters, compares the whole forward against its plain-version twin in
f32, and runs the COCO2VOC geometry (800x1088, b4). With ``--profile`` it
also prints where one flagship forward's device time goes (torch.profiler).

Prints its measurements on earlier lines; the line before the last is one
JSON object of the kernels, the last line is
``{"ok": true, "device": {...}}``. Any failed check raises and the script
exits non-zero. Without a CUDA device, or without the fgn_torch package
beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time
from unittest import mock

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and the f32 rate
# outside the tensor cores, at the full 700 W power limit.
HBM_BYTES_S = 3.35e12
F32_FLOPS_S = 67e12
IOU_FLOPS = 12  # min, max, sub (x2 axes), mul, add, sub, max, div, compare


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


@contextlib.contextmanager
def strict_f32():
    """TF32 off and deterministic cuDNN, for the f32 comparisons only; the
    settings before are restored after, so the timed forwards run with
    PyTorch's defaults."""
    import torch

    b = torch.backends
    saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,
             b.cudnn.deterministic, b.cudnn.benchmark)
    b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = False
    b.cudnn.deterministic, b.cudnn.benchmark = True, False
    try:
        yield
    finally:
        (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,
         b.cudnn.deterministic, b.cudnn.benchmark) = saved


def gpu_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, warmup=2):
    """Median ms of fn over iters runs, CUDA events, after warmup."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def random_rois(gen, B, R, extent, dev):
    """XYXY rois in image px over a canvas of ``extent`` px: most inside,
    some partly or wholly outside the map, some of zero size."""
    import torch

    ctr = torch.rand((B, R, 2), generator=gen) * (extent * 1.4) - 0.2 * extent
    wh = torch.rand((B, R, 2), generator=gen) * (extent * 0.6)
    rois = torch.cat([ctr - wh / 2, ctr + wh / 2], dim=-1)
    rois[:, 3::7, 2:] = rois[:, 3::7, :2]  # zero-size
    rois[:, 5::11] += 3 * extent  # wholly outside
    return rois.to(dev).contiguous()


def phase_roi_align(dev, shapes):
    """K1 against its plain version (and the gather form) at the given
    (name, B, h, w, C, R) shapes, on ROIs inside, partly and wholly outside
    the map, and of zero size."""
    import torch

    from fgn_torch.ops.roi_align import roi_align
    from fgn_torch.ops.roi_align_cuda import _roi_align_plain, roi_align_cuda

    gen = torch.Generator().manual_seed(1)
    with strict_f32():  # TF32 would be the plain version's largest error
        for name, B, h, w, C, R in shapes:
            fmap32 = torch.rand((B, h, w, C), generator=gen).to(dev)
            rois = random_rois(gen, B, R, 16 * max(h, w), dev)
            kw = dict(out_size=7, spatial_scale=1.0 / 16)
            # f32, TF32 off: the order of summation is the only difference
            got = roi_align_cuda(fmap32, rois, **kw)
            ref = _roi_align_plain(fmap32, rois, **kw)
            gat = roi_align(fmap32, rois, 7, spatial_scale=1.0 / 16)
            scale = float(ref.abs().max().clamp(min=1e-30))
            e32 = float((got - ref).abs().max())
            eg = float((got - gat).abs().max())
            check(e32 <= 1e-5 * scale, f"K1 f32 {name}: {e32} > 1e-5 * {scale}")
            check(eg <= 1e-5 * scale, f"K1 vs gather {name}: {eg}")
            # bf16 in and out: one rounding of an f32 sum, <= 2 bf16 ulp
            fmap = fmap32.to(torch.bfloat16)
            got16 = roi_align_cuda(fmap, rois, **kw)
            ref16 = _roi_align_plain(fmap.float(), rois, **kw)
            check(got16.dtype == torch.bfloat16, "K1 bf16 out dtype")
            e16 = float((got16.float() - ref16).abs().max())
            bound16 = 2 * 2.0 ** -8 * float(ref16.abs().max())
            check(e16 <= bound16, f"K1 bf16 {name}: {e16} > 2 ulp {bound16}")
            print(f"K1 roi_align {name} B={B} map={h}x{w}x{C} R={R}: f32 err "
                  f"{e32:.3g} (vs gather {eg:.3g}, scale {scale:.3g}); bf16 err "
                  f"{e16:.3g} <= {bound16:.3g}", flush=True)


def rpn_like_boxes(gen, B, M, extent):
    import torch

    ctr = torch.rand((B, M, 2), generator=gen) * extent
    wh = torch.rand((B, M, 2), generator=gen) * (extent * 0.4) + 4
    return torch.cat([ctr - wh / 2, ctr + wh / 2], dim=-1)


def phase_nms(dev, B=8, M=4096):
    """K2 against its plain version: exact keep masks and NMS outputs."""
    import torch

    from fgn_torch.ops.nms import _greedy_alive, batched_nms, nms_padded
    from fgn_torch.ops.nms_cuda import greedy_alive_cuda

    gen = torch.Generator().manual_seed(2)

    def both(boxes, scores, valid, thr, max_out, cls=None):
        if cls is None:
            a = nms_padded(boxes, scores, valid, thr, max_out,
                           alive_fn=greedy_alive_cuda)
            b = nms_padded(boxes, scores, valid, thr, max_out,
                           alive_fn=_greedy_alive)
        else:
            a = batched_nms(boxes, scores, cls, valid, thr, max_out,
                            alive_fn=greedy_alive_cuda)
            b = batched_nms(boxes, scores, cls, valid, thr, max_out,
                            alive_fn=_greedy_alive)
        for x, y in zip(a, b):
            check(torch.equal(x, y), f"K2 nms outputs differ (thr {thr})")
        return a

    cases = 0
    for m, thr in ((M, 0.7), (M, 0.5), (1024, 0.3), (1024, 0.9),
                   (900, 0.5), (513, 0.7)):
        boxes = rpn_like_boxes(gen, B, m, 480.0).to(dev)
        scores = torch.rand((B, m), generator=gen).to(dev)
        valid = (torch.rand((B, m), generator=gen) > 0.05).to(dev)
        both(boxes, scores, valid, thr, 300)
        cases += 1
    # per-class detections: M = P * N = 900 → Mp = 1024, class offset 1e4
    boxes = rpn_like_boxes(gen, B, 900, 480.0).to(dev)
    scores = torch.rand((B, 900), generator=gen).to(dev)
    cls = torch.randint(0, 3, (B, 900), generator=gen,
                        dtype=torch.int32).to(dev)
    valid = (scores > 0.05)
    out = both(boxes, scores, valid, 0.5, 100, cls)
    check(bool(out[4].any()), "K2 class-offset case kept nothing")
    cases += 1
    # degenerate: all invalid, identical boxes
    same = torch.tensor([10.0, 10.0, 50.0, 50.0]).expand(B, 256, 4).to(dev)
    lin = torch.linspace(1, 0, 256).expand(B, 256).contiguous().to(dev)
    none = both(same, lin, torch.zeros((B, 256), dtype=torch.bool, device=dev),
                0.5, 16)
    check(not bool(none[3].any()), "K2 all-invalid kept a box")
    one = both(same, lin, torch.ones((B, 256), dtype=torch.bool, device=dev),
               0.5, 16)
    check(bool((one[3].sum(1) == 1).all()), "K2 identical boxes: one survivor")
    cases += 2

    # keep-mask level at the RPN shape
    boxes = rpn_like_boxes(gen, B, M, 480.0).to(dev)
    alive = (torch.rand((B, M), generator=gen) > 0.05).to(dev)
    keep = greedy_alive_cuda(boxes, alive, 0.7)
    check(torch.equal(keep, _greedy_alive(boxes, alive, 0.7)),
          "K2 keep mask differs at the RPN shape")
    print(f"K2 nms: {cases} cases exact; keep mask (B={B}, Mp={M}, IoU 0.7) "
          f"exact", flush=True)


def flagship_cfg(**kw):
    from fgn_torch.config import FGNConfig

    base = dict(n_ways=3, k_shots=3, backbone_norm="gn",
                backbone_frozen=False, compute_dtype="bfloat16")
    base.update(kw)
    return FGNConfig(**base)


def counted_forward(model, batch):
    """One test_forward with the launch counters set to 0 just before and
    read just after. → (outputs, {kernel: launches})."""
    import torch

    from fgn_torch.ops.nms_cuda import greedy_alive_cuda
    from fgn_torch.ops.roi_align_cuda import roi_align_cuda

    torch.cuda.synchronize()
    roi_align_cuda.launches = 0
    greedy_alive_cuda.launches = 0
    out = model.test_forward(batch)
    torch.cuda.synchronize()
    return out, {"roi_align": roi_align_cuda.launches,
                 "nms_keep": greedy_alive_cuda.launches}


def check_outputs(out, cfg, B, tag):
    import torch

    P, M = cfg.rpn_test_max_per_img, cfg.rcnn_max_per_img
    want = {
        "proposals": (B, P, 4), "prop_scores": (B, P), "prop_valid": (B, P),
        "dt_boxes": (B, M, 4), "dt_scores": (B, M), "dt_cats": (B, M),
        "dt_valid": (B, M),
        "dt_mask_logits": (B, M, cfg.mask_size, cfg.mask_size),
    }
    for k, shape in want.items():
        check(tuple(out[k].shape) == shape, f"{tag} {k} shape {tuple(out[k].shape)}")
        if out[k].is_floating_point():
            check(bool(torch.isfinite(out[k]).all()), f"{tag} {k} not finite")
    check(bool(out["prop_valid"].any()), f"{tag}: no proposals")
    check(bool(out["dt_valid"].any()), f"{tag}: no detections")


def capture_kernel_calls(model, batch):
    """The arguments of every kernel call of one forward, in order:
    [(kernel name, args, kwargs)]. The kernels run as usual."""
    import fgn_torch.models.fgn as fgn_mod

    calls = []

    def recorder(name, fn):
        def wrapped(*a, **k):
            calls.append((name, a, k))
            return fn(*a, **k)
        return wrapped

    with mock.patch.object(fgn_mod, "roi_align_cuda",
                           recorder("roi_align", fgn_mod.roi_align_cuda)), \
            mock.patch.object(fgn_mod, "greedy_alive_cuda",
                              recorder("nms_keep", fgn_mod.greedy_alive_cuda)):
        model.test_forward(batch)
    return calls


def phase_main_path(dev, gpu, B=8, H=480, W=480, S=128, iters=10,
                    tag="flagship", **cfg_kw):
    """FGN.test_forward through the kernels: launches counted, outputs
    checked, time per forward (CUDA events) and the kernels' calls."""
    from fgn_torch.data.batching import to_device, toy_batch
    from fgn_torch.models.fgn import build_model

    cfg = flagship_cfg(**cfg_kw)
    model = build_model(cfg, dev, seed=0)
    batch = to_device(toy_batch(B=B, H=H, W=W, N=3, K=3, S=S), dev)
    model.test_forward(batch)  # warm-up: cuDNN plans, kernel load
    out, counts = counted_forward(model, batch)
    print(f"main path {tag}: launches {counts}", flush=True)
    check(counts == {"roi_align": 3, "nms_keep": 2},
          f"{tag}: want K1 x3 and K2 x2 per forward, got {counts}")
    check_outputs(out, cfg, B, tag)
    times = sorted(cuda_ms(lambda: model.test_forward(batch), 1, warmup=0)
                   for _ in range(iters))
    ms = statistics.median(times)
    q1, q3 = times[len(times) // 4], times[(3 * len(times)) // 4]
    n_valid = int(out["dt_valid"].sum())
    print(f"main path {tag}: test_forward b{B} {H}x{W} N3K3 S{S} bf16 "
          f"median {ms:.3f} ms (quartiles {q1:.3f}-{q3:.3f}, n={iters}; "
          f"{B / ms * 1e3:.2f} imgs/s), {n_valid} detections, on {gpu}",
          flush=True)
    return counts, model, batch, capture_kernel_calls(model, batch)


def kernel_records(calls, iters=20):
    """Each kernel on the inputs the main path gave it: held against its
    plain version, timed beside its plain version and its bound. Returns
    {kernel: record of its largest call}."""
    import torch

    from fgn_torch.ops.nms import _greedy_alive
    from fgn_torch.ops.nms_cuda import greedy_alive_cuda
    from fgn_torch.ops.roi_align_cuda import _roi_align_plain, roi_align_cuda

    recs = {}
    for i, (name, a, k) in enumerate(calls):
        if name == "roi_align":
            fmap, rois = a[0], a[1]
            got = roi_align_cuda(*a, **k)
            with strict_f32():
                ref = _roi_align_plain(fmap.float(), *a[1:], **k)
            err = float((got.float() - ref).abs().max())
            bound = 2 * 2.0 ** -8 * float(ref.abs().max())
            check(err <= bound, f"K1 main-path call {i}: {err} > 2 ulp {bound}")
            ms = cuda_ms(lambda: roi_align_cuda(*a, **k), iters)
            plain_ms = cuda_ms(lambda: _roi_align_plain(*a, **k), 3, warmup=1)
            nbytes = (fmap.numel() * fmap.element_size() + rois.numel() * 4
                      + got.numel() * got.element_size())
            ops = 2 * 16 * got.numel()
            size = got.numel()
            desc = (f"map {tuple(fmap.shape)} {str(fmap.dtype)[6:]}, "
                    f"rois {tuple(rois.shape)}")
        else:
            boxes, alive, thr = a[0], a[1], a[2]
            got = greedy_alive_cuda(*a, **k)
            ref = _greedy_alive(*a, **k)
            check(torch.equal(got, ref), f"K2 main-path call {i} differs")
            err = 0.0
            ms = cuda_ms(lambda: greedy_alive_cuda(*a, **k), iters)
            plain_ms = cuda_ms(lambda: _greedy_alive(*a, **k), 3, warmup=1)
            B, Mp = alive.shape
            # Least work these inputs need, per image with A alive and K
            # kept: every pair of kept boxes (each must be shown not to
            # suppress the other), and one IoU above the threshold for
            # each suppressed box.
            n_keep = got.sum(1).double()
            n_alive = alive.sum(1).double()
            pairs = float((n_keep * (n_keep - 1) / 2 + n_alive - n_keep).sum())
            nbytes = B * Mp * (16 + 1 + 1)
            ops = IOU_FLOPS * pairs
            size = B * Mp
            desc = (f"boxes {tuple(boxes.shape)}, IoU {thr}, "
                    f"{int(alive.sum())} alive, {int(got.sum())} kept")
        t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / F32_FLOPS_S
        bound_ms = max(t_bytes, t_ops) * 1e3
        print(f"{name} main-path call {i}: {desc}: err {err:.3g}; kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms "
              f"({'bytes' if t_bytes >= t_ops else 'operations'})", flush=True)
        rec = dict(
            name=name, route="cuda",
            source=f"fgn_torch/csrc/{'roi_align' if name == 'roi_align' else 'nms'}.cu",
            replaces=("roi_align_pallas.py:264" if name == "roi_align"
                      else "nms_pallas.py:157"),
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None, _size=size,
        )
        if name not in recs or size > recs[name]["_size"]:
            recs[name] = rec
    for rec in recs.values():
        rec.pop("_size")
    return recs


STAGES = ("_extract", "_rpn_forward", "get_proposals", "_count_spp",
          "_bbox_feats", "_relation_impl", "_mask_head_impl")


def phase_breakdown(model, batch, top=12):
    """Where one forward's device time goes (``--profile`` only):
    torch.profiler over a forward whose stages (FGN methods, and the
    detection NMS) are wrapped in record_function spans from this script;
    the program is unchanged."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    import fgn_torch.models.fgn as fgn_mod

    def span(name, fn):
        def wrapped(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return wrapped

    patches = [mock.patch.object(model, s, span(s, getattr(model, s)))
               for s in STAGES]
    patches.append(mock.patch.object(
        fgn_mod, "batched_nms", span("batched_nms", fgn_mod.batched_nms)))
    for p in patches:
        p.start()
    try:
        model.test_forward(batch)  # warm the wrapped path
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.test_forward(batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        for p in patches:
            p.stop()
    events = prof.key_averages()
    names = set(STAGES) | {"batched_nms"}

    def on_card(e):
        return e.device_type.name == "CUDA"

    busy = sum(e.self_device_time_total for e in events
               if on_card(e) and not e.is_user_annotation) / 1e3
    print(f"profile: one forward, wall {wall:.3f} ms with the profiler on; "
          f"kernels busy {busy:.3f} ms ({100 * busy / wall:.1f} %), idle "
          f"{max(wall - busy, 0.0):.3f} ms", flush=True)
    for e in events:
        if e.key in names and on_card(e):
            print(f"  stage {e.key}: {e.device_time_total / 1e3:.3f} ms on the "
                  f"card, {e.count} calls", flush=True)
    ops = sorted((e for e in events
                  if not on_card(e) and e.key not in names
                  and e.self_device_time_total > 0),
                 key=lambda e: e.self_device_time_total, reverse=True)[:top]
    for e in ops:
        print(f"  op {e.key[:60]}: {e.self_device_time_total / 1e3:.3f} ms, "
              f"{e.count} calls", flush=True)


def match_detections(a, b, tol_box, tol_score, tol_mask):
    """Valid detections of a and b agree slot for slot, except that slots
    whose scores tie within tol_score may trade places."""
    import torch

    for i in range(a["dt_valid"].shape[0]):
        va, vb = a["dt_valid"][i], b["dt_valid"][i]
        check(torch.equal(va, vb), f"image {i}: dt_valid differs")
        free = set(int(j) for j in torch.nonzero(vb).flatten())
        for j in torch.nonzero(va).flatten().tolist():
            hit = None
            for k in sorted(free, key=lambda k: abs(k - j)):
                if (int(a["dt_cats"][i, j]) == int(b["dt_cats"][i, k])
                        and abs(float(a["dt_scores"][i, j] - b["dt_scores"][i, k]))
                        <= tol_score
                        and float((a["dt_boxes"][i, j] - b["dt_boxes"][i, k])
                                  .abs().max()) <= tol_box
                        and float((a["dt_mask_logits"][i, j]
                                   - b["dt_mask_logits"][i, k]).abs().max())
                        <= tol_mask):
                    hit = k
                    break
            check(hit is not None, f"image {i} slot {j}: no matching detection")
            free.discard(hit)


def phase_plain_twin(dev):
    """The main path at f32 (TF32 off) through the kernels against the
    same forward through the plain versions, same weights, b2."""
    import torch

    import fgn_torch.models.fgn as fgn_mod
    from fgn_torch.data.batching import to_device, toy_batch
    from fgn_torch.ops.nms import _greedy_alive
    from fgn_torch.ops.roi_align_cuda import _roi_align_plain

    cfg = flagship_cfg(compute_dtype="float32")
    model = fgn_mod.build_model(cfg, dev, seed=0)
    batch = to_device(toy_batch(B=2, H=480, W=480, N=3, K=3, S=128), dev)
    with strict_f32():
        out_k, counts = counted_forward(model, batch)
        with mock.patch.object(fgn_mod, "roi_align_cuda", _roi_align_plain), \
                mock.patch.object(fgn_mod, "greedy_alive_cuda", _greedy_alive):
            out_p = model.test_forward(batch)
    check(counts == {"roi_align": 3, "nms_keep": 2}, f"f32 twin counts {counts}")
    for k in ("proposals", "prop_scores", "prop_valid"):
        check(torch.equal(out_k[k], out_p[k]), f"f32 twin: {k} not identical")
    # The kernel sums RoIAlign's 16 products per bin in another order than
    # the plain contraction (<= 1e-6 relative); that difference passes
    # through res5 (9 convs, GN) and the relation head before the scores,
    # and through the delta decode (x 480 px) before the boxes.
    mask_scale = float(out_p["dt_mask_logits"].abs().max())
    match_detections(out_k, out_p, tol_box=1e-2, tol_score=1e-4,
                     tol_mask=1e-3 * max(mask_scale, 1.0))
    n = int(out_k["dt_valid"].sum())
    print(f"plain twin f32 b2: proposals identical, {n} detections match "
          f"(boxes 1e-2 px, scores 1e-4, mask logits 1e-3 x {mask_scale:.3g})",
          flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one flagship forward by stage and op")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import fgn_torch  # noqa: F401
        from fgn_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the fgn_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")

    gpu = gpu_line()
    print(f"gpu: {gpu}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    t0 = time.perf_counter()
    libs = _build.load_all()
    secs = time.perf_counter() - t0
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
    print(f"build: {sorted(libs)} loaded in {secs:.1f} s, compiled "
          f"{sorted(_build.build_logs)} (one nvcc each, in parallel)",
          flush=True)

    t0 = time.perf_counter()
    phase_roi_align(dev, [
        ("support", 72, 8, 8, 1024, 1),
        ("proposals", 8, 30, 30, 1024, 300),
        ("detections", 8, 30, 30, 1024, 100),
    ])
    phase_nms(dev)
    counts, model, batch, calls = phase_main_path(dev, gpu)
    recs = kernel_records(calls)
    for name, rec in recs.items():
        rec["launches"] = counts[name]
    if args.profile:
        phase_breakdown(model, batch)
    del model, batch, calls
    torch.cuda.empty_cache()
    phase_plain_twin(dev)
    torch.cuda.empty_cache()
    phase_main_path(dev, gpu, B=4, H=800, W=1088, S=256, iters=5,
                    tag="coco2voc", rpn_test_nms_pre=6144)
    print(f"phases: {time.perf_counter() - t0:.1f} s", flush=True)

    kernels = []
    for rec in (recs["roi_align"], recs["nms_keep"]):
        kernels.append({k: rec[k] for k in (
            "name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    print(gpu_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
