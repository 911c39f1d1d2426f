#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA GPU.

    python3 chip_smoke.py

Builds fgn_torch's CUDA kernels from ``fgn_torch/csrc`` with nvcc (sm_90a)
and holds each against its plain PyTorch version: RoIAlign forward (K1,
its staged kernel and, for maps too large to stage, its direct kernel)
and backward (K1-bwd, its staged kernel and, for maps whose accumulator
does not fit, its atomics kernel), and the greedy-NMS keep mask (K2), on
edge cases and at the shapes of the main paths; K1's staged kernel is
timed beside the direct one, K1-bwd's beside the atomics one, and K2's
walk beside its plain version and its bound, at every main-path call.
GroupNorm with its epilogue (K3) is held against its plain version at
every GroupNorm call of the OMNIISEG b8 forward
(``benchmark/configs/omniiseg-n3k3-480.json``: both routes, every
epilogue) and at f32 twins, timed beside its byte bound, the plain version
and the library's ``F.group_norm``, and its launches counted a forward
(b8, b1, COCO2VOC b4: one a GroupNorm call) and a train step (one forward
and one backward launch a call, no call of the composition). Its gradient
(K3-bwd) is held against the composition's at every GroupNorm call of a b8
train step of that model, at f32 twins and with a frozen input or frozen
weights, two calls bit for bit, and timed, forward and backward, beside
their byte bound, the composition and ``F.group_norm`` under autograd.
The ViT's attention (K4) is held against
its plain version in f32 at the ViT cell's shapes (the queries' global
blocks and windows, the supports' global blocks and windows) and at two
more grids, timed, its largest call beside its FLOP bound, the plain
version and the library's SDPA over the bias in memory, and counted a ViT
cell request (one launch an ``attend``, no bias in memory, no SDPA call).
The optimizer's multi-tensor update (K5) is held bit for bit against the
optimizer's plain route over the OMNIISEG cell's 189 tensors (Adagrad and
Adam, three steps, one gradient missing) in the training phase, and timed
beside its byte bound and the plain route. Then it drives the three paths
through the kernels with launch counters:

  * episodic inference, ``FGN.test_forward`` (R50-C4, N3K3, 480 px, batch
    8 and batch 4, bf16, seeded random weights), compared as a whole
    against its plain-version twin in f32, and the COCO2VOC geometry
    (800x1088, 256 px supports, ``rpn_test_nms_pre=6144``, b4) at N3K3 and
    N1K1 (K1 on 4 support maps of R = 1, K2 at Mp 6144 with one way): at
    each, a forward with its launches counted and its outputs checked, and
    each kernel held against its plain version at one more forward's calls;
  * training, ``make_train_step`` (``FGN.train_forward``, backward, Adam):
    5 full-width steps at b12 bf16, every step's launches counted (K5 once,
    every tensor on it), the step split at the program's spans, each kernel
    held at one more step's calls, and an f32 training twin at b2 through
    the kernels and through the plain versions;
  * the system as a user runs it, from ``configs/fgn_train_mnistiseg_n3k3.py``
    (R50-C4, GN, deep stem, avg-down, N3K3, bf16): the episode engine held
    stage by stage to the committed reference (``data/digests.py``: OpenCV
    calls on fixed inputs, glyphs and the MNISTISEG split it generates here
    held to their structure, databags, episodes, the collated batch), then
    train steps at the config's batch 8 with its Adagrad schedule on the
    train split's episodes through ``EpisodeLoader`` (2 warm-up and 5
    timed, the same 5 batches again from host memory, 5 of a fresh epoch;
    K1 x2, K1-bwd x2, K2 x1 per step; the wait for each batch and the
    prefetch thread's episodes/s), and each kernel at one more step's calls;
  * episodic evaluation, ``Evaluator`` over every episode of the config's
    eval split at b8: three passes (stream and cache, cached, ``run_fresh``)
    timed and split, K1 x3 and K2 x2 per batch, the native RLE live, one
    render by ``visualize_result``, pass 2's metrics equal to pass 1's and
    its detections bit-identical to a synchronized loop, each kernel at the
    calls of the first batch, and an f32 eval twin over 16 frozen episodes
    through the plain versions. It prints the machine's cv2 version;
  * the run loop as a user drives it, ``python -m fgn_torch.main`` and
    ``python -m fgn_torch.main_ft`` on config files derived from the same
    config and ``configs/fgn_ft_mnistiseg.py`` over the generated split:
    a run killed by its RSS limit (exit 42) at its first check, its resume
    in this process (counted: K1 x2, K1-bwd x2, K2 x1 a step, K1 x3, K2 x2
    an eval batch) to the end of its second epoch with metrics at every
    check, and the finetune grid's cell from its last checkpoint, run
    twice (the second skips the completed cell);
  * the COCO2VOC family (``phase_cocovoc``): ``python -m
    fgn_torch.tools.make_synthetic_cocovoc`` writes the COCO/VOC-format
    stand-in here, held to its structure; stage 1 from
    ``configs/fgn_train_coco2voc_synth.py`` (800 px, b8 Adam, one epoch and
    its check) and the finetune cell from ``configs/fgn_ft_coco2voc_synth.py``
    (b4, the FT=Use evaluator over VOC novel) in this process, counted (K2's
    unstaged walk once a step: ``rpn_train_nms_pre`` 12288), each kernel held
    at one more step's calls and K2's unstaged walk timed beside the staged
    walk; a ``frozen_bn`` checkpoint exported by ``python -m
    fgn_torch.tools.export_pretrained_pth`` and loaded by 2 steps of
    ``configs/fgn_train_coco2voc.py``; ``diagnose_detector`` and
    ``eval_cat_shuffle`` on stage 1's checkpoint;
  * data parallelism on the one card (``phase_dp``; ranks are processes):
    2 ranks over gloo check each collective on CUDA tensors, train the
    flagship at a global b12 (b6 a rank) with their launches counted (K1
    x2, K1-bwd x2, K2 x1 a step) and rank 0's kernel calls held against
    the plain versions, and run an f32 twin against 1 rank at b4 within the
    JAX package's data-parallel tolerances; 1 rank over NCCL steps bit for
    bit as the step without a mesh; ``python -m fgn_torch.parallel.dryrun
    --ranks 2 --backend gloo``; ``torchrun --nproc_per_node 2 -m
    fgn_torch.main`` trains the generated split for an epoch, and its
    checkpoint scored by 2 ranks gives the metrics and pickles of 1 rank.

``--phases a,b`` runs only the phases named (``PHASES``; eval, runner and
dp bring the engine phase along); the default, and the full check, is all.

It times no end-to-end rate: the benchmark (``benchmark/run.py``) does.

With ``--profile`` it also prints where the device time of one flagship
forward and of one train step goes (torch.profiler), K3's routes at other
block sizes, tiles and apply blocks, K1's staged kernel
at other channel tiles and ROI groups than its rules pick, K1-bwd's staged
kernel at other channel tiles and block sizes, and K2's walk at every
cluster size.

Prints its measurements on earlier lines and each phase's wall time on a
``phase <name>: <s> s`` line; the line before the last is one JSON object
of the kernels, each with every number from one path (its ``path``: K1
and K2 from evaluation, K1-bwd from the engine's training, K3 from its
phase: its largest call, and a b8 forward's sums;
``launches_main_paths``: a forward's launches at each serving geometry of
the main path and COCO2VOC serving phases and a train step's in the train
phase, K3's a forward's at b8, b1 and COCO2VOC b4 and a train step's;
``launches_dp``: each rank's launches in ``phase_dp``'s flagship run;
``launches_coco2voc``: each run's launches in ``phase_cocovoc``, K2's
unstaged walk also apart, and K2's ``coco2voc_unstaged`` record);
the last line is
``{"ok": true, "device": {...}}``. Any failed check raises and the script
exits non-zero. Without a CUDA device, or without the fgn_torch package
beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and the f32 rate
# outside the tensor cores, at the full 700 W power limit.
HBM_BYTES_S = 3.35e12
F32_FLOPS_S = 67e12
# A kernel's least operations: a multiply-add for each of RoIAlign's 16
# corner weights an output element (K1) or gradient element (K1-bwd); 12 f32
# operations an IoU (min, max, sub x2, mul, add, sub, max, div, compare) for
# each IoU a greedy walk needs (K2, ``k2_ops``).
ROI_ALIGN_FLOPS = 2 * 16
IOU_FLOPS = 12


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def gpu_line():
    """``nvidia-smi``'s name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


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


def k1_forward(fmap, rois, out_size=7, spatial_scale=1.0, sampling_ratio=2,
               aligned=True):
    """K1's forward on roi_align_cuda's arguments without its autograd
    Function: the kernel the wrapper picks."""
    from fgn_torch.ops.roi_align_cuda import _roi_align_forward

    return _roi_align_forward(fmap, rois, out_size, spatial_scale,
                              sampling_ratio, aligned)


def k1_direct(fmap, rois, out_size=7, spatial_scale=1.0, sampling_ratio=2,
              aligned=True):
    """K1's direct kernel (the design the staged kernel replaced) on the
    same arguments whatever the map, through its C entry point: to compare
    and time it beside the staged kernel, so no launch counter moves."""
    import torch

    from fgn_torch.ops import _build
    from fgn_torch.ops.roi_align_cuda import _DTYPES, _check

    S = max(int(sampling_ratio), 1)
    _check(fmap, rois, out_size, S, "k1_direct")
    B, H, W, C = fmap.shape
    R = rois.shape[1]
    out = torch.empty((B, R, out_size, out_size, C), dtype=fmap.dtype,
                      device=fmap.device)
    lib = _build.load("roi_align")
    rc = lib.fgn_roi_align_forward(
        fmap.data_ptr(), rois.data_ptr(), out.data_ptr(), B, H, W, C, R,
        out_size, S, float(spatial_scale), int(bool(aligned)),
        _DTYPES[fmap.dtype], torch.cuda.current_stream(fmap.device).cuda_stream)
    _build.check(lib, "fgn_roi_align_error_string", rc,
                 "roi_align direct kernel")
    return out


def device_ms(fn, n=10, iters=5):
    """Time on the card of one fn() call without the host time around its
    launches: the card first sleeps (~10 ms) while the host queues n calls
    between two CUDA events, which it then runs back to back. Median over
    iters, per call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def moved_by(fn, names, *a, **k):
    """fn(*a, **k) → (its result, how far it moved each launch counter of
    ``names``)."""
    from fgn_torch.utils.profiling import counts

    before = counts()
    out = fn(*a, **k)
    after = counts()
    return out, tuple(after.get(n, 0) - before.get(n, 0) for n in names)


def k1_landed(fn, *a, **k):
    """fn(*a, **k) → (its result, the K1 design whose counter it moved)."""
    out, moved = moved_by(fn, ("k1.staged", "k1.direct"), *a, **k)
    check(moved in ((1, 0), (0, 1)), f"K1 launches moved by {moved}")
    return out, "staged" if moved == (1, 0) else "direct"


def phase_roi_align(dev, shapes, **over):
    """K1 against its plain version (and the gather form) at the given
    (name, B, h, w, C, R) shapes, on ROIs inside, partly and wholly outside
    the map, and of zero size: the kernel the wrapper picks, whose launch
    must land on the counter of the kernel ``_channel_tile`` names, and the
    direct kernel. ``over`` replaces roi_align_cuda's keywords (out_size 7,
    spatial_scale 1/16)."""
    import torch

    from fgn_torch.ops.roi_align import roi_align
    from fgn_torch.ops.roi_align_cuda import (
        _channel_tile, _roi_align_plain, roi_align_cuda,
    )

    gen = torch.Generator().manual_seed(1)
    with strict_f32():  # TF32 would be the plain version's largest error
        for name, B, h, w, C, R in shapes:
            fmap32 = torch.rand((B, h, w, C), generator=gen).to(dev)
            rois = random_rois(gen, B, R, 16 * max(h, w), dev)
            kw = dict(dict(out_size=7, spatial_scale=1.0 / 16), **over)
            ref = _roi_align_plain(fmap32, rois, **kw)
            gat = roi_align(fmap32, rois, **kw)
            scale = float(ref.abs().max().clamp(min=1e-30))
            fmap = fmap32.to(torch.bfloat16)
            ref16 = _roi_align_plain(fmap.float(), rois, **kw)
            bound16 = 2 * 2.0 ** -8 * float(ref16.abs().max())
            line = []
            for picked in (True, False):
                if picked:  # the kernel the wrapper picks, by the shape rule
                    # f32, TF32 off: the order of summation is the only
                    # difference; bf16 in and out: one rounding of an f32
                    # sum, <= 2 bf16 ulp
                    got, d32 = k1_landed(roi_align_cuda, fmap32, rois, **kw)
                    got16, d16 = k1_landed(roi_align_cuda, fmap, rois, **kw)
                    for dt, d in ((torch.float32, d32), (torch.bfloat16, d16)):
                        tile = _channel_tile(h, w, C, dt, kw["out_size"],
                                             kw.get("sampling_ratio", 2))
                        want = "direct" if tile is None else "staged"
                        check(d == want, f"K1 {name} {dt}: launch landed on "
                                         f"{d}, want {want}")
                else:  # the direct kernel, whatever the map
                    got, got16 = k1_direct(fmap32, rois, **kw), k1_direct(
                        fmap, rois, **kw)
                    d32 = d16 = "direct"
                e32 = float((got - ref).abs().max())
                eg = float((got - gat).abs().max())
                check(got16.dtype == torch.bfloat16, "K1 bf16 out dtype")
                e16 = float((got16.float() - ref16).abs().max())
                tag = f"{d32}/{d16}"
                check(e32 <= 1e-5 * scale,
                      f"K1 {tag} f32 {name}: {e32} > 1e-5 * {scale}")
                check(eg <= 1e-5 * scale, f"K1 {tag} vs gather {name}: {eg}")
                check(e16 <= bound16, f"K1 {tag} bf16 {name}: {e16} > 2 ulp "
                                      f"{bound16}")
                line.append(f"{tag} (f32/bf16): f32 err {e32:.3g} (vs gather "
                            f"{eg:.3g}), bf16 err {e16:.3g}")
            ms = cuda_ms(lambda: k1_forward(fmap, rois, **kw), 20)
            print(f"K1 roi_align {name} B={B} map={h}x{w}x{C} R={R} {over}, scale "
                  f"{scale:.3g}, bf16 bound {bound16:.3g}: " + "; ".join(line)
                  + f"; picked, bf16: {ms:.4f} ms", flush=True)


def k1bwd_atomic(g, rois, H, W, out_size=7, spatial_scale=1.0,
                 sampling_ratio=2, aligned=True):
    """K1-bwd's atomics kernel (the design the staged kernel replaced) on
    roi_align_backward_cuda's arguments whatever the map: to compare and
    time it beside the staged kernel, so no launch counter moves."""
    from fgn_torch.ops.roi_align_cuda import _backward_atomic, _check

    S = max(int(sampling_ratio), 1)
    B, R, _, _, C = g.shape
    _check(g.reshape(B, R * out_size, out_size, C), rois, out_size, S,
           "k1bwd_atomic")
    return _backward_atomic(g, rois, H, W, out_size, S, spatial_scale, aligned)


def k1bwd_landed(*a, **k):
    """roi_align_backward_cuda(*a, **k) → (its result, the K1-bwd design
    whose counter it moved: "staged" or "atomic")."""
    from fgn_torch.ops.roi_align_cuda import roi_align_backward_cuda as rbc

    out, moved = moved_by(rbc, ("k1_bwd.staged", "k1_bwd.atomic"), *a, **k)
    check(moved in ((1, 0), (0, 1)), f"K1-bwd launches moved by {moved}")
    return out, "staged" if moved == (1, 0) else "atomic"


def phase_roi_align_backward(dev, shapes, twin=("ragged",), **over):
    """K1-bwd against its plain version at the given (name, B, h, w, C, R)
    shapes, on ROIs inside, partly and wholly outside the map, and of zero
    size, in f32 (within 1e-5 of the gradient's largest magnitude: the same
    sums in another order) and bf16 (2 ulp): the kernel the wrapper picks,
    whose launch must land on the counter of the kernel
    ``_bwd_channel_tile`` names, and the atomics kernel. The staged kernel
    sums every word in one fixed order, so two launches on the same inputs
    must agree bit for bit; at the shapes named in ``twin`` it is also held
    to ``_roi_align_bwd_ordered``, its order in torch. ``over`` replaces
    roi_align_backward_cuda's keywords (out_size 7, spatial_scale 1/16)."""
    import torch

    from fgn_torch.ops.roi_align_cuda import (
        _bwd_channel_tile, _roi_align_bwd_ordered, _roi_align_plain_bwd,
    )

    gen = torch.Generator().manual_seed(3)
    kw = dict(dict(out_size=7, spatial_scale=1.0 / 16), **over)
    O = kw["out_size"]
    for name, B, h, w, C, R in shapes:
        rois = random_rois(gen, B, R, 16 * max(h, w), dev)
        g32 = torch.randn((B, R, O, O, C), generator=gen).to(dev)
        g16 = g32.to(torch.bfloat16)
        with strict_f32():
            ref = _roi_align_plain_bwd(g32, rois, h, w, torch.float32, **kw)
            ref16 = _roi_align_plain_bwd(g16.float(), rois, h, w,
                                         torch.float32, **kw)
        scale = float(ref.abs().max().clamp(min=1e-30))
        bound16 = 2 * 2.0 ** -8 * float(ref16.abs().max())
        line = []
        for g, dt in ((g32, torch.float32), (g16, torch.bfloat16)):
            got, design = k1bwd_landed(g, rois, h, w, **kw)
            want = ("atomic" if _bwd_channel_tile(h, w, C, dt, R, O) is None
                    else "staged")
            check(design == want, f"K1-bwd {name} {dt}: launch landed on "
                                  f"{design}, want {want}")
            check(got.dtype == dt, f"K1-bwd {name}: out dtype {got.dtype}")
            if design == "staged":
                again = k1bwd_landed(g, rois, h, w, **kw)[0]
                check(torch.equal(got, again),
                      f"K1-bwd {name} {dt}: two launches differ")
            old = k1bwd_atomic(g, rois, h, w, **kw)
            for tag, out in ((design, got), ("atomic kernel", old)):
                if dt == torch.float32:
                    e = float((out - ref).abs().max())
                    check(e <= 1e-5 * scale, f"K1-bwd {tag} f32 {name}: {e} > "
                                             f"1e-5 * {scale}")
                else:
                    e = float((out.float() - ref16).abs().max())
                    check(e <= bound16, f"K1-bwd {tag} bf16 {name}: {e} > 2 "
                                        f"ulp {bound16}")
                line.append(f"{tag} {str(dt)[6:]} err {e:.3g}")
            if name in twin:
                tw = _roi_align_bwd_ordered(g, rois, h, w, dt, **kw)
                e = float((got.float() - tw.float()).abs().max())
                check(e <= 1e-6 * scale, f"K1-bwd {name} {dt}: {e} from its "
                                         f"order in torch")
                line.append(f"vs its order in torch {e:.3g} "
                            f"({int((got != tw).sum())} of {got.numel()} "
                            f"words differ)")
        print(f"K1-bwd roi_align_backward {name} B={B} map={h}x{w}x{C} R={R} "
              f"{over}, (scale {scale:.3g}, bf16 bound {bound16:.3g}): "
              + "; ".join(line), flush=True)


def rpn_like_boxes(gen, B, M, extent):
    import torch

    ctr = torch.rand((B, M, 2), generator=gen) * extent
    wh = torch.rand((B, M, 2), generator=gen) * (extent * 0.4) + 4
    return torch.cat([ctr - wh / 2, ctr + wh / 2], dim=-1)


def k2_landed(*a, **k):
    """greedy_alive_cuda(*a, **k) → (its result, the K2 design whose counter
    it moved: "staged" or "unstaged")."""
    from fgn_torch.ops.nms_cuda import greedy_alive_cuda as gac

    out, moved = moved_by(gac, ("k2.staged", "k2.unstaged"), *a, **k)
    check(moved in ((1, 0), (0, 1)), f"K2 launches moved by {moved}")
    return out, "staged" if moved == (1, 0) else "unstaged"


# Chains of three boxes, each overlapping the next at IoU 2/3 and the third
# at 3/7 (threshold 0.5): the first suppresses the second, which therefore
# does not suppress the third. Rows within each 256: inside a chunk of 32,
# into the next chunk, two and four chunks ahead.
K2_CHAINS = ((30, 31, 32), (60, 70, 100), (95, 130, 170), (200, 201, 240))


def k2_case(gen, kind, B, Mp):
    """(boxes (B, Mp, 4), alive (B, Mp)) on the CPU for K2's edge cases."""
    import torch

    i = torch.arange(Mp, dtype=torch.float32)
    alive = torch.ones((B, Mp), dtype=torch.bool)
    if kind == "random":
        boxes = rpn_like_boxes(gen, B, Mp, 480.0 * max(1, Mp // 4096))
        alive = torch.rand((B, Mp), generator=gen) > 0.05
    elif kind in ("chains", "disjoint"):  # far apart but for the chains
        x, y = (i % 64) * 100, (i // 64) * 100
        boxes = torch.stack([x, y, x + 10, y + 10], -1).repeat(B, 1, 1)
        for blk in range(0, Mp if kind == "chains" else 0, 256):
            for trip in K2_CHAINS:
                base = boxes[:, blk + trip[0]].clone()
                for k, r in enumerate(trip):
                    boxes[:, blk + r] = base + torch.tensor(
                        [2.0 * k, 0.0, 2.0 * k, 0.0])
    elif kind == "exact":  # pairs at IoU exactly 1/2 (1/4 every other)
        x = (i // 2) * 10
        boxes = torch.stack([x, 0 * x, x + 2, 0 * x + 1], -1)
        boxes[1::2, 2] = x[1::2] + 1
        boxes[1::4, 2] = x[1::4] + 0.5
        boxes = boxes.repeat(B, 1, 1)
    else:  # "zero_area": zero widths, zero heights, points
        boxes = rpn_like_boxes(gen, B, Mp, 100.0)
        boxes[:, ::3, 2] = boxes[:, ::3, 0]
        boxes[:, 1::5, 3] = boxes[:, 1::5, 1]
        boxes[:, 7::9] = 5.0
        alive = torch.rand((B, Mp), generator=gen) > 0.1
    return boxes.contiguous(), alive


def phase_nms(dev, B=8, M=4096):
    """K2 against its plain version: exact keep masks and NMS outputs; each
    launch must land on the counter of the design ``_staged`` names."""
    import torch

    from fgn_torch.ops.nms import _greedy_alive, batched_nms, nms_padded
    from fgn_torch.ops.nms_cuda import _staged, greedy_alive_cuda

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

    # keep-mask level: the RPN shapes, the smallest Mp, chains across
    # chunks, K = A, IoU exactly at the threshold, zero areas, and an Mp past
    # shared memory (the unstaged design)
    masks = []
    for kind, b, mp, thr in (
            ("random", B, M, 0.7), ("random", 4, 6144, 0.7),
            ("random", B, 128, 0.7), ("random", B, 1024, 0.0),
            ("chains", 4, 6144, 0.5), ("chains", B, 256, 0.5),
            ("disjoint", 4, 6144, 0.7), ("disjoint", B, 1024, 0.5),
            ("exact", 4, 1024, 0.5), ("exact", 4, 1024, 0.25),
            ("zero_area", 4, 2048, 0.0), ("zero_area", 4, 2048, 0.5),
            ("random", 2, 16384, 0.7)):
        boxes, alive = (t.to(dev) for t in k2_case(gen, kind, b, mp))
        keep, design = k2_landed(boxes, alive, thr)
        want = "staged" if _staged(mp) else "unstaged"
        check(design == want, f"K2 {kind} Mp={mp}: launch landed on {design}, "
                              f"want {want}")
        ref = _greedy_alive(boxes, alive, thr)
        check(torch.equal(keep, ref), f"K2 keep mask differs: {kind} B={b} "
                                      f"Mp={mp} IoU {thr}")
        if kind == "chains":  # the middle box of each chain, and only it
            check(int((alive & ~keep).sum()) == b * len(K2_CHAINS) * mp // 256,
                  f"K2 chains Mp={mp}: {int((alive & ~keep).sum())} dropped")
        if kind == "disjoint":
            check(torch.equal(keep, alive), f"K2 K = A Mp={mp}: boxes dropped")
        masks.append(f"{kind} {b}x{mp} IoU {thr} {design} "
                     f"{int(keep.sum())}/{int(alive.sum())} kept")
    print(f"K2 nms: {cases} NMS cases exact; keep masks exact: "
          + "; ".join(masks), flush=True)


# K3: GroupNorm with its epilogue (csrc/group_norm.cu) ---------------------

GN_COUNTERS = ("gn.onepass", "gn.split", "gn.train", "gn.bwd.onepass",
               "gn.bwd.split")
GN_EPS = 1e-5


def bench_cfg(name, **kw):
    """The model of ``benchmark/configs/<name>.json`` as an FGNConfig."""
    from pathlib import Path

    from fgn_torch.config import FGNConfig

    path = Path(__file__).resolve().parent / "benchmark" / "configs"
    with open(path / f"{name}.json") as f:
        model = json.load(f)["model"]
    return FGNConfig(**{**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in model.items()}, **kw})


def gn_counts():
    from fgn_torch.utils.profiling import counts

    now = counts()
    return {k: now.get(k, 0) for k in GN_COUNTERS}


def capture_gn_calls(run, grads=False):
    """The GroupNorm calls of ``run()`` in order, each ((N, C, H, W), dtype,
    groups, with a residual, with a ReLU) and with ``grads`` whether x,
    weight and the residual require grad, run through the plain version
    (no K3 launch)."""
    import fgn_torch.models.resnet as resnet
    from fgn_torch.ops.group_norm_cuda import group_norm_plain

    calls = []

    def rec(x, G, w, b, eps, dtype, residual=None, relu=False):
        call = (tuple(x.shape), x.dtype, G, residual is not None, bool(relu))
        if grads:
            call += ((x.requires_grad, w.requires_grad,
                      residual is not None and residual.requires_grad),)
        calls.append(call)
        return group_norm_plain(x, G, w, b, eps, dtype, residual, relu)

    with mock.patch.object(resnet, "group_norm", rec):
        run()
    return calls


def k3_inputs(gen, shape, dtype, with_res, dev):
    """A channels_last x like a convolution's output (each channel its own
    scale and offset), a residual, and GroupNorm's weight and bias."""
    import torch

    N, C, H, W = shape
    scale = 0.5 + 1.5 * torch.rand(C, generator=gen)
    shift = torch.randn(C, generator=gen)
    x = (torch.randn((N, H, W, C), generator=gen) * scale + shift).to(dtype)
    res = (torch.randn((N, H, W, C), generator=gen).to(dtype)
           if with_res else None)
    w = 1 + 0.3 * torch.randn(C, generator=gen)
    b = 0.2 * torch.randn(C, generator=gen)

    def cl(t):  # NCHW view of NHWC memory, on the card
        return None if t is None else t.to(dev).permute(0, 3, 1, 2)

    return cl(x), cl(res), w.to(dev), b.to(dev)


def k3_hold(tag, got, want, y, dtype):
    """K3's output against the plain version's on the same inputs. y is the
    f32 GroupNorm before any rounding. The kernel sums in another order
    than the library, so its mean and rstd differ in the last f32 bits: in
    bf16 an element whose f32 value lies that close to a rounding boundary
    rounds the other way, one bf16 ulp of the GroupNorm value, and with a
    residual one more of the sum's; so each element is held within
    2^-7 (|y| + |out|) (+ 1e-5 of the largest |y|, for values near 0), and
    at most 1e-3 of the elements may differ at all. In f32 every element may
    differ, within 1e-5 (|y| + |out|) + 1e-6 max|y|. → (max abs error,
    share of elements that differ)."""
    import torch

    gf, wf, ya = got.float(), want.float(), y.abs()
    d = (gf - wf).abs()
    ymax = float(ya.max())
    if dtype == torch.bfloat16:
        tol = 2.0 ** -7 * (ya + wf.abs()) + 1e-5 * ymax
    else:
        tol = 1e-5 * (ya + wf.abs()) + 1e-6 * ymax
    share = float((got != want).float().mean())
    bad = int((d > tol).sum())
    check(bad == 0, f"K3 {tag}: {bad} elements beyond the tolerance (max "
                    f"abs error {float(d.max()):.3g})")
    if dtype == torch.bfloat16:
        check(share <= 1e-3, f"K3 {tag}: {share:.2e} of the elements differ")
    return float(d.max()), share


def k3_record(gen, call, dev, timed=True):
    """K3 at one call's shape, dtype and epilogue: the route it lands on,
    two launches bit for bit, held against the plain version
    (``k3_hold``), and timed on the card alone (``device_ms``: the input
    stays in L2 between launches where it fits, as the convolution that
    wrote it leaves it) beside the plain version (the composition the model
    ran before K3), the library's ``F.group_norm`` alone on x and the byte
    bound (x and the residual read once, out written once, 3.35 TB/s).
    → its record."""
    import torch
    import torch.nn.functional as F

    from fgn_torch.ops.group_norm_cuda import (
        _plan, _sm_count, group_norm, group_norm_plain,
    )

    shape, dtype, G, with_res, relu = call
    N, C, H, W = shape
    x, res, w, b = k3_inputs(gen, shape, dtype, with_res, dev)
    plan = _plan(N, H * W, C, G, x.element_size(), _sm_count(dev.index or 0))
    with torch.no_grad():
        def kern():
            return group_norm(x, G, w, b, GN_EPS, dtype, res, relu)

        got, moved = moved_by(kern, GN_COUNTERS)
        want_moved = tuple(int(k == "gn." + plan.route) for k in GN_COUNTERS)
        check(moved == want_moved, f"K3 {shape} moved {moved}, want the "
                                   f"{plan.route} route")
        check(got.is_contiguous(memory_format=torch.channels_last)
              and got.stride() == x.stride(), f"K3 {shape}: out's strides")
        again = kern()
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"K3 {shape}: two launches differ")
        want = group_norm_plain(x, G, w, b, GN_EPS, dtype, res, relu)
        y = F.group_norm(x.float(), G, w, b, GN_EPS)
        tag = (f"{tuple(shape)} {str(dtype)[6:]} "
               f"{'res+' if with_res else ''}{'relu' if relu else 'none'}")
        err, share = k3_hold(tag, got, want, y, dtype)
        del again, want, y
        rec = dict(shape=tuple(shape), dtype=str(dtype)[6:], residual=with_res,
                   relu=relu, route=plan.route, max_abs_err=err,
                   differ=share)
        if timed:
            wl, bl = w.to(dtype), b.to(dtype)
            rec["ms"] = device_ms(kern)
            rec["plain_ms"] = device_ms(
                lambda: group_norm_plain(x, G, w, b, GN_EPS, dtype, res, relu))
            rec["library_ms"] = device_ms(
                lambda: F.group_norm(x, G, wl, bl, GN_EPS))
            nbytes = x.numel() * x.element_size() * (3 if with_res else 2)
            rec["bound_ms"] = (nbytes + 2 * C * 4) / HBM_BYTES_S * 1e3
            print(f"K3 {tag}: {plan.route}, err {err:.3g} ({share:.1e} of the "
                  f"elements differ); kernel {rec['ms']:.4f} ms, bound "
                  f"{rec['bound_ms']:.4f} ms (bytes; "
                  f"{100 * rec['bound_ms'] / rec['ms']:.1f} % of it), plain "
                  f"{rec['plain_ms']:.4f} ms, library F.group_norm "
                  f"{rec['library_ms']:.4f} ms", flush=True)
        else:
            print(f"K3 {tag}: {plan.route}, err {err:.3g} ({share:.1e} of the "
                  f"elements differ)", flush=True)
    return rec


def k3_forward_counts(tag, cfg, B, H, W, S, dev):
    """K3's launches in one ``test_forward`` (counters set to 0 just before,
    read just after), each GroupNorm call of the forward one launch on the
    route ``_plan`` gives it. → (launches, the forward's GroupNorm calls)."""
    import torch

    from fgn_torch.data.batching import to_device, toy_batch
    from fgn_torch.models.fgn import build_model
    from fgn_torch.ops.group_norm_cuda import _plan, _sm_count

    model = build_model(cfg, dev, seed=0)
    batch = to_device(toy_batch(B=B, H=H, W=W, N=cfg.n_ways, K=cfg.k_shots,
                                S=S), dev)
    model.test_forward(batch)
    torch.cuda.synchronize()
    zero_counts()
    model.test_forward(batch)
    torch.cuda.synchronize()
    got = gn_counts()
    calls = capture_gn_calls(lambda: model.test_forward(batch))
    sms = _sm_count(dev.index or 0)
    want = {k: 0 for k in GN_COUNTERS}
    for (N, C, h, w), dt, G, _, _ in calls:
        want["gn." + _plan(N, h * w, C, G, 2 if dt != torch.float32 else 4,
                           sms).route] += 1
    check(got == want, f"K3 {tag}: launches {got}, want {want} "
                       f"({len(calls)} GroupNorm calls)")
    print(f"K3 {tag} b{B} {H}x{W}: {len(calls)} GroupNorm calls a forward, "
          f"K3 launches {got}", flush=True)
    del model, batch
    torch.cuda.empty_cache()
    return got, calls


def k3_sweep(calls, gen, dev):
    """``--profile``: K3's device ms over a forward's calls of each route,
    the split route at other block sizes, statistics tiles and apply blocks
    an SM than ``_plan`` picks, the onepass route at both block sizes."""
    import collections

    import torch

    from fgn_torch.ops.group_norm_cuda import (
        _SMEM_MAX, Plan, _launch, _plan, _sm_count, _stats_smem,
    )

    sms = _sm_count(dev.index or 0)
    uniq = collections.Counter(calls)
    inputs = {c: k3_inputs(gen, c[0], c[1], c[3], dev) for c in uniq}

    def total(route, plan_of):
        t = 0.0
        with torch.no_grad():
            for c, n in uniq.items():
                (N, C, H, W), dt, G, _, relu = c
                e = 2 if dt == torch.bfloat16 else 4
                if _plan(N, H * W, C, G, e, sms).route != route:
                    continue
                plan = plan_of(N, H * W, C, G, e)
                if plan is None:
                    return None
                x, res, w, b = inputs[c]
                t += n * device_ms(
                    lambda: _launch(x, G, w, b, GN_EPS, dt, res, relu, plan),
                    iters=3)
        return t

    for threads in (256, 512):
        for tile in (24, 48, 96):
            for per_sm in (2, 4, 8):
                t = total("split", lambda N, HW, C, G, e: _plan(
                    N, HW, C, G, e, sms, tile * 1024, per_sm, threads))
                print(f"K3 sweep split: {threads} threads, {tile} KB tiles, "
                      f"{per_sm} apply blocks an SM: {t:.4f} ms a forward",
                      flush=True)
    for threads in (256, 512):
        def one(N, HW, C, G, e, threads=threads):
            smem = HW * C * e + _stats_smem(C, G, e, threads)
            if C * e // 16 > threads or smem > _SMEM_MAX:
                return None
            return Plan("onepass", threads, smem)

        t = total("onepass", one)
        print(f"K3 sweep onepass: {threads} threads: "
              + ("does not fit" if t is None else f"{t:.4f} ms a forward"),
              flush=True)
    del inputs
    torch.cuda.empty_cache()


def phase_group_norm(dev, gpu, profile=False):
    """K3 at every GroupNorm call of the OMNIISEG b8 forward (the routes,
    every epilogue the model uses) and at f32 twins of both routes, held
    against the plain version and timed; its launches a forward at b8, b1
    and COCO2VOC b4, and a train step's (all through autograd); with
    ``profile``, ``k3_sweep``. → the kernels line's record."""
    import torch

    gen = torch.Generator().manual_seed(18)
    omni = bench_cfg("omniiseg-n3k3-480")
    launches, calls = k3_forward_counts("omniiseg", omni, 8, 480, 480, 128,
                                        dev)
    uniq = list(dict.fromkeys(calls))
    recs = {c: k3_record(gen, c, dev) for c in uniq}
    for shape in ((16, 512, 7, 7), (16, 1024, 7, 7), (2, 32, 240, 240)):
        for with_res, relu in ((False, False), (False, True), (True, True)):
            k3_record(gen, (shape, torch.float32, 32, with_res, relu), dev,
                      timed=False)
    tot = {k: sum(recs[c][k] for c in calls)
           for k in ("ms", "bound_ms", "plain_ms", "library_ms")}
    by_route = {r: sum(recs[c]["ms"] for c in calls if recs[c]["route"] == r)
                for r in ("onepass", "split")}
    print(f"K3 a b8 forward ({len(calls)} calls): kernels {tot['ms']:.3f} ms "
          f"(onepass {by_route['onepass']:.3f}, split {by_route['split']:.3f}), "
          f"bound {tot['bound_ms']:.3f} ms "
          f"({100 * tot['bound_ms'] / tot['ms']:.1f} %), plain "
          f"{tot['plain_ms']:.3f} ms, library F.group_norm alone "
          f"{tot['library_ms']:.3f} ms; on {gpu}", flush=True)
    if profile:
        k3_sweep(calls, gen, dev)
    b1, _ = k3_forward_counts("omniiseg", omni, 1, 480, 480, 128, dev)
    c2v, _ = k3_forward_counts(
        "coco2voc", bench_cfg("coco2voc-n3k3-800"), 4, 800, 1088, 128, dev)
    model, _, step, batch, tgen = make_train(2, dev)
    step(batch, tgen)
    torch.cuda.synchronize()
    zero_counts()
    with composition_calls() as plain:
        step(batch, tgen)
        torch.cuda.synchronize()
    train = gn_counts()
    bwd = train["gn.bwd.onepass"] + train["gn.bwd.split"]
    check(train["gn.train"] > 0 and bwd == train["gn.train"]
          and train["gn.onepass"] + train["gn.split"] == train["gn.train"]
          and not plain,
          f"K3 in a train step: {train}, {len(plain)} composition calls; "
          f"want every call on the kernels, forward and backward")
    print(f"K3 a train step (flagship b2): {train}, composition calls 0",
          flush=True)
    del model, step, batch
    torch.cuda.empty_cache()
    phase_k3_train(dev, gpu, gen)
    big = max(uniq, key=lambda c: math.prod(c[0]))
    return dict(
        recs[big], name="group_norm", source="fgn_torch/csrc/group_norm.cu",
        replaces="none (XLA fuses flax nn.GroupNorm)",
        path="OMNIISEG b8 forward, " + ", ".join(
            f"{k} {v:.4f}" for k, v in tot.items()) + " ms a forward",
        launches=launches, route="cuda", bound_by="bytes",
        launches_main_paths={"omniiseg_b8": launches, "omniiseg_b1": b1,
                             "coco2voc_b4": c2v, "train_step": train})


@contextlib.contextmanager
def composition_calls():
    """The calls to K3's plain composition inside the block, listed by
    device (the module's ``group_norm_plain``, patched to count)."""
    import fgn_torch.ops.group_norm_cuda as gnc

    seen, plain = [], gnc.group_norm_plain

    def rec(x, *a, **k):
        seen.append(str(x.device))
        return plain(x, *a, **k)

    with mock.patch.object(gnc, "group_norm_plain", rec):
        yield seen


# K3-bwd's holds: the composition's gradients on the same inputs, dy and
# ReLU mask (the kernels' forward output's: the two forwards round a few
# elements one bf16 ulp apart, and where such an element's sum with the
# residual falls on 0 in one of them the masks differ, at most GN_MASK_SHARE
# of the elements), i.e. dres = dz and autograd through F.group_norm in f32
# from dz, cast to x's dtype. dx is rounded once in both from f32 values
# summed in other orders, so an element may round the other way: within
# 2^-7 (|want| + |got|) (about two bf16 ulp; f32: 1e-5) + 1e-5 of the
# largest |want|. dres must be equal. dweight and dbias are f32 sums over
# N·H·W terms a channel in other orders: within GN_PARAM_TOL of the
# channel's sum of |terms| (f32 sums of n terms in two orders differ by
# about sqrt(n)·2^-24 of it, 2.3e-5 at the relation head's 150,528 terms).
GN_PARAM_TOL = 1e-4
GN_MASK_SHARE = 1e-5


def k3_bwd_hold(tag, got, want, x, dz, G, needs):
    """K3-bwd's gradients ``got`` against the composition's ``want`` (both
    in the order of (x, weight, bias, residual) that ``needs`` keeps), dz
    the masked gradient both were given. → the worst of each held gradient
    as a share of its tolerance (dres: the share of elements that
    differ)."""
    import torch
    import torch.nn.functional as F

    names = [n for n, k in zip(("dx", "dweight", "dbias", "dres"),
                               (needs[0], needs[1], needs[1], needs[2])) if k]
    worst = {}
    for name, g, w in zip(names, got, want):
        if name == "dres":
            worst[name] = float((g != w).float().mean())
            check(worst[name] == 0, f"K3-bwd {tag}: dres differs at "
                                    f"{worst[name]:.2e} of the elements")
            continue
        if name == "dx":
            gf, wf = g.float(), w.float()
            rel = 2.0 ** -7 if x.dtype == torch.bfloat16 else 1e-5
            tol = rel * (wf.abs() + gf.abs()) + 1e-5 * float(wf.abs().max())
        else:
            terms = dz.double().abs()
            if name == "dweight":
                terms = terms * F.group_norm(x.double(), G).abs()
            tol = GN_PARAM_TOL * terms.sum((0, 2, 3)).float() + 1e-30
            gf, wf = g, w
        ratio = float(((gf - wf).abs() / tol).max())
        check(ratio <= 1, f"K3-bwd {tag}: {name} off by {ratio:.3g} of its "
                          f"tolerance")
        worst[name] = ratio
    return worst


def k3_bwd_record(gen, call, dev, timed=True):
    """K3 forward and K3-bwd at one train-step call (shape, dtype, groups,
    residual, ReLU, which of x, weight, residual require grad): the routes
    it lands on, the forward's output equal to the serving kernel's, two
    calls bit for bit, held against the composition's gradients
    (``k3_bwd_hold``), and forward + backward timed on the card
    (``device_ms``) beside the composition's (``group_norm_plain`` under
    autograd) and the byte bound (forward: x and the residual read, out
    written; backward: x, dy and (ReLU) out read, dx and (residual) dres
    written; 3.35 TB/s). → its record."""
    import torch
    import torch.nn.functional as F

    from fgn_torch.ops.group_norm_cuda import (
        _launch, _launch_bwd, _plan, _plan_bwd, _sm_count, group_norm,
        group_norm_plain,
    )

    shape, dtype, G, with_res, relu, needs = call
    N, C, H, W = shape
    x, res, w, b = k3_inputs(gen, shape, dtype, with_res, dev)
    dy = k3_inputs(gen, shape, dtype, False, dev)[0]
    x = x.detach().requires_grad_(needs[0])
    w.requires_grad_(needs[1])
    b.requires_grad_(needs[1])
    if res is not None:
        res = res.detach().requires_grad_(needs[2])
    leaves = [t for t in (x, w, b, res) if t is not None and t.requires_grad]
    e, sms = x.element_size(), _sm_count(dev.index or 0)
    fwd = _plan(N, H * W, C, G, e, sms).route
    bwd = _plan_bwd(N, H * W, C, G, e, sms).route

    def run(fn):
        out = fn(x, G, w, b, GN_EPS, dtype, res, relu)
        return (out, *torch.autograd.grad(out, leaves, dy))

    (out, *got), moved = moved_by(run, GN_COUNTERS, group_norm)
    want_moved = tuple(int(k in ("gn." + fwd, "gn.train", "gn.bwd." + bwd))
                       for k in GN_COUNTERS)
    check(moved == want_moved, f"K3-bwd {shape}: moved {moved}, want the "
                               f"{fwd} forward and {bwd} backward")
    _, *again = run(group_norm)
    torch.cuda.synchronize()
    check(all(torch.equal(a, c) for a, c in zip(got, again)),
          f"K3-bwd {shape}: two calls differ")
    del again
    tag = (f"{tuple(shape)} {str(dtype)[6:]} "
           f"{'res+' if with_res else ''}{'relu' if relu else 'none'}"
           f"{'' if all(needs[:2]) else ' needs ' + str(needs)}")
    with torch.no_grad():
        check(torch.equal(out, group_norm(x, G, w, b, GN_EPS, dtype, res,
                                          relu)),
              f"K3-bwd {tag}: the training forward's output differs from "
              f"the serving kernel's")
        out_c = group_norm_plain(x, G, w, b, GN_EPS, dtype, res, relu)
        flips = float(((out > 0) != (out_c > 0)).float().mean())
        check(flips <= GN_MASK_SHARE, f"K3-bwd {tag}: ReLU masks differ at "
                                      f"{flips:.2e} of the elements")
        dz = torch.where(out <= 0, 0, dy) if relu else dy
        del out_c
    xf, wf, bf = (t.detach().float().requires_grad_(t.requires_grad)
                  for t in (x, w, b))
    ref = [t for t in (xf, wf, bf) if t.requires_grad]
    want = list(torch.autograd.grad(F.group_norm(xf, G, wf, bf, GN_EPS),
                                    ref, dz.float())) if ref else []
    if needs[0]:
        want[0] = want[0].to(dtype)
    if with_res and needs[2]:
        want.append(dz)
    worst = k3_bwd_hold(tag, got, want, x.detach(), dz, G, needs)
    del want, ref, xf
    rec = dict(shape=tuple(shape), dtype=str(dtype)[6:], residual=with_res,
               relu=relu, route=fwd, bwd_route=bwd, worst=worst,
               mask_flips=flips)
    line = (f"K3-bwd {tag}: {fwd} / {bwd}, mask flips {flips:.1e}, worst "
            "share of tolerance "
            + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))
    if timed:
        size = x.numel() * x.element_size()
        nbytes = size * (3 + relu + with_res) + 6 * C * 4
        rec["bound_ms"] = (nbytes + size * (2 + with_res)) / HBM_BYTES_S * 1e3
        rec["bwd_bound_ms"] = nbytes / HBM_BYTES_S * 1e3
        rec["ms"] = device_ms(lambda: run(group_norm))
        rec["plain_ms"] = device_ms(lambda: run(group_norm_plain))
        with torch.no_grad():
            stats = torch.empty((N, G, 2), dtype=torch.float32, device=dev)
            y = _launch(x, G, w, b, GN_EPS, dtype, res, relu, stats=stats)
            grads = needs[:2] + needs[1:]
            rec["bwd_ms"] = device_ms(lambda: _launch_bwd(
                x, y if relu else None, dy, stats, w, G, grads))
        wl, bl = (t.detach().to(dtype).requires_grad_(t.requires_grad)
                  for t in (w, b))
        lib = [t for t in (x, wl, bl) if t.requires_grad]
        rec["library_ms"] = device_ms(lambda: torch.autograd.grad(
            F.group_norm(x, G, wl, bl, GN_EPS), lib, dy))
        line += (f"; forward + backward {rec['ms']:.4f} ms, bound "
                 f"{rec['bound_ms']:.4f} ms (bytes; "
                 f"{100 * rec['bound_ms'] / rec['ms']:.1f} % of it), "
                 f"composition {rec['plain_ms']:.4f} ms, library "
                 f"F.group_norm {rec['library_ms']:.4f} ms; backward alone "
                 f"{rec['bwd_ms']:.4f} ms, bound {rec['bwd_bound_ms']:.4f} ms "
                 f"({100 * rec['bwd_bound_ms'] / rec['bwd_ms']:.1f} %)")
    print(line, flush=True)
    return rec


def phase_k3_train(dev, gpu, gen):
    """K3 and K3-bwd at every GroupNorm call of one b8 train step of
    ``omniiseg-n3k3-480`` (the cell ``omniiseg-train-b8``'s model and
    batch), held and timed (``k3_bwd_record``), and at f32 twins of both
    backward routes and with frozen weights or a frozen input, held; the
    step's totals printed."""
    import torch

    model, _, step, batch, tgen = make_train(
        8, dev, bench_cfg("omniiseg-n3k3-480"))
    calls = capture_gn_calls(lambda: step(batch, tgen), grads=True)
    del model, step, batch
    torch.cuda.empty_cache()
    uniq = list(dict.fromkeys(calls))
    recs = {c: k3_bwd_record(gen, c, dev) for c in uniq}
    for shape in ((16, 512, 7, 7), (16, 1024, 7, 7), (2, 32, 240, 240)):
        for with_res, relu in ((False, False), (True, True)):
            k3_bwd_record(gen, (shape, torch.float32, 32, with_res, relu,
                                (True, True, with_res)), dev, timed=False)
    for needs in ((True, False, True), (False, True, True)):
        for shape in ((64, 1024, 7, 7), (8, 256, 120, 120)):
            k3_bwd_record(gen, (shape, torch.bfloat16, 32, True, True, needs),
                          dev, timed=False)
    tot = {k: sum(recs[c][k] for c in calls)
           for k in ("ms", "bound_ms", "plain_ms", "library_ms", "bwd_ms",
                     "bwd_bound_ms")}
    by_route = {r: sum(recs[c]["bwd_ms"] for c in calls
                       if recs[c]["bwd_route"] == r)
                for r in ("onepass", "split")}
    print(f"K3 + K3-bwd a b8 train step ({len(calls)} calls, "
          f"{len(uniq)} distinct): forward + backward {tot['ms']:.3f} ms, "
          f"bound {tot['bound_ms']:.3f} ms "
          f"({100 * tot['bound_ms'] / tot['ms']:.1f} %), composition "
          f"{tot['plain_ms']:.3f} ms, library F.group_norm "
          f"{tot['library_ms']:.3f} ms; backward alone {tot['bwd_ms']:.3f} ms "
          f"(onepass {by_route['onepass']:.3f}, split "
          f"{by_route['split']:.3f}), bound {tot['bwd_bound_ms']:.3f} ms "
          f"({100 * tot['bwd_bound_ms'] / tot['bwd_ms']:.1f} %); on {gpu}",
          flush=True)


# K4: the ViT's attention with decomposed relative positions
# (csrc/vit_attention.cu) ---------------------------------------------------

# (name, B, h, w, rows of the table before rel_table resizes it) at the ViT
# cell's b4 request (coco2voc-vitdet-l-serve-b4): the queries' global blocks
# (64x64 grid, 127-row tables), their 14x14 windows (25 an image), the
# supports' global blocks (8x8, tables resized from 127 rows to 15) and
# windows (one 14x14 window a support, 36 supports); then a 768x1024 image's
# unpadded 48x64 grid (aligned key tiles, a non-square grid) and a 10x24 grid
# whose T = 240 overhangs its last key tile.
K4_SHAPES = [
    ("global-q", 4, 64, 64, 127),
    ("window-q", 100, 14, 14, 27),
    ("global-s", 36, 8, 8, 127),
    ("window-s", 36, 14, 14, 27),
    ("nonsquare", 2, 48, 64, 127),
    ("ragged", 3, 10, 24, 47),
]
K4_HEADS = 16
# Held to the plain version computed in f32 on the same bf16 inputs (q, k,
# v of unit variance): the kernel rounds its softmax weights to bf16 before
# they meet v and its output to bf16 (2^-9 of |out| <= ~4), so 0.02 is
# several times its rounding; the plain version in bf16 (its bias rounded
# to bf16) is printed beside it.
K4_TOL = 0.02
PEAK_BF16_FLOPS_S = 989.4e12
VIT_CELL = "coco2voc-vitdet-l-n3k3-1024"


def k4_inputs(gen, B, h, w, rows, dev, heads=K4_HEADS):
    """q, k, v as the qkv projection's permuted view of (B, T, 3, heads,
    64) bf16 of unit variance, and the gathered tables (rows of variance
    1/64, resized by ``rel_table`` where ``rows`` differs from 2·size − 1)."""
    import torch

    from fgn_torch.models.vit import rel_table

    T = h * w
    qkv = torch.randn((B, T, 3, heads, 64), generator=gen).to(
        dev, torch.bfloat16)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    th, tw = (torch.randn((rows, 64), generator=gen) / 8 for _ in range(2))
    rh = rel_table(th.to(dev), h).to(torch.bfloat16)
    rw = rel_table(tw.to(dev), w).to(torch.bfloat16)
    return q, k, v, rh, rw


def k4_flops(B, heads, h, w, d=64):
    """The least work of one call (benchmark/harness/attention.py's count):
    4·d a score, 2·d·(h + w) a query row's bias terms."""
    T = h * w
    return 4 * d * B * heads * T * T + 2 * d * B * heads * T * (h + w)


def k4_library(q, k, v, rh, rw):
    """What the port ran before K4, timed only: the bias built in memory and
    PyTorch's SDPA over it."""
    import torch.nn.functional as F

    from fgn_torch.ops.vit_attention_cuda import rel_bias

    return F.scaled_dot_product_attention(q, k, v,
                                          attn_mask=rel_bias(q, rh, rw))


def k4_request_counts(dev):
    """One b4 request of the ViT cell's model (random weights) through
    ``test_forward``: K4 launches once an ``attend`` (24 blocks over the
    queries and 24 over the supports), no bias is built in memory and SDPA
    is never called. → the request's counters."""
    from pathlib import Path

    import torch
    import torch.nn.functional as F

    from fgn_torch.config.vit import ViTDetConfig
    from fgn_torch.data.batching import to_device, toy_batch
    from fgn_torch.models.fgn import FGN
    from fgn_torch.utils.profiling import counts

    with open(Path(__file__).resolve().parent / "benchmark" / "configs"
              / f"{VIT_CELL}.json") as f:
        bb = json.load(f)["backbone"]
    vcfg = ViTDetConfig(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in bb.items()})
    cfg = bench_cfg(VIT_CELL)
    model = FGN(cfg, backbone=vcfg).to(dev).eval()
    # random weights drawn on the card (init_params draws 300 M on the CPU,
    # seconds of the phase): the counts do not depend on them
    gen = torch.Generator(device=dev).manual_seed(20)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif p.dim() == 1:
                p.fill_(1.0)
            else:
                p.normal_(0.0, p[0].numel() ** -0.5, generator=gen)
    batch = to_device(toy_batch(B=4, H=1024, W=1024, N=cfg.n_ways,
                                K=cfg.k_shots, S=128), dev)
    model.test_forward(batch)
    torch.cuda.synchronize()
    zero_counts()

    def refuse(*a, **k):
        raise RuntimeError("F.scaled_dot_product_attention called")

    with mock.patch.object(F, "scaled_dot_product_attention", refuse):
        model.test_forward(batch)
    torch.cuda.synchronize()
    got = {k: v for k, v in counts().items()
           if k.startswith(("k4.", "vit."))}
    want = 2 * vcfg.depth
    check(got.get("k4.launches") == want and not got.get("vit.bias_bytes"),
          f"K4 a ViT request: {got}, want k4.launches {want} and no "
          f"vit.bias_bytes")
    print(f"K4 a ViT cell request (b4 1024 px, 36 supports of 128 px): "
          f"{got}", flush=True)
    del model, batch
    torch.cuda.empty_cache()
    return got


def phase_vit_attention(dev, gpu):
    """K4 at the ViT cell's shapes and two more, held to the plain version
    in f32 (``K4_TOL``), two launches bit for bit alike, each timed; the
    largest call (the queries' global block at b4) also through the plain
    version and the library's SDPA over the bias in memory; the launches of
    one ViT cell request. → the kernels line's record."""
    import torch

    from fgn_torch.ops import vit_attention_cuda as k4

    gen = torch.Generator().manual_seed(20)
    rec = None
    for name, B, h, w, rows in K4_SHAPES:
        q, k, v, rh, rw = k4_inputs(gen, B, h, w, rows, dev)
        with torch.no_grad():
            got, n = moved_by(k4.vit_attention, ("k4.launches",),
                              q, k, v, rh, rw)
            check(n == (1,), f"K4 {name}: k4.launches moved {n}")
            again = k4.vit_attention(q, k, v, rh, rw)
            with strict_f32():
                want = k4.vit_attention_plain(*(t.float() for t in
                                                (q, k, v, rh, rw)))
            plain = k4.vit_attention_plain(q, k, v, rh, rw)
        torch.cuda.synchronize()
        err = (got.float() - want).abs().max().item()
        plain_err = (plain.float() - want).abs().max().item()
        check(torch.equal(got, again), f"K4 {name}: two launches differ")
        check(err <= K4_TOL, f"K4 {name}: max |kernel - f32| {err:.3g} over "
                             f"{K4_TOL}")
        ms = cuda_ms(lambda: k4.vit_attention(q, k, v, rh, rw), iters=20)
        flops = k4_flops(B, K4_HEADS, h, w)
        print(f"K4 {name} B{B} {h}x{w} (T {h * w}, plan "
              f"{tuple(k4.plan(h, w))}): max |kernel - f32| {err:.4g}, "
              f"|plain bf16 - f32| {plain_err:.4g}; {ms:.4f} ms, "
              f"{flops / ms / 1e9:.1f} TFLOP/s, "
              f"{100 * flops / PEAK_BF16_FLOPS_S / (ms / 1e3):.1f} % of the "
              f"bf16 peak", flush=True)
        if rec is None:  # the largest call
            with torch.no_grad():
                plain_ms = cuda_ms(
                    lambda: k4.vit_attention_plain(q, k, v, rh, rw), iters=3)
                lib_ms = cuda_ms(lambda: k4_library(q, k, v, rh, rw),
                                 iters=5)
            rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms,
                       bound_ms=1e3 * flops / PEAK_BF16_FLOPS_S)
            print(f"K4 {name}: kernel {ms:.4f} ms, bound {rec['bound_ms']:.4f}"
                  f" ms (FLOPs), plain {plain_ms:.3f} ms, library (bias in "
                  f"memory + SDPA) {lib_ms:.3f} ms; on {gpu}", flush=True)
        del q, k, v, rh, rw, got, again, want, plain
        torch.cuda.empty_cache()
    launches = k4_request_counts(dev)
    return dict(
        rec, name="vit_attention", source="fgn_torch/csrc/vit_attention.cu",
        replaces="none (the JAX package has no ViT)",
        path="ViT cell, the queries' global block at b4 (4, 16, 4096, 64)",
        launches=launches.get("k4.launches", 0), route="cuda",
        bound_by="FLOPs")


def flagship_cfg(**kw):
    from fgn_torch.config import FGNConfig
    from fgn_torch.entry import FLAGSHIP_CFG

    return FGNConfig(**{**FLAGSHIP_CFG, **kw})


def make_train(nb, dev, cfg=None):
    """The flagship's trainer (or ``cfg``'s): ``make_train_step``
    (train_forward, backward, Adam at ``make_lr_schedule(5e-3,
    steps_per_epoch=1000)``), seeded random weights, 480 px N3K3 episodes at
    batch ``nb``, the ROI sample's generator seeded with 2. → (model,
    optimizer, step, batch, generator)."""
    import torch

    from fgn_torch.data.batching import to_device, toy_batch
    from fgn_torch.models.fgn import build_model
    from fgn_torch.train.optim import build_optimizer, make_lr_schedule
    from fgn_torch.train.train_step import make_train_step

    model = build_model(cfg or flagship_cfg(), dev, seed=0)
    opt = build_optimizer(model, optimizer="adam",
                          schedule=make_lr_schedule(5e-3,
                                                    steps_per_epoch=1000))
    step = make_train_step(model, opt)
    batch = to_device(toy_batch(B=nb, H=480, W=480, N=3, K=3, S=128), dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    return model, opt, step, batch, gen


def zero_counts():
    from fgn_torch.utils.profiling import reset

    reset()


# the program's launch counters (fgn_torch/utils/profiling.py) by the names
# this script prints
COUNTERS = {"roi_align": "k1.staged", "roi_align_direct": "k1.direct",
            "roi_align_backward": "k1_bwd.staged",
            "roi_align_backward_atomic": "k1_bwd.atomic",
            "nms_keep": "k2.staged", "nms_keep_unstaged": "k2.unstaged"}


def read_counts():
    from fgn_torch.utils.profiling import counts

    now = counts()
    return {k: now.get(v, 0) for k, v in COUNTERS.items()}


# K1's, K1-bwd's and K2's launches are their staged kernels': no map of a
# main path takes K1's direct kernel or K1-bwd's atomics kernel, no Mp K2's
# unstaged walk.
SERVE_KERNELS = {"roi_align": 3, "roi_align_direct": 0,
                 "roi_align_backward": 0, "roi_align_backward_atomic": 0,
                 "nms_keep": 2, "nms_keep_unstaged": 0}
TRAIN_KERNELS = {"roi_align": 2, "roi_align_direct": 0,
                 "roi_align_backward": 2, "roi_align_backward_atomic": 0,
                 "nms_keep": 1, "nms_keep_unstaged": 0}
# The COCO2VOC configs' train steps: rpn_train_nms_pre=12288 is past the
# 11,357 candidates whose boxes fit in shared memory, so K2 takes its
# unstaged walk; with a frozen backbone (configs/fgn_r50_c4_densecl.py) no
# map needs a gradient and K1-bwd does not launch.
COCO2VOC_TRAIN_KERNELS = dict(TRAIN_KERNELS, nms_keep=0, nms_keep_unstaged=1)
DENSECL_TRAIN_KERNELS = dict(COCO2VOC_TRAIN_KERNELS, roi_align_backward=0)


def counted_forward(model, batch):
    """One test_forward with the launch counters set to 0 just before and
    read just after. → (outputs, {kernel: launches})."""
    import torch

    torch.cuda.synchronize()
    zero_counts()
    out = model.test_forward(batch)
    torch.cuda.synchronize()
    return out, read_counts()


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


def capture_kernel_args(model, batch):
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


def counted(fn, counts):
    """fn with the launch counters set to 0 just before each call and read
    just after, each call's counts appended to ``counts``."""
    def wrapped(*a, **k):
        zero_counts()
        out = fn(*a, **k)
        counts.append(read_counts())
        return out
    return wrapped


# COCO2VOC serving (benchmark/configs/coco2voc-n3k3-800.json): 800x1088
# canvases, 256 px supports, rpn_test_nms_pre 6144 (K2's longest staged
# walk), b4; N3K3, and N1K1, the one run of K1 on 4 support maps of R = 1
# and of K2 at Mp 6144 with one way.
COCO2VOC_GEOMETRY = dict(B=4, H=800, W=1088, S=256)
COCO2VOC_NMS_PRE = 6144
COCO2VOC_WAYS = (("coco2voc", 3, 3), ("coco2voc-n1k1", 1, 1))


def phase_main_path(dev, gpu, B=8, H=480, W=480, S=128, N=3, K=3,
                    tag="flagship", **cfg_kw):
    """FGN.test_forward through the kernels: a warm-up forward, then one
    with its launches counted and its outputs checked. → (model, batch, the
    kernels' calls of one more forward, its launches)."""
    from fgn_torch.data.batching import to_device, toy_batch
    from fgn_torch.models.fgn import build_model

    cfg = flagship_cfg(n_ways=N, k_shots=K, **cfg_kw)
    model = build_model(cfg, dev, seed=0)
    batch = to_device(toy_batch(B=B, H=H, W=W, N=N, K=K, S=S), dev)
    model.test_forward(batch)  # warm-up: cuDNN plans, kernel load
    out, counts = counted_forward(model, batch)
    check(counts == SERVE_KERNELS,
          f"{tag}: want launches {SERVE_KERNELS} per forward, got {counts}")
    check_outputs(out, cfg, B, tag)
    print(f"main path {tag}: test_forward b{B} {H}x{W} N{N}K{K} S{S} bf16: "
          f"launches {counts}; {int(out['dt_valid'].sum())} detections; on "
          f"{gpu}", flush=True)
    return model, batch, capture_kernel_args(model, batch), counts


def k1_record(where, i, a, k, iters=20):
    """K1 at one call of a main path (roi_align_cuda's arguments a, k): the
    staged kernel (which the call must take) and the direct kernel, each
    held against the plain version; both timed in turns, staged, direct,
    direct, staged, over runs of ``reps`` launches (CUDA events, so a call
    shorter than its host time reads as the host time), and on the card
    alone (``device_ms``), beside the plain version and the bound. → its
    record."""
    from fgn_torch.ops.roi_align_cuda import _roi_align_plain, roi_align_cuda

    fmap, rois = a[0], a[1]
    got, design = k1_landed(roi_align_cuda, *a, **k)
    check(design == "staged", f"K1 {where} call {i} took the {design} kernel")
    old = k1_direct(*a, **k)
    with strict_f32():
        ref = _roi_align_plain(fmap.float(), *a[1:], **k)
    err = float((got.float() - ref).abs().max())
    err_old = float((old.float() - ref).abs().max())
    bound = 2 * 2.0 ** -8 * float(ref.abs().max())
    check(err <= bound, f"K1 {where} call {i}: {err} > 2 ulp {bound}")
    check(err_old <= bound, f"K1 direct {where} call {i}: {err_old} > {bound}")
    reps = 10

    def run(fn):
        return lambda: [fn(*a, **k) for _ in range(reps)]

    times = [cuda_ms(run(fn), iters) / reps
             for fn in (k1_forward, k1_direct, k1_direct, k1_forward)]
    ms, earlier_ms = (times[0] + times[3]) / 2, (times[1] + times[2]) / 2
    dev_ms, dev_old = (device_ms(lambda: fn(*a, **k))
                       for fn in (k1_forward, k1_direct))
    plain_ms = cuda_ms(lambda: _roi_align_plain(*a, **k), 3, warmup=1)
    # the map and rois read once, the output written once; 16 corner
    # weights, a multiply-add each, per output element
    nbytes = (fmap.numel() * fmap.element_size() + rois.numel() * 4
              + got.numel() * got.element_size())
    ops = ROI_ALIGN_FLOPS * got.numel()
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / F32_FLOPS_S
    bound_ms = max(t_bytes, t_ops) * 1e3
    print(f"roi_align {where} call {i}: map {tuple(fmap.shape)} "
          f"{str(fmap.dtype)[6:]}, rois {tuple(rois.shape)}: err {err:.3g} "
          f"(direct {err_old:.3g}); staged {ms:.4f} ms ({times[0]:.4f}, "
          f"{times[3]:.4f}; on the card {dev_ms:.4f}), direct "
          f"{earlier_ms:.4f} ms ({times[1]:.4f}, {times[2]:.4f}; on the card "
          f"{dev_old:.4f}), plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms "
          f"({'bytes' if t_bytes >= t_ops else 'operations'})", flush=True)
    return dict(
        name="roi_align", route="cuda", source="fgn_torch/csrc/roi_align.cu",
        replaces="roi_align_pallas.py:264", max_abs_err=err, ms=ms,
        earlier_ms=earlier_ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=None, _size=got.numel(),
    )


def k2_sweep(where, a):
    """K2's walk at one call with every cluster size from 1 to 16 blocks an
    image (``--profile`` only), through its C entry point (no counter
    moves): time on the card (``device_ms``) for each, beside the clusters
    of that size the card holds at once, to show where the rule's choice
    stands."""
    import torch

    from fgn_torch.ops import _build
    from fgn_torch.ops.nms_cuda import _cluster_size, _max_clusters

    boxes, alive, thr = a[0], a[1], float(a[2])
    B, Mp = alive.shape
    keep = torch.empty_like(alive)
    lib = _build.load("nms")
    stream = torch.cuda.current_stream(boxes.device).cuda_stream

    def walk(g):
        rc = lib.fgn_nms_keep(boxes.data_ptr(), alive.data_ptr(),
                              keep.data_ptr(), B, Mp, thr, g, 1, stream)
        _build.check(lib, "fgn_nms_error_string", rc, "nms walk")

    fits = {g: _max_clusters(boxes.device.index or 0, g, Mp, True)
            for g in (16, 8, 4, 2, 1)}
    res = [f"{g} {device_ms(lambda: walk(g)):.4f} ({fits[g]} fit)"
           for g in (1, 2, 4, 8, 16)]
    print(f"K2 walk sweep at {where} boxes {tuple(boxes.shape)}: ms on the "
          f"card by blocks an image (clusters the card holds at once; the "
          f"rule picks {_cluster_size(B, Mp, fits.get)}): " + ", ".join(res),
          flush=True)


def k1_sweep(a, k):
    """K1's staged kernel at one call with other channel tiles and ROI
    groups than its rules pick (``--profile`` only): time on the card
    (``device_ms``) for each, to show where the rules' choice stands."""
    import fgn_torch.ops.roi_align_cuda as rac

    fmap = a[0]
    B, H, W, C = fmap.shape
    tile = rac._channel_tile(H, W, C, fmap.dtype)
    rule = (tile, rac._rois_per_block(B, C // tile, a[1].shape[1],
                                      rac._sm_count(fmap.device)))
    res = []
    for tile in (16, 32, 64):
        for per in sorted({rule[1], 64, 24, 16}, reverse=True):
            with mock.patch.object(rac, "_channel_tile", lambda *_a, **_k: tile), \
                    mock.patch.object(rac, "_rois_per_block",
                                      lambda *_a, **_k: per):
                res.append(f"{tile}/{per} {device_ms(lambda: k1_forward(*a, **k)):.4f}")
    print(f"K1 staged sweep at map {tuple(fmap.shape)}, rois "
          f"{tuple(a[1].shape)}: ms on the card by channel tile/ROIs per "
          f"block (the rules pick {rule[0]}/{rule[1]}): " + ", ".join(res),
          flush=True)


def k2_ops(keep, alive):
    """The operations of the least IoUs a greedy walk of these boxes needs:
    per image with A alive and K kept, every pair of kept boxes (each must
    be shown not to suppress the other) and one IoU above the threshold
    for each suppressed box."""
    n_keep = keep.sum(1).double()
    n_alive = alive.sum(1).double()
    return IOU_FLOPS * int((n_keep * (n_keep - 1) / 2
                            + n_alive - n_keep).sum())


def k2_bound(keep, alive):
    """K2's least time on these inputs, in seconds: (moving its bytes, doing
    its operations). Bytes: each candidate's box read and its alive and
    keep flags, 18 bytes. Operations: ``k2_ops``, the least IoUs a greedy
    walk needs."""
    B, Mp = alive.shape
    return B * Mp * (16 + 1 + 1) / HBM_BYTES_S, k2_ops(keep, alive) / F32_FLOPS_S


def kernel_records(calls, iters=20, where="main-path", names=None):
    """Each kernel (of ``names``, all when None) on the inputs the main path
    gave it: held against its plain version, timed beside its plain version,
    its earlier design (K1's) and its bound. Returns {kernel: record of its
    largest call}."""
    import torch

    from fgn_torch.ops.nms import _greedy_alive
    from fgn_torch.ops.nms_cuda import (
        _cluster_size, _max_clusters, greedy_alive_cuda,
    )

    recs = {}
    for i, (name, a, k) in enumerate(calls):
        if names is not None and name not in names:
            continue
        if name == "roi_align":
            rec = k1_record(where, i, a, k, iters)
        else:
            boxes, alive, thr = a[0], a[1], a[2]
            got, design = k2_landed(*a, **k)
            check(design == "staged", f"K2 {where} call {i} took the {design} "
                                      f"walk")
            ref = _greedy_alive(*a, **k)
            check(torch.equal(got, ref), f"K2 {where} call {i} differs")
            err = 0.0
            reps = 10
            ms = cuda_ms(lambda: [greedy_alive_cuda(boxes, alive, thr)
                                  for _ in range(reps)], iters) / reps
            dev_ms = device_ms(lambda: greedy_alive_cuda(boxes, alive, thr))
            plain_ms = cuda_ms(lambda: _greedy_alive(*a, **k), 3, warmup=1)
            B, Mp = alive.shape
            t_bytes, t_ops = k2_bound(got, alive)
            size = B * Mp
            fits = {g: _max_clusters(boxes.device.index or 0, g, Mp, True)
                    for g in (16, 8, 4, 2)}
            desc = (f"boxes {tuple(boxes.shape)}, IoU {thr}, "
                    f"{int(alive.sum())} alive, {int(got.sum())} kept, "
                    f"{_cluster_size(B, Mp, fits.get)} blocks an image (the "
                    f"card holds {fits} clusters of 16/8/4/2)")
            bound_ms = max(t_bytes, t_ops) * 1e3
            print(f"{name} {where} call {i}: {desc}: err {err:.3g}; walk "
                  f"{ms:.4f} ms (on the card {dev_ms:.4f}), plain "
                  f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms "
                  f"({'bytes' if t_bytes >= t_ops else 'operations'})",
                  flush=True)
            rec = dict(
                name=name, route="cuda", source="fgn_torch/csrc/nms.cu",
                replaces="nms_pallas.py:157", max_abs_err=err, ms=ms,
                earlier_ms=None, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=None, _size=size,
            )
        if name not in recs or rec["_size"] > recs[name]["_size"]:
            recs[name] = rec
    for rec in recs.values():
        rec.pop("_size")
    return recs


def phase_breakdown(what, run, kind, top=12):
    """Where one call's device time goes (``--profile`` only): torch.profiler
    over ``run()``, whose stages are the program's own spans of its
    ``kind`` unit (``fgn_torch/utils/profiling.py``: the ``fgn/`` ranges,
    with each span's stream ms from its CUDA events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fgn_torch.utils import profiling

    run()  # warm the path
    torch.cuda.synchronize()
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()

    def on_card(e):
        return e.device_type.name == "CUDA"

    def stage(e):
        return e.key.startswith(profiling.PREFIX) and not on_card(e)

    busy = sum(e.self_device_time_total for e in events
               if on_card(e) and not e.is_user_annotation) / 1e3
    print(f"profile: one {what}, wall {wall:.3f} ms with the profiler on; "
          f"kernels busy {busy:.3f} ms ({100 * busy / wall:.1f} %), idle "
          f"{max(wall - busy, 0.0):.3f} ms", flush=True)
    for e in events:
        if stage(e):
            print(f"  stage {e.key}: {e.device_time_total / 1e3:.3f} ms on the "
                  f"card, {e.count} calls", flush=True)
    for path, v in profiling.summary(kind)["spans"].items():
        print(f"  span {path}: stream {v['stream_ms']:.3f} ms (self "
              f"{v['self_stream_ms']:.3f}), host {v['host_ms']:.3f} ms",
              flush=True)
    ops = sorted((e for e in events
                  if not on_card(e) and not stage(e)
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
    check(counts == SERVE_KERNELS, f"f32 twin counts {counts}")
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


def phase_train(dev, gpu, B=12, steps=5, profile=False):
    """The full-width trainer (``make_train``) on the flagship at b12 bf16:
    ``steps`` steps, each with the launch counters set to 0 just before it
    and read just after, their losses finite and both parameter groups
    moved, K5 launched once with every tensor; the step's split at the
    program's spans; then ``k5_check``. → (the launches of one step, the K1
    forward, K1-bwd and K2 calls of one more step, K5's record). With
    ``profile``, one more step is profiled: its forward by stage, and the
    whole step by op."""
    import torch

    model, opt, step, batch, gen = make_train(B, dev)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts, metrics, k5 = [], [], []
    counted_step = counted(step, counts)
    for _ in range(steps):
        metrics.append(counted_step(batch, gen))
        k5.append(k5_counts())
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    check(all(c == TRAIN_KERNELS for c in counts),
          f"train step: want {steps} steps of {TRAIN_KERNELS}, got "
          f"{[c for c in counts if c != TRAIN_KERNELS][:2]}")
    want_k5 = {"k5.launches": 1, "k5.tensors": len(before),
               "opt.plain_tensors": 0}
    check(all(c == want_k5 for c in k5),
          f"train step: K5's counters {k5[0]}, want {want_k5} a step")
    bad = [k for m in metrics for k, v in m.items()
           if k.startswith("loss_") and not bool(torch.isfinite(v))]
    check(not bad, f"train step: non-finite {bad}")
    moved = {g["label"]: any(not torch.equal(p, before[n])
                             for n, p in model.named_parameters()
                             if any(p is q for q in g["params"]))
             for g in opt.param_groups}
    check(moved == {"main": True, "roi": True},
          f"train step: parameters moved per group {moved}")
    losses = {k: round(float(v), 4) for k, v in metrics[-1].items()
              if k.startswith("loss_")}
    print(f"train step b{B} 480x480 N3K3 S128 bf16 adam: launches per step "
          f"{counts[0]} in all {steps}; losses {losses}; peak memory "
          f"{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated), on "
          f"{gpu}", flush=True)

    split = step_split(step, batch, gen)
    print("train step split (the program's spans' CUDA events, median of 3; "
          "host gaps inside a part included): " + ", ".join(
              f"{k} {v:.3f} ms" for k, v in split.items()), flush=True)

    fwd_calls, calls, nms_calls = capture_train_calls(step, batch, gen)
    if profile:
        phase_breakdown(
            "train step", lambda: step(batch, gen), "step")
    del model, opt, before, batch
    torch.cuda.empty_cache()
    # K5's launches as counted in the main path's first step
    k5_rec = dict(k5_check(dev, gpu), launches=k5[0]["k5.launches"])
    return counts[0], fwd_calls, calls, nms_calls, k5_rec


# K5's counters a step (fgn_torch/ops/optim_cuda.py, train/optim.py)
K5_COUNTERS = ("k5.launches", "k5.tensors", "opt.plain_tensors")
# bytes a parameter K5 moves: p, g and the state read, p and the state
# written
K5_BYTES = {"adagrad": 20, "adam": 28}


def k5_counts():
    from fgn_torch.utils.profiling import counts

    now = counts()
    return {k: now.get(k, 0) for k in K5_COUNTERS}


def ulps(a, b):
    """The largest distance in float32 units in the last place between a
    and b (same shape)."""
    import torch

    def key(x):  # float32 bits as integers ordered like the values
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    return int((key(a) - key(b)).abs().max()) if a.numel() else 0


def k5_check(dev, gpu, steps=3, seed=7):
    """K5 against the plain route (``optim_cuda.takes`` refusing every
    tensor) on the OMNIISEG cell's parameter list
    (``benchmark/configs/omniiseg-n3k3-480.json``: 189 tensors), for Adagrad
    and Adam: the same ``steps`` gradients (the first tensor's missing in
    the second step) through the config's schedule, the parameters and the
    state compared bit for bit (Adagrad within 2 ulp, where rsqrtf would
    differ), each step's counters (one launch, every tensor on K5). Then
    each route's step timed: K5's launches of a step on the card alone
    (``device_ms``, packed once), a K5 step between CUDA events and its host
    enqueue, the plain route's the same. → the kernels line's record
    (Adagrad's, the train cells' rule)."""
    import time

    import torch

    from fgn_torch.models.fgn import build_model
    from fgn_torch.ops import optim_cuda
    from fgn_torch.train.optim import FGNOptimizer, make_lr_schedule

    model = build_model(bench_cfg("omniiseg-n3k3-480"), dev, seed=0)
    named = [(n, p.detach()) for n, p in model.named_parameters()]
    del model
    gen = torch.Generator(device=dev).manual_seed(seed)
    grads = [[torch.randn(p.shape, generator=gen, device=dev) * 0.01
              for _, p in named] for _ in range(steps)]
    grads[1][0] = None
    n_par = sum(p.numel() for _, p in named)
    T = len(named)
    refuse = lambda *a: False  # noqa: E731 — the plain route everywhere
    recs = {}
    for kind in ("adagrad", "adam"):
        runs = {}
        for route in ("plain", "k5"):
            params = [(n, p.clone().requires_grad_()) for n, p in named]
            opt = FGNOptimizer(params, optimizer=kind,
                               schedule=make_lr_schedule(
                                   5e-3, steps_per_epoch=1000))
            ps = [p for _, p in params]
            with contextlib.ExitStack() as stack:
                if route == "plain":
                    stack.enter_context(
                        mock.patch.object(optim_cuda, "takes", refuse))
                for s in range(steps):
                    for p, g in zip(ps, grads[s]):
                        p.grad = g
                    zero_counts()
                    opt.step()
                    c = k5_counts()
                    want = ({"k5.launches": 1, "k5.tensors": T,
                             "opt.plain_tensors": 0} if route == "k5" else
                            {"k5.launches": 0, "k5.tensors": 0,
                             "opt.plain_tensors": T})
                    check(c == want, f"K5 {kind} {route} step {s}: counters "
                                     f"{c}, want {want}")
                torch.cuda.synchronize()
                runs[route] = ps, opt
        (pa, oa), (pb, ob) = runs["plain"], runs["k5"]
        pairs = [(a, b) for a, b in zip(pa, pb)]
        pairs += [(oa.state[a][k], ob.state[b][k]) for a, b in zip(pa, pb)
                  for k in oa.state[a] if isinstance(oa.state[a][k],
                                                     torch.Tensor)]
        unequal = sum(not torch.equal(a, b) for a, b in pairs)
        gap = max(ulps(a, b) for a, b in pairs)
        err = max(float((a - b).abs().max()) for a, b in pairs if a.numel())
        check(oa.state["count"] == ob.state["count"] == steps,
              f"K5 {kind}: counts {oa.state['count']}, {ob.state['count']}")
        check(all(oa.state[a].get("t") == ob.state[b].get("t")
                  for a, b in zip(pa, pb)), f"K5 {kind}: step counts differ")
        check(unequal == 0 or (kind == "adagrad" and gap <= 2),
              f"K5 {kind}: {unequal} of {len(pairs)} tensors differ from the "
              f"plain route, by up to {gap} ulp")

        # timing: both routes carry on from their state, same gradients
        def host_ms(opt, n=10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                opt.step()
            ms = (time.perf_counter() - t0) * 1e3 / n
            torch.cuda.synchronize()
            return ms

        # the kernel alone: one step's launches again, packed once
        packed = []
        real_run = optim_cuda.run
        with mock.patch.object(optim_cuda, "run",
                               lambda *a: (packed.append(a), real_run(*a))):
            ob.step()
        k5_ms = device_ms(lambda: real_run(*packed[0]), n=20, iters=5)
        k5_host = host_ms(ob)
        k5_wall = cuda_ms(ob.step, iters=5)
        with mock.patch.object(optim_cuda, "takes", refuse):
            plain_ms = cuda_ms(oa.step, iters=5)
            plain_host = host_ms(oa, n=3)
        bound = n_par * K5_BYTES[kind] / HBM_BYTES_S * 1e3
        print(f"K5 {kind}: {T} tensors, {n_par} parameters, {steps} steps "
              f"(a gradient missing in one): bit-exact {unequal == 0} "
              f"({unequal} of {len(pairs)} tensors differ, largest gap "
              f"{gap} ulp, {err:.3g} absolute); a step: its launches on the "
              f"card {k5_ms:.4f} ms, bound {bound:.4f} ms (bytes, "
              f"{K5_BYTES[kind]} a parameter), "
              f"between events {k5_wall:.4f} ms, host enqueue {k5_host:.4f} "
              f"ms; plain route between events {plain_ms:.3f} ms, host "
              f"enqueue {plain_host:.3f} ms; on {gpu}", flush=True)
        recs[kind] = dict(max_abs_err=err, max_ulp=gap, ms=k5_ms,
                          plain_ms=plain_ms, bound_ms=bound)
        del runs, pa, pb, oa, ob, pairs
        torch.cuda.empty_cache()
    return dict(recs["adagrad"], name="optim", route="cuda",
                source="fgn_torch/csrc/optim.cu",
                replaces="none (XLA fuses optax's chain)",
                path=f"the OMNIISEG cell's {T} tensors, Adagrad, a step",
                bound_by="bytes")


def capture_train_calls(step, batch, gen):
    """The arguments of every kernel call of one more train step, in order:
    (K1 forward [(args, kwargs)], K1-bwd [(args, kwargs)], K2 [("nms_keep",
    args, kwargs)]). The kernels run, and count their launches, as usual."""
    import fgn_torch.models.fgn as fgn_mod
    import fgn_torch.ops.roi_align_cuda as rac

    calls, fwd_calls, nms_calls = [], [], []
    real, real_fwd = rac.roi_align_backward_cuda, fgn_mod.roi_align_cuda
    real_nms = fgn_mod.greedy_alive_cuda

    def recorder(*a, **k):
        calls.append((a, k))
        return real(*a, **k)

    def fwd_recorder(fmap, *a, **k):
        fwd_calls.append(((fmap.detach(),) + a, k))
        return real_fwd(fmap, *a, **k)

    def nms_recorder(*a, **k):
        nms_calls.append(("nms_keep", a, k))
        return real_nms(*a, **k)

    with mock.patch.object(rac, "roi_align_backward_cuda", recorder), \
            mock.patch.object(fgn_mod, "roi_align_cuda", fwd_recorder), \
            mock.patch.object(fgn_mod, "greedy_alive_cuda", nms_recorder):
        step(batch, gen)
    return fwd_calls, calls, nms_calls


def step_split(step, batch, gen, iters=3):
    """The train step's time on the card's clock, split at the program's
    spans ``forward`` (train_forward), ``backward`` (with the gradients'
    sum) and ``optimizer`` (zero_grad and the step): each span's CUDA
    events, recorded under a device-only profiler. → {part: median ms}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fgn_torch.utils import profiling

    parts = {"train_forward": "step/forward", "backward": "step/backward",
             "optimizer step": "step/optimizer"}
    marks = {k: [] for k in parts}
    for _ in range(iters):
        profiling.reset()
        with profile(activities=[ProfilerActivity.CUDA]):
            step(batch, gen)
        spans = profiling.summary("step")["spans"]
        for k, p in parts.items():
            marks[k].append(spans[p]["stream_ms"])
    torch.cuda.synchronize()
    return {k: statistics.median(v) for k, v in marks.items()}


def k1bwd_sweep(a, k):
    """K1-bwd's staged kernel at one call with other channel tiles and block
    sizes than its rule picks (``--profile`` only): time on the card
    (``device_ms``) for each tile that fits, to show where the rule's choice
    stands."""
    import fgn_torch.ops.roi_align_cuda as rac

    g, rois, H, W = a[:4]
    B, R, O, _, C = g.shape
    esize = g.element_size()
    rule = (rac._bwd_channel_tile(H, W, C, g.dtype, R, O), rac._bwd_threads(H))
    res = []
    for tile in (8, 16, 32, 64):
        if rac._bwd_smem(H, W, tile, esize, R, O) > rac._SMEM_MAX:
            continue
        for threads in sorted({256, 512, 1024, rule[1]}):
            with mock.patch.object(rac, "_bwd_channel_tile",
                                   lambda *_a, **_k: tile), \
                    mock.patch.object(rac, "_bwd_threads",
                                      lambda *_a, **_k: threads):
                ms = device_ms(lambda: rac.roi_align_backward_cuda(*a, **k))
            res.append(f"{tile}/{threads} {ms:.4f}")
    print(f"K1-bwd staged sweep at g {tuple(g.shape)} {str(g.dtype)[6:]} -> "
          f"map {H}x{W}: ms on the card by channel tile/threads a block (the "
          f"rule picks {rule[0]}/{rule[1]}): " + ", ".join(res), flush=True)


def backward_record(calls, iters=20, where="train-path"):
    """K1-bwd at the train path's own inputs: the staged kernel (which the
    call must take, the same bits at two launches) and the atomics kernel,
    each held against the plain version; both timed in turns, staged,
    atomics, atomics, staged, over runs of ``reps`` launches (CUDA events),
    and on the card alone (``device_ms``), beside the plain version and the
    bound. → the record of the largest call."""
    import torch

    from fgn_torch.ops.roi_align_cuda import (
        _roi_align_plain_bwd, _roi_weights, roi_align_backward_cuda,
    )

    rec = None
    for i, (a, k) in enumerate(calls):
        g, rois, H, W = a[:4]
        rest = a[4:]
        got, design = k1bwd_landed(*a, **k)
        check(design == "staged", f"K1-bwd {where} call {i} took the "
                                  f"{design} kernel")
        check(torch.equal(got, roi_align_backward_cuda(*a, **k)),
              f"K1-bwd {where} call {i}: two launches differ")
        old = k1bwd_atomic(*a, **k)
        with strict_f32():
            ref = _roi_align_plain_bwd(g.float(), rois, H, W, torch.float32,
                                       *rest, **k)
        err = float((got.float() - ref).abs().max())
        err_old = float((old.float() - ref).abs().max())
        bound = 2 * 2.0 ** -8 * float(ref.abs().max())
        check(err <= bound, f"K1-bwd {where} call {i}: {err} > 2 ulp {bound}")
        check(err_old <= bound, f"K1-bwd atomics, {where} call {i}: "
                                f"{err_old} > 2 ulp {bound}")
        reps = 10

        def run(fn):
            return lambda: [fn(*a, **k) for _ in range(reps)]

        times = [cuda_ms(run(fn), iters) / reps for fn in (
            roi_align_backward_cuda, k1bwd_atomic, k1bwd_atomic,
            roi_align_backward_cuda)]
        ms, earlier_ms = (times[0] + times[3]) / 2, (times[1] + times[2]) / 2
        dev_ms, dev_old = (device_ms(lambda: fn(*a, **k))
                           for fn in (roi_align_backward_cuda, k1bwd_atomic))
        plain_ms = cuda_ms(
            lambda: _roi_align_plain_bwd(g, rois, H, W, g.dtype, *rest, **k),
            3, warmup=1)
        # the function's inputs read once (g, rois), its output written once
        # (df in the map's dtype); 16 corner weights, a multiply-add each,
        # per element of g
        nbytes = (g.numel() * g.element_size() + rois.numel() * 4
                  + got.numel() * got.element_size())
        ops = ROI_ALIGN_FLOPS * g.numel()
        t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / F32_FLOPS_S
        bound_ms = max(t_bytes, t_ops) * 1e3
        # The atomics kernel's adds on these inputs: per bin and channel, one
        # for each (row, column) pair with a nonzero weight.
        O, scale, S, aligned = rest
        wy, wx = _roi_weights(rois, H, W, O, scale, S, aligned)
        ny = (wy != 0).sum(-1).double().sum(-1)  # (B, R): Σ_i rows of bin i
        nx = (wx != 0).sum(-1).double().sum(-1)
        atomics = float((ny * nx).sum()) * g.shape[-1]
        print(f"roi_align_backward {where} call {i}: g {tuple(g.shape)} "
              f"{str(g.dtype)[6:]} -> map {H}x{W}: err {err:.3g} (atomics "
              f"{err_old:.3g}); staged {ms:.4f} ms ({times[0]:.4f}, "
              f"{times[3]:.4f}; on the card {dev_ms:.4f}), atomics "
              f"{earlier_ms:.4f} ms ({times[1]:.4f}, {times[2]:.4f}; on the "
              f"card {dev_old:.4f}; {atomics:.4g} atomic adds, "
              f"{atomics / (g.numel() or 1):.2f} per element of g), plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms "
              f"({'bytes' if t_bytes >= t_ops else 'operations'})", flush=True)
        if rec is None or g.numel() > rec["_size"]:
            rec = dict(
                name="roi_align_backward", route="cuda",
                source="fgn_torch/csrc/roi_align.cu",
                replaces="roi_align_pallas.py:146",
                max_abs_err=err, ms=ms, earlier_ms=earlier_ms,
                plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=None, _size=g.numel(), _args=(a, k),
            )
    rec.pop("_size")
    return rec


def phase_train_twin(dev, B=2):
    """train_forward + backward at f32 (TF32 off) through the kernels, twice,
    and through the plain versions, same weights, same generator seed:
    identical proposals, losses within 1e-5 relative, K1's forward within
    1e-5 of its output's scale at each of its calls, and each parameter's
    gradient within 1e-4 of its largest magnitude. Where the two kernel
    runs differ (an op of the step that sums in no fixed order; K1-bwd's
    staged kernel sums in one), the kernel-vs-plain difference may reach
    twice the largest kernel-vs-kernel difference. The forward's rounding is amplified most: a change in the
    last bits of RoIAlign's output flips the sign of a few inputs of the
    ReLUs after the relation head's GroupNorm and the mask head's convs
    (``twin_sensitivity.py`` shows where)."""
    import contextlib as cl

    import torch

    import fgn_torch.models.fgn as fgn_mod
    import fgn_torch.ops.roi_align_cuda as rac
    from fgn_torch.data.batching import to_device, toy_batch
    from fgn_torch.ops.nms import _greedy_alive
    from fgn_torch.train.train_step import total_loss

    model = fgn_mod.build_model(flagship_cfg(compute_dtype="float32"), dev,
                                seed=0)
    batch = to_device(toy_batch(B=B, H=480, W=480, N=3, K=3, S=128), dev)

    def plain_fwd(fmap, rois, *a):
        return rac._roi_align_plain(fmap, rois, *a)

    def plain_bwd(g, rois, H, W, *a):
        return rac._roi_align_plain_bwd(g, rois, H, W, g.dtype, *a)

    def run(plain):
        props, k1 = [], []
        real, real_fwd = model.get_proposals, rac._roi_align_forward

        def rec(*a, **k):
            out = real(*a, **k)
            props.append([t.clone() for t in out])
            return out

        def fwd_rec(*a):
            out = real_fwd(*a)
            k1.append((a, out.detach().clone()))
            return out

        with cl.ExitStack() as st:
            st.enter_context(strict_f32())
            st.enter_context(mock.patch.object(model, "get_proposals", rec))
            if plain:
                st.enter_context(mock.patch.object(rac, "_roi_align_forward",
                                                   plain_fwd))
                st.enter_context(mock.patch.object(
                    rac, "roi_align_backward_cuda", plain_bwd))
                st.enter_context(mock.patch.object(
                    fgn_mod, "greedy_alive_cuda", _greedy_alive))
            else:
                st.enter_context(mock.patch.object(rac, "_roi_align_forward",
                                                   fwd_rec))
            model.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            zero_counts()
            losses = model.train_forward(
                batch, torch.Generator(device=dev).manual_seed(0))
            total_loss(losses).backward()
            torch.cuda.synchronize()
            counts = read_counts()
        grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
                 if p.grad is not None}
        return ({k: float(v.detach()) for k, v in losses.items()}, grads,
                props[0], counts, k1)

    def rel(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    l1, g1, p1, c1, k1 = run(False)
    l2, g2, _, _, _ = run(False)
    lp, gp, pp, cp, _ = run(True)
    check(c1 == TRAIN_KERNELS, f"f32 train twin: kernel run launches {c1}")
    check(cp == {k: 0 for k in TRAIN_KERNELS},
          f"f32 train twin: plain run launched {cp}")
    for a, b in zip(p1, pp):
        check(torch.equal(a, b), "f32 train twin: proposals not identical")
    k1_err = []
    for i, (args, out) in enumerate(k1):
        with strict_f32(), torch.no_grad():
            k1_err.append(rel(out, rac._roi_align_plain(*args)))
        check(k1_err[-1] <= 1e-5, f"f32 train twin: K1 call {i} differs by "
                                  f"{k1_err[-1]:.3g} of its scale")
    for k in l1:
        if k.startswith("loss_"):
            check(abs(l1[k] - lp[k]) <= 1e-5 * max(abs(lp[k]), 1e-12),
                  f"f32 train twin: {k} {l1[k]} vs plain {lp[k]}")
    check(set(g1) == set(gp), "f32 train twin: different parameters have grads")

    noise = max(rel(g1[n], g2[n]) for n in gp)
    worst = sorted(((rel(g1[n], gp[n]), n) for n in gp), reverse=True)
    strict = sum(e <= 1e-4 for e, _ in worst)
    for e, n in worst:
        check(e <= max(1e-4, 2 * noise),
              f"f32 train twin: grad {n} differs by {e:.3g} of its scale "
              f"(kernel-vs-kernel noise {noise:.3g})")
    print(f"f32 train twin b{B}: proposals identical, losses within 1e-5 "
          f"({ {k: round(v, 6) for k, v in lp.items() if k.startswith('loss_')} }); "
          f"K1 forward vs plain " + ", ".join(f"{e:.3g}" for e in k1_err)
          + f" of scale; gradients: {strict}/{len(worst)} leaves within 1e-4 of scale, worst "
          f"{worst[0][0]:.3g} ({worst[0][1]}), kernel-vs-kernel noise "
          f"{noise:.3g}", flush=True)


class FrozenEpisodes:
    """The first ``n`` episodes of an episodic dataset, each drawn once
    after seeding Python's and numpy's global generators with its index,
    with the dataset's other attributes: two evaluator runs over it see the
    same episodes."""

    def __init__(self, ds, n):
        from fgn_torch.data.digests import draw_episodes

        self.ds, self.samples = ds, draw_episodes(ds, n)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]

    def __getattr__(self, name):
        return getattr(self.ds, name)


def phase_engine(dev, gpu, work, warmup=2, iters=5):
    """The system as a user runs it: the config file, the generated split,
    its episodes, then training. Loads ``configs/fgn_train_mnistiseg_n3k3.py``
    and its model config, holds the episode engine to the committed
    reference stage by stage (``digests.check_stages``, which also
    generates this host's MNISTISEG split into ``work`` and builds the
    config's train and eval datasets over it), then trains the config's
    model (R50-C4, GN, deep stem, avg-down, N3K3, bf16) at the config's
    batch with its optimizer (Adagrad, warmup, RoI head ×0.1) on the train
    dataset's episodes through ``EpisodeLoader``: ``warmup`` + ``iters``
    steps of epoch 0, the same ``iters`` batches again from host memory
    (no loader thread), and ``iters`` steps of epoch 1; each step timed
    with CUDA events, with the launch counters set to 0 just before it and
    read just after, and the host's wait for its batch; then one more step,
    not counted, on epoch 0's first batch with its kernel calls recorded.
    → (config, model config, eval dataset, the launches of epoch 0's timed
    steps, that step's K1 forward, K1-bwd and K2 calls, the generated split's
    directory, the median of epoch 0's timed steps on the host clock, from
    the wait for the batch to the synchronized step, in ms)."""
    import os

    import torch

    import fgn_torch
    from fgn_torch.data import digests as D
    from fgn_torch.data.batching import EpisodeLoader, from_numpy, to_device
    from fgn_torch.main import model_config_from_cfg, optimizer_from_cfg
    from fgn_torch.models.fgn import build_model
    from fgn_torch.train.train_step import make_train_step

    t0 = time.perf_counter()
    stages, ctx = D.check_stages(D.port_engine(),
                                 os.path.dirname(fgn_torch.__file__), work)
    check_s = time.perf_counter() - t0
    for name, st in stages.items():
        print(f"engine stage {name}: {st['items']} items, "
              f"{len(st['differ'])} differ, held {st['held']}; {st['note']}"
              + (f"; differing: {', '.join(st['differ'][:8])}"
                 + (" ..." if len(st['differ']) > 8 else "")
                 if st["differ"] else ""), flush=True)
        check(st["held"] is True, f"engine stage {name} not held")
    cfg = ctx.cfg
    mcfg = model_config_from_cfg(cfg)
    want = dict(backbone_norm="gn", deep_stem=True, avg_down=True,
                feat_channels=1024, n_ways=3, k_shots=3,
                compute_dtype="bfloat16")
    check(all(getattr(mcfg, k) == v for k, v in want.items()),
          f"engine: config's model {mcfg} is not {want}")
    train, val = ctx.train, ctx.val
    sec = ctx.seconds
    print(f"engine: config {D.CONFIG}; generated {D.QUANTITIES} MNISTISEG "
          f"images in {sec['generate']:.3f} s; train dataset (databag + "
          f"support bank) {sec['train_dataset']:.3f} s, {len(train)} "
          f"episodes; eval dataset {sec['eval_dataset']:.3f} s, {len(val)} "
          f"episodes; {2 * D.N_EPISODES} seeded episodes drawn in "
          f"{sec['episodes']:.3f} s; stage check {check_s:.1f} s "
          f"(host clock)", flush=True)

    bs = int(cfg.batch_size)
    model = build_model(mcfg, dev, seed=0)
    o = cfg.optimizer
    # the optimizer and its schedule as fgn_torch.main builds them
    opt = optimizer_from_cfg(cfg, model, max(len(train) // bs, 1))
    step = make_train_step(model, opt)
    gen = torch.Generator(device=dev).manual_seed(0)
    builds = []

    def stream(epoch):
        """The loader's batches of an epoch; each build on the prefetch
        thread timed."""
        train.reshuffle(epoch)
        loader = EpisodeLoader(train, bs, max_gt=int(cfg.max_gt))
        check(len(loader) >= warmup + iters,
              f"engine: {len(loader)} train batches, want {warmup + iters}")
        build = loader._build

        def timed_build(indices):
            t = time.perf_counter()
            out = build(indices)
            builds.append((len(indices), time.perf_counter() - t))
            return out

        loader._build = timed_build
        return iter(loader)

    def run(batches, n, what):
        """n train steps over ``batches``: per step its time (CUDA events),
        the host's wait for the batch and its upload (host clock), the
        losses; the launches checked per step. → (rows, the host batches,
        the launches summed)."""
        rows, kept, total = [], [], {}
        for i in range(n):
            t = t_host = time.perf_counter()
            batch, _ = next(batches)
            wait = time.perf_counter() - t
            t = time.perf_counter()
            b = to_device(from_numpy(**batch._asdict()), dev)
            torch.cuda.synchronize()
            h2d = time.perf_counter() - t
            zero_counts()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            metrics = step(b, gen)
            end.record()
            end.synchronize()
            host = time.perf_counter() - t_host
            counts = read_counts()
            check(counts == TRAIN_KERNELS, f"engine train, {what}, step {i}: "
                                           f"launches {counts}, want "
                                           f"{TRAIN_KERNELS}")
            losses = {k: float(v) for k, v in metrics.items()
                      if k.startswith("loss_")}
            check(all(math.isfinite(v) for v in losses.values()),
                  f"engine train, {what}, step {i}: losses {losses}")
            rows.append((start.elapsed_time(end), wait * 1e3, h2d * 1e3,
                         losses, host * 1e3))
            kept.append((batch, None))
            total = {k: total.get(k, 0) + v for k, v in counts.items()}
            print(f"engine train, {what}, step {i}: "
                  f"{rows[-1][0]:.3f} ms (CUDA events), batch wait "
                  f"{wait * 1e3:.3f} ms, H2D {h2d * 1e3:.3f} ms, batch to "
                  f"synchronized step {host * 1e3:.3f} ms (host clock); "
                  f"losses { {k: round(v, 4) for k, v in losses.items()} }",
                  flush=True)
        return rows, kept, total

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # epoch 0 from the loader, its prefetch thread building the next
    # batches while the steps run; the same batches again from host memory
    # (no thread); then epoch 1 from a fresh loader
    it = stream(0)
    run(it, warmup, "warm-up")
    rows, kept, total = run(it, iters, "epoch 0 from the loader")
    it.close()
    mem, _, _ = run(iter(kept), iters, "the same batches from memory")
    it = stream(1)
    rows1, _, _ = run(it, iters, "epoch 1 from the loader")
    it.close()
    peak = torch.cuda.max_memory_allocated()
    calls = capture_train_calls(
        step, to_device(from_numpy(**kept[0][0]._asdict()), dev), gen)
    n_eps = sum(n for n, _ in builds)
    build_s = sum(t for _, t in builds)

    def med(rs, k=0):
        return statistics.median(r[k] for r in rs)

    print(f"engine train: b{bs} 480x480 N3K3 S128 bf16 {o.type} lr {o.lr}: "
          f"step median {med(rows):.3f} ms from the loader (batch wait "
          f"median {med(rows, 1):.3f} ms), {med(mem):.3f} ms from memory, "
          f"{med(rows1):.3f} ms from the loader in epoch 1 (batch wait "
          f"median {med(rows1, 1):.3f} ms; n={iters} each); on the host "
          f"clock, from the wait for the batch to the synchronized step, "
          f"{med(rows, 4):.3f} ms from the loader; launches per step "
          f"{TRAIN_KERNELS}; peak memory {peak / 2**30:.2f} GiB; episode "
          f"construction on the prefetch thread: {n_eps} episodes in "
          f"{len(builds)} batches, {build_s:.3f} s = "
          f"{n_eps / build_s:.2f} episodes/s (collation included); on {gpu}",
          flush=True)
    del model, opt, step, it, kept
    torch.cuda.empty_cache()
    return cfg, mcfg, val, total, calls, ctx.raw, med(rows, 4)


class CountedStep:
    """An eval step that records, per call, the kernel launches it made and
    CUDA events around it (the step's span on the card's clock), and, when
    ``keep`` is set, a host copy of its unpacked outputs."""

    def __init__(self, step, keep=False):
        self.step, self.keep = step, keep
        self.reset()

    def reset(self):
        self.counts, self.events, self.outs = [], [], []

    def __call__(self, batch):
        import torch

        from fgn_torch.train.train_step import unpack_eval_out

        before = read_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.step(batch)
        end.record()
        self.events.append((start, end))
        self.counts.append({k: v - before[k] for k, v in read_counts().items()})
        if self.keep:
            self.outs.append({k: v.cpu() for k, v in
                              unpack_eval_out(dict(out)).items()})
        return out

    def device_s(self):
        """Σ of the steps' spans on the card's clock, in seconds."""
        return sum(s.elapsed_time(e) for s, e in self.events) / 1e3


def read_results(ev):
    """The per-episode results of the evaluator's last pass, from its
    pickle chunks, in order."""
    import os

    from fgn_torch.utils.io import read_pkl

    d = ev.results_dir()
    return [r for fn in sorted(os.listdir(d))
            for r in read_pkl(os.path.join(d, fn))]


def eval_pass(ev, step, run, n_episodes, what, counted=True):
    """One eval pass; every batch must launch K1 3 and K2 2 times through
    their staged kernels. With ``counted`` the launch counters are set to 0
    just before it and read just after; without, they are left alone (a
    pass inside a run whose counts are read at its end). → (metrics, counts
    of the pass or None)."""
    import torch

    step.reset()
    torch.cuda.synchronize()
    if counted:
        zero_counts()
    t0 = time.perf_counter()
    metrics = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    t = ev.last_times
    n_b = t["batches"]
    check(n_b == len(step.counts) == -(-n_episodes // ev.batch_size),
          f"eval {what}: {n_b} batches, {len(step.counts)} steps")
    for i, c in enumerate(step.counts):
        check(c == SERVE_KERNELS, f"eval {what} batch {i}: launches {c}, "
                                  f"want {SERVE_KERNELS}")
    counts = None
    if counted:
        counts = read_counts()
        check(counts == {k: v * n_b for k, v in SERVE_KERNELS.items()},
              f"eval {what}: launches {counts} over {n_b} batches")
    for k, v in metrics.items():
        check(0.0 <= v <= 1.0, f"eval {what}: {k} = {v}")
    print(f"eval pass {what}: {n_episodes} episodes, {n_b} batches of "
          f"{ev.batch_size} in {wall:.3f} s = {n_episodes / wall:.2f} "
          f"episodes/s; device steps {step.device_s():.3f} s (CUDA events), "
          f"fetch wait {t['fetch']:.3f} s, host paste+RLE {t['host']:.3f} s, "
          f"FSISEGEval {t['eval']:.3f} s, loop {t['loop']:.3f} s; synchronized "
          f"batches 1-3: step {t['sync_step']:.3f} s, fetch "
          f"{t['sync_fetch']:.3f} s; launches "
          f"{counts if counted else 'read with the run'}; metrics "
          f"{ {k.split('/')[1]: v for k, v in metrics.items()} }", flush=True)
    return metrics, counts


def phase_eval(dev, gpu, ds, mcfg, B=8, pad_hw=(480, 480), twin_n=16,
               min_episodes=60):
    """Episodic evaluation (``Evaluator.run``) of the model of ``mcfg``
    (seeded weights) over every episode of the eval dataset ``ds`` at batch
    B: three passes (stream and cache, cached, ``run_fresh``), each timed and
    split, with K1 ×3 and K2 ×2 per batch; pass 1 renders one episode
    (``ds.visualize_result``, best-effort in the evaluator; the PNG must
    exist); pass 2's metrics equal pass 1's; pass 2's pickled detections
    equal, bit for bit, a plain loop of the same step over the cached
    batches synchronized after each; then an f32 twin over the first
    ``twin_n`` episodes (TF32 off) through the kernels and through the
    plain versions. → (the launch counts of pass 1, the kernel calls of the
    eval step on pass 1's first batch, recorded on one more step that is not
    counted)."""
    import os
    import tempfile

    import numpy as np
    import torch

    from fgn_torch.data import rle as RLE
    from fgn_torch.data.batching import from_numpy, to_device
    from fgn_torch.models.fgn import build_model
    from fgn_torch.ops.boxes import xyxy_to_yxyx
    from fgn_torch.train.evaluator import Evaluator
    from fgn_torch.train.train_step import make_eval_step, unpack_eval_out_np

    check(RLE.backend() == "native", f"RLE backend {RLE.backend()}, want "
                                     f"native")
    n = len(ds)
    check(n >= min_episodes, f"eval: {n} episodes, want {min_episodes}")
    model = build_model(mcfg, dev, seed=0)
    raw = make_eval_step(model)
    step = CountedStep(raw)
    with tempfile.TemporaryDirectory() as work:
        ev = Evaluator(model, ds, batch_size=B, eval_step=step, work_dir=work,
                       pad_hw=pad_hw, max_gt=30, n_plots=1,
                       mask_thr=mcfg.mask_thr)
        m1, counts = eval_pass(ev, step, ev.run, n, "1 (stream and cache)")
        png = os.path.join(work, "eval_vis", "Result 000.png")
        png_bytes = os.path.getsize(png) if os.path.isfile(png) else 0
        check(png_bytes > 0, f"eval: no render at {png}")
        ev.n_plots = 0
        m2, _ = eval_pass(ev, step, ev.run, n, "2 (cached)")
        res2 = read_results(ev)
        eval_pass(ev, step, ev.run_fresh, n, "3 (run_fresh)")
    check(m2 == m1, f"eval: pass 2 metrics {m2} differ from pass 1's {m1}")
    check(ev._episode_cache[-1][1].n_real == n - B * (len(ev._episode_cache) - 1),
          "eval: last batch n_real")
    calls = capture_kernel_args(model, to_device(
        from_numpy(**ev._episode_cache[0][0]._asdict()), dev))

    # the double-buffered pass against a synchronized loop, bit for bit
    i = n_dt = 0
    for batch, meta in ev._episode_cache:
        out = raw(to_device(from_numpy(**batch._asdict()), dev))
        torch.cuda.synchronize()
        out = unpack_eval_out_np({k: v.cpu().numpy() for k, v in out.items()})
        for b in range(meta.n_real):
            r, valid = res2[i], out["dt_valid"][b]
            h, w = (int(v) for v in batch.img_hw[b])
            boxes = out["dt_boxes"][b][valid]
            probs = 1.0 / (1.0 + np.exp(-out["dt_mask_logits"][b][valid]))
            same = (r["idx"] == int(meta.idx[b])
                    and np.array_equal(r["dt_scores"], out["dt_scores"][b][valid])
                    and np.array_equal(r["dt_bboxes"], xyxy_to_yxyx(boxes))
                    and np.array_equal(r["dt_cat_ids"], out["dt_cats"][b][valid])
                    and r["dt_isegmaps_rle"] == RLE.paste_encode_results(
                        probs, boxes, h, w, ev.mask_thr))
            check(same, f"eval: episode {i} of pass 2 differs from the "
                        f"synchronized loop")
            n_dt += int(valid.sum())
            i += 1
    check(i == n == len(res2), f"eval: {i} episodes checked, {len(res2)} "
                               f"pickled")
    print(f"eval: pass 2's {n} episodes ({n_dt} detections) bit-identical to "
          f"a synchronized loop over the cached batches; pass 2 metrics equal "
          f"pass 1's; on {gpu}", flush=True)
    print(f"eval: pass 1 rendered episode 0 (visualize_result) into a "
          f"{png_bytes}-byte PNG", flush=True)
    del model, ev, raw, step
    torch.cuda.empty_cache()
    phase_eval_twin(dev, FrozenEpisodes(ds, twin_n), mcfg, B, pad_hw)
    return counts, calls


def phase_eval_twin(dev, ds, mcfg, B, pad_hw):
    """The evaluator at f32 (TF32 off) over the episodes of ``ds`` through
    the kernels and through the plain versions, same weights, same
    episodes: per episode the same valid detections and categories; boxes,
    scores and mask logits within ``phase_plain_twin``'s tolerances; the
    four metrics within 1e-4."""
    import tempfile

    import fgn_torch.models.fgn as fgn_mod
    from fgn_torch.ops.nms import _greedy_alive
    from fgn_torch.ops.roi_align_cuda import _roi_align_plain
    from fgn_torch.train.evaluator import Evaluator
    from fgn_torch.train.train_step import make_eval_step

    model = fgn_mod.build_model(
        dataclasses.replace(mcfg, compute_dtype="float32"), dev, seed=0)
    n = len(ds)
    runs = []
    for plain in (False, True):
        step = CountedStep(make_eval_step(model), keep=True)
        with tempfile.TemporaryDirectory() as work, strict_f32(), \
                contextlib.ExitStack() as st:
            if plain:
                st.enter_context(mock.patch.object(
                    fgn_mod, "roi_align_cuda", _roi_align_plain))
                st.enter_context(mock.patch.object(
                    fgn_mod, "greedy_alive_cuda", _greedy_alive))
            ev = Evaluator(model, ds, batch_size=B, eval_step=step,
                           work_dir=work, pad_hw=pad_hw, max_gt=30, n_plots=0,
                           mask_thr=mcfg.mask_thr)
            zero_counts()
            metrics = ev.run()
            counts = read_counts()
            runs.append((metrics, read_results(ev), step.outs, counts))
    (mk, rk, ok, ck), (mp, rp, op, cp) = runs
    n_b = -(-n // B)
    check(ck == {k: v * n_b for k, v in SERVE_KERNELS.items()},
          f"eval twin: kernel run launches {ck}")
    check(cp == {k: 0 for k in SERVE_KERNELS},
          f"eval twin: plain run launched {cp}")
    n_dt = 0
    for i, (a, b) in enumerate(zip(rk, rp)):
        check(len(a["dt_scores"]) == len(b["dt_scores"])
              and sorted(a["dt_cat_ids"].tolist())
              == sorted(b["dt_cat_ids"].tolist()),
              f"eval twin: episode {i}: valid detections or categories differ")
        n_dt += len(a["dt_scores"])
    mask_scale = max(float(o["dt_mask_logits"].abs().max()) for o in op)
    for a, b in zip(ok, op):
        match_detections(a, b, tol_box=1e-2, tol_score=1e-4,
                         tol_mask=1e-3 * max(mask_scale, 1.0))
    for k in mp:
        check(abs(mk[k] - mp[k]) <= 1e-4,
              f"eval twin: {k} {mk[k]} vs plain {mp[k]}")
    print(f"eval twin f32, {n} episodes: {n_dt} detections match the plain "
          f"versions' (boxes 1e-2 px, scores 1e-4, mask logits 1e-3 x "
          f"{mask_scale:.3g}); metrics kernels "
          f"{ {k.split('/')[1]: round(v, 6) for k, v in mk.items()} }, plain "
          f"{ {k.split('/')[1]: round(v, 6) for k, v in mp.items()} }",
          flush=True)


def write_config(fp, base, overrides):
    """A config file at ``fp`` whose ``_base_`` is ``base`` and whose keys
    are ``overrides`` (dicts merge into the base's, as ``_base_`` does);
    each override printed."""
    with open(fp, "w") as f:
        f.write(f"_base_ = [{base!r}]\n")
        for k, v in overrides.items():
            f.write(f"{k} = {v!r}\n")
            print(f"runner config {fp}: {k} = {v!r}", flush=True)
    return fp


class Tee:
    """Standard output that is also kept: the Runner's log lines."""

    def __init__(self, out):
        import io

        self.out, self.buf = out, io.StringIO()

    def write(self, s):
        self.buf.write(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


RUNNER_LINE = ("Resumed from", "ckpt scheduled", " eval: ", "planned restart",
               "Initialized from", "Skipping completed", "=== FT grid",
               "tensorboard:", "WARNING", "Error", "Traceback")


def run_cli(what, args, want_rc, env=None, timeout=600, cwd=None):
    """``python -m <args>`` in a subprocess, from the repo's root or from
    ``cwd`` (the repo then on its ``PYTHONPATH``); its exit code must be
    ``want_rc``. Prints the wall time, the exit code and the Runner's log
    lines. → its standard output."""
    import os

    repo = os.path.dirname(os.path.abspath(__file__))
    if cwd is not None:
        env = dict(env or os.environ, PYTHONPATH=repo)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m"] + args, cwd=cwd or repo, env=env,
        capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        if any(k in line for k in RUNNER_LINE):
            print(f"runner {what} | {line[:400]}", flush=True)
    print(f"runner {what}: python -m {' '.join(args[:2])} ... exited "
          f"{proc.returncode} in {wall:.3f} s (host clock, process start "
          f"included)", flush=True)
    if proc.returncode != want_rc or "Traceback" in proc.stderr:
        print(proc.stderr[-4000:], file=sys.stderr, flush=True)
    check(proc.returncode == want_rc,
          f"runner {what}: exit code {proc.returncode}, want {want_rc}")
    check_clean(proc.stdout + proc.stderr, what)
    return proc.stdout


def check_clean(text, what):
    """No exception was caught and reported: the Runner soft-fails a save
    or an eval pass, and the evaluator its render, with a traceback."""
    for bad in ("Traceback", "WARNING: checkpoint save failed",
                "WARNING: evaluation failed", "WARNING: fresh-support eval",
                "rendering failed"):
        check(bad not in text, f"runner {what}: '{bad}' in its output")


def eval_metrics(out):
    """The metrics dicts the Runner printed: [(step or 'fresh', {tag:
    value})] in order; each value parsed from its repr."""
    import re

    found = []
    for line in out.splitlines():
        m = re.search(r"step (\d+) eval: (\{.*\})$", line)
        f = re.search(r"final fresh-support eval: (\{.*\})$", line)
        if not (m or f):
            continue
        body = m.group(2) if m else f.group(1)
        vals = {k: float(v) for k, v in re.findall(
            r"'([^']+)': (?:np\.float\d+\()?([-+0-9.eEna]+)\)?", body)}
        found.append((int(m.group(1)) if m else "fresh", vals))
    return found


def check_metrics(found, what, n_tags):
    for where, vals in found:
        check(len(vals) == n_tags and all(
            math.isfinite(v) and 0.0 <= v <= 1.0 for v in vals.values()),
            f"runner {what}: metrics at {where}: {vals}")


def ckpt_bytes(mgr, step):
    """Bytes of the files of checkpoint ``step`` and of its sidecar."""
    import os

    path = os.path.join(mgr.dir, str(step))
    side = os.path.join(mgr.dir, f"ds_state_{step}.json")
    return (sum(os.path.getsize(os.path.join(path, f))
                for f in os.listdir(path)),
            os.path.getsize(side) if os.path.isfile(side) else 0)


def recording_runner(runners):
    """A ``Runner`` that records, through its public methods and the
    callables it was given: the host-clock time at which each train step
    is called, each save's and each eval pass's host-clock time, the steps
    of its checks, the train and eval steps it called, and its first train
    batch and first eval batch (on the card). Each instance is appended to
    ``runners``."""
    from fgn_torch.train.loop import Runner

    class Recorded(Runner):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.entries, self.saves, self.checks = {}, [], []
            self.eval_s, self.n_eval, self.first = [], 0, {}
            self.raw_step, step = self.train_step, self.train_step

            def train_step(batch, generator=None):
                self.entries[self.step] = time.perf_counter()
                self.first.setdefault("train", batch)
                return step(batch, generator=generator)

            self.train_step = train_step
            for ev in self.evaluators:
                ev.eval_step = self._counted(ev.eval_step)
                ev.run = self._timed(ev.run)
            runners.append(self)

        def _counted(self, eval_step):
            def counted(batch):
                self.n_eval += 1
                self.first.setdefault("eval", batch)
                return eval_step(batch)
            return counted

        def _timed(self, run):
            def timed():
                t0 = time.perf_counter()
                out = run()
                self.eval_s.append(time.perf_counter() - t0)
                return out
            return timed

        def save_ckpt(self, epoch=None, cursor=0):
            t0 = time.perf_counter()
            super().save_ckpt(epoch=epoch, cursor=cursor)
            self.saves.append((self.step, time.perf_counter() - t0))

        def check(self, epoch=None, cursor=0):
            n = len(self.eval_s)
            super().check(epoch=epoch, cursor=cursor)
            self.checks.append((self.step, self.eval_s[n:]))

        def step_periods(self):
            """Host-clock ms from one train step's call to the next's, for
            the steps with no check between them: each covers the step,
            its loss read (a log line every step) and the next batch's
            wait and upload."""
            checked = {s for s, _ in self.checks}
            return [(self.entries[s + 1] - self.entries[s]) * 1e3
                    for s in sorted(self.entries)
                    if s + 1 in self.entries and s + 1 not in checked]

    return Recorded


def run_in_process(what, fn):
    """``fn()`` with its standard output and error kept (and shown), the
    launch counters set to 0 just before it and read just after. → (its
    result, its output, the counts, its host-clock seconds)."""
    import torch

    tee, tee_err = Tee(sys.stdout), Tee(sys.stderr)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee), contextlib.redirect_stderr(tee_err):
        result = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    out = tee.buf.getvalue()
    check_clean(out + tee_err.buf.getvalue(), what)
    return result, out, counts, wall


def check_runner_counts(r, counts, what, train=TRAIN_KERNELS):
    """The launches of a Runner's run: each train step ``train``'s (K1 ×2,
    K1-bwd ×2, K2 ×1, all through the staged kernels, by default) and each
    eval batch K1 ×3, K2 ×2 through the staged kernels. → (train steps, eval
    batches)."""
    steps, n_eval = len(r.entries), r.n_eval
    want = {k: train[k] * steps + SERVE_KERNELS[k] * n_eval for k in train}
    check(counts == want
          and counts["roi_align_backward"] == train["roi_align_backward"] * steps,
          f"runner {what}: launches {counts}, want {want} ({steps} steps, "
          f"{n_eval} eval batches)")
    return steps, n_eval


def print_checks(r, mgr, what):
    """Each check's save (host clock; its bytes when the step is still
    kept) and eval passes, in the order they ran. Every check saves once."""
    check(len(r.saves) == len(r.checks),
          f"runner {what}: {len(r.saves)} saves, {len(r.checks)} checks")
    kept, seen = set(mgr.all_steps()), set()
    for (s, evs), (_, secs) in zip(r.checks, r.saves):
        note = ("skipped: step already saved, sidecar written" if s in seen
                else f"{ckpt_bytes(mgr, s)[0]} bytes" if s in kept
                else "evicted")
        seen.add(s)
        print(f"runner {what} check at step {s}: save {secs * 1e3:.3f} ms "
              f"({note}), eval {', '.join(f'{e:.3f} s' for e in evs)} (host "
              f"clock)", flush=True)


def phase_runner(dev, gpu, work, raw, engine_step_ms):
    """The run loop as a user drives it, at the full width of
    ``configs/fgn_train_mnistiseg_n3k3.py`` (R50-C4, GN, deep stem,
    avg-down, N3K3, bf16, b8 Adagrad) on the split ``phase_engine``
    generated (``raw``), from a derived config file (data roots, work_dir,
    2 epochs, a check every 5 steps, a log line every step):

      * run A, ``python -m fgn_torch.main <cfg>`` with ``FGN_MAX_RSS_GB``
        below the process's RSS: exits 42 at the first check (step 5),
        leaving a checkpoint at step 5 (epoch 0, cursor 5, the sidecar's
        order epoch 0's);
      * run B, ``fgn_torch.main.main(cfg)`` in this process with the launch
        counters set to 0 just before and read just after: resumes at step
        5, ends at step 2 x steps_per_epoch, finite metrics at every check
        and in the fresh pass, K1 x2, K1-bwd x2, K2 x1 a step and K1 x3, K2
        x2 an eval batch. Its checks at steps 10 and 20 fall on an epoch's
        last step: the mid-epoch save stands and the end-of-epoch save is
        skipped, as in the JAX package, so the last checkpoint records
        (epoch 1, cursor 10);
      * run C, ``fgn_torch.main_ft.run_grid(<derived fgn_ft_mnistiseg.py>,
        gammas=(0.1,), nks=((3, 3),))`` in this process from run B's
        checkpoints, counted as run B: initializes from step 20, trains one
        epoch at b4 Adam with two FT=Use evaluators at b4, writes FT_DONE;
        its first train batch and first eval batch then go through one
        more train step and one more forward, not counted, whose K1, K1-bwd
        and K2 calls are held against the plain versions (``ft-train``,
        ``ft-eval`` lines); ``python -m fgn_torch.main_ft`` on the same
        file then skips the cell.

    → (the launch counts of run B, those of run C)."""
    import os
    from unittest import mock

    import torch

    import fgn_torch
    from fgn_torch import main as main_mod
    from fgn_torch import main_ft
    from fgn_torch.config import Config
    from fgn_torch.data.fst_bindings import init_ds_class_by_config
    from fgn_torch.train.checkpoints import CheckpointManager

    configs = os.path.join(os.path.dirname(fgn_torch.__file__), "configs")
    d = os.path.join(work, "runner")
    os.makedirs(d)
    roots = dict(inner_root=raw, root=os.path.join(d, "fst"))
    stage1 = os.path.join(d, "stage1")
    cfg_fp = write_config(
        os.path.join(d, "train_cfg.py"),
        os.path.join(configs, "fgn_train_mnistiseg_n3k3.py"),
        dict(train_ds_cfg=roots, eval_ds_cfg0=roots, work_dir=stage1,
             max_epochs=2, eval_interval_iters=5, log_interval=1))
    cfg = Config.from_file(cfg_fp)
    mcfg = main_mod.model_config_from_cfg(cfg)
    want = dict(backbone_norm="gn", deep_stem=True, avg_down=True,
                feat_channels=1024, n_ways=3, k_shots=3,
                compute_dtype="bfloat16")
    check(all(getattr(mcfg, k) == v for k, v in want.items())
          and cfg.optimizer.type == "adagrad" and int(cfg.batch_size) == 8,
          f"runner: config's model {mcfg} is not {want} at b8 adagrad")
    train = init_ds_class_by_config(cfg.train_ds_cfg)
    bs = int(cfg.batch_size)
    spe = len(train) // bs
    train.reshuffle(0)
    order0 = train.state_dict()["order"]

    # run A: killed by its RSS limit at the first check
    out_a = run_cli("A", ["fgn_torch.main", cfg_fp], 42,
                    env=dict(os.environ, FGN_MAX_RSS_GB="0.05"))
    check("planned restart at step 5" in out_a,
          "runner A: no planned restart at step 5")
    mgr = CheckpointManager(stage1)
    check(mgr.all_steps() == [5], f"runner A: checkpoints {mgr.all_steps()}")
    _, st = mgr.restore(5)
    extra = st["extra"]
    check(extra["epoch"] == 0 and extra["cursor"] == 5
          and list(extra["ds_state"]["order"]) == list(order0),
          f"runner A: step 5's extra {extra['epoch'], extra['cursor']}, "
          f"sidecar order epoch 0's: "
          f"{list(extra['ds_state']['order']) == list(order0)}")
    check_metrics(eval_metrics(out_a), "A", 4)
    nbytes, side = ckpt_bytes(mgr, 5)
    print(f"runner A: checkpoint at step 5 holds {nbytes} bytes (model + "
          f"optimizer + extra; sidecar {side} bytes); epoch 0, cursor 5, "
          f"sidecar order epoch 0's", flush=True)
    del st

    # run B: the resume, in this process, counted
    runners = []
    Recorded = recording_runner(runners)
    with mock.patch.object(main_mod, "Runner", Recorded):
        model, out_b, counts, wall = run_in_process(
            "B", lambda: main_mod.main(Config.from_file(cfg_fp)))
    (r,) = runners
    check(r.device.type == "cuda" and next(model.parameters()).is_cuda,
          f"runner B: ran on {r.device}")
    steps, n_eval = check_runner_counts(r, counts, "B")
    print(f"runner B: fgn_torch.main.main(cfg) in process, resumed and ran "
          f"{steps} steps, {len(r.checks)} checks and the fresh pass "
          f"({n_eval} eval batches) in {wall:.3f} s (host clock); "
          f"tensorboardX {'live' if r.tb is not None else 'absent'}",
          flush=True)
    check("Resumed from step 5 (epoch 0, cursor 5)" in out_b,
          "runner B: no 'Resumed from step 5 (epoch 0, cursor 5)'")
    check(r.step == 2 * spe and steps == 2 * spe - 5,
          f"runner B: ran {steps} steps to step {r.step}, want to "
          f"{2 * spe}")
    mgr = CheckpointManager(stage1)
    last = mgr.latest_step()
    _, st = mgr.restore(last)
    # the check at step 2 * spe saved first (epoch 1, cursor spe); the
    # end-of-epoch save at that step was skipped
    check(last == 2 * spe and st["extra"]["epoch"] == 1
          and st["extra"]["cursor"] == spe,
          f"runner B: last checkpoint {last}, extra {st['extra']['epoch']}, "
          f"{st['extra']['cursor']}")
    del st
    found = eval_metrics(out_b)
    want_at = [s for s, _ in r.checks] + ["fresh"]
    check([w for w, _ in found] == want_at,
          f"runner B: metrics printed at {[w for w, _ in found]}, checks at "
          f"{want_at}")
    check_metrics(found, "B", 4)
    print_checks(r, mgr, "B")
    periods = r.step_periods()
    print(f"runner B: a step, host clock, from one train step's call to the "
          f"next's (the loss read synchronizes every step), {len(periods)} "
          f"steps with no check between: {[round(v, 3) for v in periods]}; "
          f"median {statistics.median(periods):.3f} ms against "
          f"phase_engine's {engine_step_ms:.3f} ms from the wait for a "
          f"loader batch to the synchronized step (host clock); launches "
          f"{counts}; on {gpu}", flush=True)
    print(f"runner B: metrics at every check and the fresh pass: "
          f"{[(w, {k.split('/')[1]: round(v, 4) for k, v in m.items()}) for w, m in found]}",
          flush=True)
    del model, r
    runners.clear()
    torch.cuda.empty_cache()

    # run C: the finetune grid from run B's checkpoints, in this process
    ft_roots = dict(roots, root=os.path.join(d, "ft_fst"))
    ft_fp = write_config(
        os.path.join(d, "ft_cfg.py"),
        os.path.join(configs, "fgn_ft_mnistiseg.py"),
        dict(ft_ds_cfg0=ft_roots, ft_ds_cfg1=ft_roots, eval_ds_cfg0=ft_roots,
             eval_ds_cfg1=ft_roots, work_dir=os.path.join(d, "ft"),
             init_from=stage1, max_epochs=1))
    with mock.patch.object(main_mod, "Runner", Recorded):
        _, out_c, counts_c, wall = run_in_process(
            "C", lambda: main_ft.run_grid(ft_fp, gammas=(0.1,),
                                          nks=((3, 3),)))
    (r,) = runners
    check(r.device.type == "cuda", f"runner C: ran on {r.device}")
    check(r.batch_size == 4 and r.optimizer.kind == "adam"
          and len(r.evaluators) == 2
          and all(ev.batch_size == 4 and ev.ds.finetune == "Use"
                  for ev in r.evaluators),
          "runner C: not b4 Adam with two FT=Use evaluators at b4")
    steps_c, n_eval_c = check_runner_counts(r, counts_c, "C")
    check(f"Initialized from stage-1 checkpoint at step {2 * spe}" in out_c,
          f"runner C: not initialized from step {2 * spe}")
    cell = os.path.join(d, "ft", "N3K3_G0.1")
    check(os.path.isfile(os.path.join(cell, "FT_DONE")),
          f"runner C: no FT_DONE in {cell}")
    found = eval_metrics(out_c)
    want_at = [s for s, _ in r.checks for _ in r.evaluators] + [
        "fresh"] * len(r.evaluators)
    check([w for w, _ in found] == want_at,
          f"runner C: metrics printed at {[w for w, _ in found]}, want "
          f"{want_at}")
    check_metrics(found, "C", 4)
    ft = CheckpointManager(cell)
    check(ft.latest_step() == r.step == steps_c,
          f"runner C: last checkpoint {ft.latest_step()}, {r.step} steps")
    print_checks(r, ft, "C")
    print(f"runner C: fgn_torch.main_ft.run_grid in process, initialized from "
          f"step {2 * spe}, finetuned {steps_c} steps at b4 Adam, "
          f"{len(r.checks)} checks and the fresh passes ({n_eval_c} eval "
          f"batches of two FT=Use evaluators at b4) in {wall:.3f} s (host "
          f"clock); launches {counts_c}; metrics "
          f"{[(w, {k.split('/')[1]: round(v, 4) for k, v in m.items()}) for w, m in found]}",
          flush=True)
    # the cell's kernel calls, held against the plain versions: one more
    # b4 Adam train step on its first batch and one more forward on its
    # first FT=Use eval batch, neither counted
    gen = torch.Generator(device=dev).manual_seed(0)
    fwd_calls, bwd_calls, nms_calls = capture_train_calls(
        r.raw_step, r.first["train"], gen)
    check(len(fwd_calls) == 2 and len(bwd_calls) == 2 and len(nms_calls) == 1
          and fwd_calls[1][0][0].shape[0] == 4,
          f"runner C: ft-train calls {len(fwd_calls)}, {len(bwd_calls)}, "
          f"{len(nms_calls)}")
    for i, (a, k) in enumerate(fwd_calls):
        k1_record("ft-train", i, a, k, iters=PRINTED_ITERS)
    kernel_records(nms_calls, iters=PRINTED_ITERS, where="ft-train")
    backward_record(bwd_calls, iters=PRINTED_ITERS, where="ft-train")
    eval_calls = capture_kernel_args(r.model, r.first["eval"])
    check([n for n, _, _ in eval_calls].count("roi_align") == 3
          and [n for n, _, _ in eval_calls].count("nms_keep") == 2,
          f"runner C: ft-eval calls {[n for n, _, _ in eval_calls]}")
    kernel_records(eval_calls, iters=PRINTED_ITERS, where="ft-eval")
    del r, fwd_calls, bwd_calls, nms_calls, eval_calls
    runners.clear()
    torch.cuda.empty_cache()

    args = ["fgn_torch.main_ft", ft_fp, "--gammas", "0.1", "--nks", "3x3"]
    out_c2 = run_cli("C again", args, 0)
    check(f"Skipping completed {cell}" in out_c2
          and "=== FT grid cell" not in out_c2
          and "Initialized from" not in out_c2,
          "runner C again: the completed cell was not skipped")
    return counts, counts_c


# -- the COCO2VOC family -----------------------------------------------------

# The stand-in generated on the card, cut from the tool's defaults (800 /
# 240 / 150 / 80). A smaller COCO-val set leaves (query, category) children
# in the stage-1 eval set whose category has no support instance, and an
# episode drawn on one raises (the JAX package's engine alike): on the CPU's
# OpenCV at COCO-train 400, every COCO-val size tried from 20 to 140 (20, 30,
# 40, 50, 60, 70, 80, 90, 100, 120, 140) has 2-9 of them, 160 none; no
# config key cuts an eval set. ``supportless_children`` checks the card's.
COCOVOC_SIZES = dict(coco_train=400, coco_val=160, voc_train=40, voc_val=10)
COCOVOC_SEED = 8
# K2's largest Mp that stages: the largest multiple of its 128-candidate
# block whose boxes and areas fit in a walk block's shared memory
K2_STAGED_MAX_MP = 11264


def k2_unstaged_record(where, a, k, iters=20):
    """K2 at a call whose Mp is past what stages (the COCO2VOC train RPN
    call): the unstaged walk (which the call must take), held bit for bit
    against the plain version; the staged walk on the same boxes cut to
    K2_STAGED_MAX_MP candidates, held too; both timed in turns, unstaged,
    staged, staged, unstaged, over runs of 10 launches (CUDA events), and
    on the card alone (``device_ms``), beside the plain version and each
    one's bound (``k2_bound``). → its record."""
    import torch

    from fgn_torch.ops.nms import _greedy_alive
    from fgn_torch.ops.nms_cuda import _staged, greedy_alive_cuda

    boxes, alive, thr = a[0], a[1], a[2]
    B, Mp = alive.shape
    got, design = k2_landed(*a, **k)
    check(design == "unstaged", f"K2 {where}: Mp={Mp} took the {design} walk")
    ref = _greedy_alive(*a, **k)
    check(torch.equal(got, ref), f"K2 {where}: the unstaged walk differs")
    cut = K2_STAGED_MAX_MP
    check(_staged(cut) and not _staged(cut + 128) and cut < Mp,
          f"K2 {where}: {cut} is not the largest Mp that stages")
    cb, ca = boxes[:, :cut].contiguous(), alive[:, :cut].contiguous()
    got_c, design_c = k2_landed(cb, ca, thr)
    check(design_c == "staged" and torch.equal(got_c, _greedy_alive(cb, ca, thr)),
          f"K2 {where}: the staged walk at Mp={cut} took {design_c} or differs")
    reps = 10

    def run(*args):
        return lambda: [greedy_alive_cuda(*args) for _ in range(reps)]

    full, part = (boxes, alive, thr), (cb, ca, thr)
    times = [cuda_ms(run(*x), iters) / reps for x in (full, part, part, full)]
    ms, staged_ms = (times[0] + times[3]) / 2, (times[1] + times[2]) / 2
    dev_ms = device_ms(lambda: greedy_alive_cuda(*full))
    dev_staged = device_ms(lambda: greedy_alive_cuda(*part))
    plain_ms = cuda_ms(lambda: _greedy_alive(*a, **k), 3, warmup=1)
    t_bytes, t_ops = k2_bound(got, alive)
    c_bytes, c_ops = k2_bound(got_c, ca)
    bound_ms, staged_bound = (max(t_bytes, t_ops) * 1e3,
                              max(c_bytes, c_ops) * 1e3)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"nms_keep {where}: boxes {tuple(boxes.shape)}, IoU {thr}, "
          f"{int(alive.sum())} alive, {int(got.sum())} kept: unstaged walk "
          f"{ms:.4f} ms ({times[0]:.4f}, {times[3]:.4f}; on the card "
          f"{dev_ms:.4f}), bound {bound_ms:.5f} ms ({bound_by}); staged walk "
          f"on the first {cut} candidates {staged_ms:.4f} ms ({times[1]:.4f}, "
          f"{times[2]:.4f}; on the card {dev_staged:.4f}; {int(ca.sum())} "
          f"alive, {int(got_c.sum())} kept), bound {staged_bound:.5f} ms; "
          f"plain {plain_ms:.4f} ms; both walks equal the plain version bit "
          f"for bit", flush=True)
    return dict(shape=[B, Mp], max_abs_err=0.0, ms=ms, device_ms=dev_ms,
                staged_cut_mp=cut, staged_ms=staged_ms,
                staged_device_ms=dev_staged, staged_bound_ms=staged_bound,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def polygon_coverage(n_scenes=200, seed=COCOVOC_SEED):
    """The generator's polygon segmentations held to their masks on this
    host's OpenCV, in this process: ``n_scenes`` COCO-train scenes composed
    from ``seed`` by the tool's own ``compose_scene``, each instance's mask
    turned into polygons by its ``mask_to_polygons`` and decoded by the
    port's parser. A polygon is an external contour of the mask, filled
    again, so it covers its mask but for the components whose contour the
    tool drops (fewer than 3 points: a pixel, a straight run); a glyph's
    holes make it larger. Every pixel it misses must lie in such a
    component. → (instances, instances with pixels missed, decoded/area
    ratio min, max)."""
    import random

    import cv2
    import numpy as np

    from fgn_torch.data import rle as R
    from fgn_torch.data.coco import segmentation_to_rle
    from fgn_torch.tools import make_synthetic_cocovoc as T

    np.random.seed(seed)
    random.seed(seed)
    char_of = T.char_for_category()
    ids = [c for c, _ in T.COCO_CATEGORIES]
    h, w = 480, 640  # the tool's COCO canvas
    n = n_missed = 0
    ratios = []
    for _ in range(n_scenes):
        _, instances = T.compose_scene(h, w, ids, char_of,
                                       T.VARIANT_RANGES["train2017"])
        for _, mask in instances:
            polys = T.mask_to_polygons(mask)
            if not polys:  # the tool writes no annotation
                continue
            dec = R.decode(segmentation_to_rle(polys, h, w)).astype(bool)
            m = mask.astype(bool)
            missed = m & ~dec
            n += 1
            ratios.append(float(dec.sum()) / float(m.sum()))
            if not missed.any():
                continue
            n_missed += 1
            contours, _ = cv2.findContours(mask, cv2.RETR_EXTERNAL,
                                           cv2.CHAIN_APPROX_SIMPLE)
            _, label = cv2.connectedComponents(mask, connectivity=8)
            dropped = [label[int(c[0, 0, 1]), int(c[0, 0, 0])]
                       for c in contours if c.shape[0] < 3]
            bad = int((missed & ~np.isin(label, dropped)).sum())
            check(bad == 0, f"polygon coverage: {bad} of {int(m.sum())} "
                            f"mask pixels missed outside the dropped "
                            f"components")
    return n, n_missed, min(ratios), max(ratios)


def cocovoc_structure(coco_root, voc_root, sizes, work):
    """The generated stand-in held to its structure, not its bytes (the
    card's OpenCV draws other glyphs): image, annotation and category
    counts; every annotation's decoded mask non-empty and inside its box;
    compressed RLEs decoding to their ``area`` exactly; polygons, whose
    ratio to ``area`` varies with the glyphs, held to their masks by
    ``polygon_coverage``; the VOC files, palette
    PNGs with ignore borders and ImageSets; the parser audit catching
    exactly the two images the tool plants. → lines to print."""
    import json
    import os

    import cv2
    import numpy as np

    from fgn_torch.data import rle as R
    from fgn_torch.data.coco import segmentation_to_rle
    from fgn_torch.data.voc import VOC_IGNORE_COLOR, VOCDSParse
    from fgn_torch.tools.make_synthetic_cocovoc import COCO_CATEGORIES

    lines = []
    for subset, n in (("train2017", sizes["coco_train"]),
                      ("val2017", sizes["coco_val"])):
        with open(os.path.join(coco_root, "annotations",
                               f"instances_{subset}.json")) as f:
            d = json.load(f)
        files = os.listdir(os.path.join(coco_root, subset))
        check(len(d["images"]) == n == len(files),
              f"cocovoc {subset}: {len(d['images'])} images, {len(files)} "
              f"files, want {n}")
        check([(c["id"], c["name"]) for c in d["categories"]]
              == [tuple(c) for c in COCO_CATEGORIES],
              f"cocovoc {subset}: not the 80 COCO categories")
        imgs = {im["id"]: im for im in d["images"]}
        n_rle = n_crowd = 0
        ratios = []
        for ann in d["annotations"]:
            im = imgs[ann["image_id"]]
            m = R.decode(segmentation_to_rle(ann["segmentation"],
                                             im["height"], im["width"]))
            x, y, w, h = (int(v) for v in ann["bbox"])
            check(0 < m.sum() == m[y:y + h, x:x + w].sum(),
                  f"cocovoc {subset} annotation {ann['id']}: mask empty or "
                  f"outside its box")
            if isinstance(ann["segmentation"], dict):
                n_rle += 1
                check(int(m.sum()) == ann["area"],
                      f"cocovoc {subset} annotation {ann['id']}: RLE area "
                      f"{int(m.sum())}, want {ann['area']}")
            else:
                ratios.append(float(m.sum()) / ann["area"])
            n_crowd += int(ann["iscrowd"])
        check(n_rle and ratios, f"cocovoc {subset}: {n_rle} RLE, "
                                f"{len(ratios)} polygon annotations")
        lines.append(
            f"cocovoc {subset}: {n} images, {len(d['annotations'])} "
            f"annotations ({len(ratios)} polygon, decoded/area min "
            f"{min(ratios):.4f} median {statistics.median(ratios):.4f} max "
            f"{max(ratios):.4f}; {n_rle} "
            f"compressed RLE, area exact; {n_crowd} crowd), 80 categories, "
            f"every mask inside its box")
    n_voc = sizes["voc_train"] + sizes["voc_val"]
    for sub, ext in (("JPEGImages", ".jpg"), ("Annotations", ".xml"),
                     ("SegmentationObject", ".png"),
                     ("SegmentationClass", ".png")):
        got = [f for f in os.listdir(os.path.join(voc_root, sub))
               if f.endswith(ext)]
        check(len(got) == n_voc, f"cocovoc VOC {sub}: {len(got)} files, "
                                 f"want {n_voc}")
    sets = {}
    for name in ("train", "val", "trainval"):
        with open(os.path.join(voc_root, "ImageSets", "Segmentation",
                               f"{name}.txt")) as f:
            sets[name] = f.read().split()
    check(len(sets["train"]) == sizes["voc_train"]
          and len(sets["val"]) == sizes["voc_val"]
          and sets["trainval"] == sets["train"] + sets["val"],
          f"cocovoc VOC ImageSets: {({k: len(v) for k, v in sets.items()})}")
    for img_id in sets["trainval"]:
        png = cv2.imread(os.path.join(voc_root, "SegmentationObject",
                                      f"{img_id}.png"))[..., ::-1]
        check(bool((png == np.array(VOC_IGNORE_COLOR, np.uint8)).all(-1).any()),
              f"cocovoc VOC {img_id}: no ignore border")
    excluded = VOCDSParse("train", voc_root=voc_root,
                          root=os.path.join(work, "voc_audit")).get_excluded()
    check(excluded == sets["train"][:2],
          f"cocovoc VOC audit excluded {excluded}, want the two planted "
          f"{sets['train'][:2]}")
    n_inst, n_missed, lo, hi = polygon_coverage()
    lines.append(f"cocovoc polygons in process: {n_inst} instance masks of "
                 f"the tool's own scenes, each covered by its decoded "
                 f"polygons but for the components the tool drops ({n_missed} "
                 f"with such pixels missed); decoded/area {lo:.4f}-{hi:.4f}")
    lines.append(f"cocovoc VOC: {n_voc} images ({sets['train'].__len__()} "
                 f"train, {len(sets['val'])} val), XML, palette PNGs with "
                 f"ignore borders, ImageSets; the audit excludes exactly the "
                 f"two planted images {excluded}")
    return lines


def supportless_children(ds):
    """The (query image, category) children of ``ds`` whose category has no
    support instance in ``ds``: an episode drawn on one raises in
    ``FewShotISEG.get_support`` (as in the JAX package)."""
    return [(int(p), int(c)) for p, c in ds.qrys_children
            if not len(ds.cats_insts_list[int(c)])]


def timed_runner(Recorded, builds, waits):
    """A ``Recorded`` runner (``recording_runner``) whose train steps are
    also timed by CUDA events (``step_events``) and whose evaluators' steps
    are ``CountedStep``s, each pass's split printed as ``eval_pass`` prints
    it with K1 ×3 and K2 ×2 a batch checked; and the ``EpisodeLoader`` class
    for ``fgn_torch.train.loop`` that records each batch's build on the
    prefetch thread (``builds``: episodes, seconds) and the loop's wait for
    each batch (``waits``: seconds)."""
    import torch

    from fgn_torch.data.batching import EpisodeLoader

    class Loader(EpisodeLoader):
        def _build(self, indices):
            t = time.perf_counter()
            out = super()._build(indices)
            builds.append((len(indices), time.perf_counter() - t))
            return out

        def __iter__(self):
            it = super().__iter__()
            while True:
                t = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    return
                waits.append(time.perf_counter() - t)
                yield item

    class Timed(Recorded):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.step_events = []
            inner = self.train_step

            def train_step(batch, generator=None):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = inner(batch, generator=generator)
                end.record()
                self.step_events.append((start, end))
                return out

            self.train_step = train_step
            for ev in self.evaluators:
                ev.eval_step = CountedStep(ev.eval_step)
                ev.run = self._split(ev, ev.run)

        def _split(self, ev, run):
            return lambda: eval_pass(ev, ev.eval_step, run, len(ev.ds),
                                     f"coco2voc [{ev.tag}]", counted=False)[0]

        def step_ms(self):
            return [s.elapsed_time(e) for s, e in self.step_events]

    return Timed, Loader


def phase_cocovoc(dev, gpu, work):
    """The COCO2VOC family as a user runs it, from the port's own generated
    data, at the configs' full width (R50-C4, 800 px queries, 256 px
    supports, N3K3, bf16), in ``work``:

      * ``python -m fgn_torch.tools.make_synthetic_cocovoc`` writes the
        stand-in (COCOVOC_SIZES, seed 8), held to its structure
        (``cocovoc_structure``);
      * stage 1: ``fgn_torch.main.main`` in this process on a config derived
        from ``configs/fgn_train_coco2voc_synth.py`` (data roots, work_dir,
        one epoch; its one check at the epoch's end): b8 Adam, K1 ×2,
        K1-bwd ×2 and K2's unstaged walk ×1 a step, K1 ×3 and K2 ×2 staged
        an eval batch; each step by CUDA events, the batch wait, the
        prefetch thread's episodes/s, peak memory, each eval pass's split;
        one more step, not counted, whose K1, K1-bwd and K2 calls are held
        against the plain versions and timed (``coco2voc-train`` lines; K2's
        unstaged walk beside the staged walk on its first 11,264 boxes), and
        the first eval batch's calls (``coco2voc-eval``);
      * the finetune cell: ``fgn_torch.main_ft.run_grid`` in this process on
        a config derived from ``configs/fgn_ft_coco2voc_synth.py`` (data
        roots, work_dir, stage 1's run as ``init_from``, one epoch, the
        COCO finetune set's ``repeats`` cut from 10 to 1), γ 0.1, 3×3: b4
        Adam, the FT=Use evaluator over VOC novel at b4; K2 unstaged at
        (4, 12288) on a COCO batch and (4, 11520) on a VOC batch's 384x512
        canvas, held on one more step;
      * the DenseCL path: a seeded ``frozen_bn`` model
        (``configs/fgn_r50_c4_densecl.py``, its affines redrawn) saved
        through ``CheckpointManager``, exported by ``python -m
        fgn_torch.tools.export_pretrained_pth``, then 2 steps of
        ``configs/fgn_train_coco2voc.py`` in this process with that file
        as ``checkpoint_fp``: every backbone tensor loaded, none missed,
        the backbone equal to the saved one; K1 ×2, K1-bwd ×0, K2 unstaged
        ×1 a step (the frozen backbone's maps need no gradient);
      * the tools on stage 1's checkpoint: ``diagnose_detector`` over 2
        batches (recall and counts finite and in range, a render written)
        and ``eval_cat_shuffle`` over 8 episodes (both metric sets).

    → ({run: launch counts}, K2's unstaged record)."""
    import os
    import random

    import numpy as np
    import torch

    import fgn_torch
    import fgn_torch.train.loop as loop_mod
    from fgn_torch import main as main_mod
    from fgn_torch import main_ft
    from fgn_torch.config import Config
    from fgn_torch.data.fst_bindings import init_ds_class_by_config
    from fgn_torch.models.fgn import build_model
    from fgn_torch.models.resnet import FrozenAffine
    from fgn_torch.tools import diagnose_detector, eval_cat_shuffle
    from fgn_torch.train.checkpoints import CheckpointManager

    configs = os.path.join(os.path.dirname(fgn_torch.__file__), "configs")
    d = os.path.join(work, "cocovoc")
    os.makedirs(d)
    coco_root = os.path.join(d, "COCO")
    voc_root = os.path.join(d, "VOCdevkit", "VOC2012")
    sizes = COCOVOC_SIZES

    # 1. the stand-in, generated here by the port's tool; its default cache
    # roots (data/coco_cache, data/voc_cache) land in its working directory
    args = ["fgn_torch.tools.make_synthetic_cocovoc", "--coco-root", coco_root,
            "--voc-root", voc_root, "--seed", str(COCOVOC_SEED)]
    for key, v in sizes.items():
        args += ["--" + key.replace("_", "-"), str(v)]
    out = run_cli("generate", args, 0, cwd=d)
    for line in out.splitlines():
        print(f"cocovoc generate | {line}", flush=True)
    for line in cocovoc_structure(coco_root, voc_root, sizes, d):
        print(line, flush=True)
    caches = {o: os.path.join(d, "data", f"{o.lower()}_cache")
              for o in ("COCO", "VOC")}

    def roots(origin, **kw):
        return dict(root=os.path.join(d, "fst"), inner_root=caches[origin],
                    coco_root=coco_root, voc_root=voc_root, **kw)

    # the derived configs, and every dataset they train or evaluate on held
    # to episodes that can be built
    stage1, ft_dir = os.path.join(d, "stage1"), os.path.join(d, "ft")
    cfg_fp = write_config(
        os.path.join(d, "train_cfg.py"),
        os.path.join(configs, "fgn_train_coco2voc_synth.py"),
        dict(train_ds_cfg=roots("COCO"), eval_ds_cfg0=roots("COCO"),
             work_dir=stage1, max_epochs=1))
    ft_fp = write_config(
        os.path.join(d, "ft_cfg.py"),
        os.path.join(configs, "fgn_ft_coco2voc_synth.py"),
        dict(ft_ds_cfg0=roots("COCO", repeats=1), ft_ds_cfg1=roots("VOC"),
             eval_ds_cfg0=roots("VOC"), work_dir=ft_dir, init_from=stage1,
             max_epochs=1))
    t0 = time.perf_counter()
    cfg, ft_cfg = Config.from_file(cfg_fp), Config.from_file(ft_fp)
    ft_train = init_ds_class_by_config(ft_cfg.ft_ds_cfg0)
    ft_train.merge_ds(init_ds_class_by_config(ft_cfg.ft_ds_cfg1))
    sets = {"stage-1 train": init_ds_class_by_config(cfg.train_ds_cfg),
            "stage-1 eval": init_ds_class_by_config(cfg.eval_ds_cfg0),
            "finetune train": ft_train,
            "finetune eval": init_ds_class_by_config(ft_cfg.eval_ds_cfg0)}
    for name, ds in sets.items():
        bad = supportless_children(ds)
        check(not bad, f"coco2voc {name}: {len(bad)} of "
                       f"{len(ds.qrys_children)} (query, category) children "
                       f"have no support instance: {bad[:8]}")
    print(f"coco2voc datasets: "
          f"{ {k: (len(v), len(v.qrys_children)) for k, v in sets.items()} } "
          f"(episodes, children); every child's category has a support "
          f"instance; built in {time.perf_counter() - t0:.3f} s", flush=True)
    del sets, ft_train
    # the episodes draw from Python's and numpy's global generators: the
    # same draws whatever ran before this phase
    random.seed(COCOVOC_SEED)
    np.random.seed(COCOVOC_SEED)

    # 2. stage 1
    mcfg = main_mod.model_config_from_cfg(cfg)
    want = dict(backbone_norm="gn", backbone_frozen=False, deep_stem=True,
                avg_down=True, feat_channels=1024, n_ways=3, k_shots=3,
                compute_dtype="bfloat16", rpn_train_nms_pre=12288,
                rpn_test_nms_pre=6144)
    check(all(getattr(mcfg, k) == v for k, v in want.items())
          and cfg.optimizer.type == "adam" and int(cfg.batch_size) == 8
          and int(cfg.eval_batch_size) == 4,
          f"coco2voc: config's model {mcfg} is not {want} at b8 adam, eval b4")
    print(f"coco2voc stage 1: expecting per train step {COCO2VOC_TRAIN_KERNELS}"
          f" and per eval batch {SERVE_KERNELS}", flush=True)
    runners, builds, waits = [], [], []
    Timed, Loader = timed_runner(recording_runner(runners), builds, waits)
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(main_mod, "Runner", Timed), \
            mock.patch.object(loop_mod, "EpisodeLoader", Loader):
        _, out1, counts1, wall1 = run_in_process(
            "coco2voc stage 1", lambda: main_mod.main(Config.from_file(cfg_fp)))
    peak = torch.cuda.max_memory_allocated()
    (r,) = runners
    check(r.device.type == "cuda", f"coco2voc stage 1: ran on {r.device}")
    steps1, n_eval1 = check_runner_counts(r, counts1, "coco2voc stage 1",
                                          COCO2VOC_TRAIN_KERNELS)
    spe = len(r.train_ds) // 8
    check(steps1 == r.step == spe and len(r.checks) == 1,
          f"coco2voc stage 1: {steps1} steps to step {r.step}, {len(r.checks)} "
          f"checks, want one epoch of {spe} and one check")
    found = eval_metrics(out1)
    check([w for w, _ in found] == [spe, "fresh"],
          f"coco2voc stage 1: metrics at {[w for w, _ in found]}")
    check_metrics(found, "coco2voc stage 1", 4)
    step_ms = r.step_ms()
    timed = step_ms[2:] if len(step_ms) > 4 else step_ms
    n_eps, build_s = sum(n for n, _ in builds), sum(t for _, t in builds)
    print(f"coco2voc stage 1: fgn_torch.main.main(cfg) in process, one epoch "
          f"of {steps1} b8 Adam steps over {len(r.train_ds)} episodes, one "
          f"check and the fresh pass ({n_eval1} eval batches at b4) in "
          f"{wall1:.3f} s (host clock); a step by CUDA events median "
          f"{statistics.median(timed):.3f} ms (min {min(timed):.3f}, max "
          f"{max(timed):.3f}, n={len(timed)} after 2 warm-up); the loop's "
          f"wait for a batch median {statistics.median(waits) * 1e3:.3f} ms "
          f"(max {max(waits) * 1e3:.3f}); the prefetch thread built {n_eps} "
          f"episodes in {build_s:.3f} s = {n_eps / build_s:.2f} episodes/s "
          f"(collation included); peak memory {peak / 2**30:.2f} GiB; "
          f"launches {counts1}; metrics "
          f"{[(w, {k.split('/')[1]: round(v, 4) for k, v in m.items()}) for w, m in found]}; "
          f"on {gpu}", flush=True)
    print(f"coco2voc stage 1 steps, CUDA events: "
          f"{[round(v, 3) for v in step_ms]}", flush=True)
    # one more step and one more forward, not counted: each kernel's calls
    # held against its plain version and timed
    gen = torch.Generator(device=dev).manual_seed(0)
    fwd_calls, bwd_calls, nms_calls = capture_train_calls(
        r.raw_step, r.first["train"], gen)
    check(len(fwd_calls) == 2 and len(bwd_calls) == 2 and len(nms_calls) == 1
          and tuple(nms_calls[0][1][0].shape[:2]) == (8, 12288),
          f"coco2voc-train calls {len(fwd_calls)}, {len(bwd_calls)}, "
          f"{[tuple(a[0].shape) for _, a, _ in nms_calls]}")
    for i, (a, k) in enumerate(fwd_calls):
        k1_record("coco2voc-train", i, a, k, iters=PRINTED_ITERS)
    backward_record(bwd_calls, iters=PRINTED_ITERS, where="coco2voc-train")
    k2_rec = k2_unstaged_record("coco2voc-train", *nms_calls[0][1:])
    eval_calls = capture_kernel_args(r.model, r.first["eval"])
    names = [n for n, _, _ in eval_calls]
    check(names.count("roi_align") == 3 and names.count("nms_keep") == 2,
          f"coco2voc-eval calls {names}")
    kernel_records(eval_calls, iters=PRINTED_ITERS, where="coco2voc-eval")
    del r, fwd_calls, bwd_calls, nms_calls, eval_calls
    runners.clear()
    torch.cuda.empty_cache()

    # 3. the finetune cell
    builds.clear()
    waits.clear()
    with mock.patch.object(main_mod, "Runner", Timed), \
            mock.patch.object(loop_mod, "EpisodeLoader", Loader):
        _, out2, counts2, wall2 = run_in_process(
            "coco2voc finetune",
            lambda: main_ft.run_grid(ft_fp, gammas=(0.1,), nks=((3, 3),)))
    (r,) = runners
    check(r.device.type == "cuda" and r.batch_size == 4
          and r.optimizer.kind == "adam" and len(r.evaluators) == 1
          and r.evaluators[0].batch_size == 4
          and r.evaluators[0].ds.finetune == "Use"
          and r.evaluators[0].ds.sampling_origin_ds == "VOC"
          and r.evaluators[0].ds.sampling_cats == "novel",
          "coco2voc finetune: not b4 Adam with one FT=Use VOC-novel "
          "evaluator at b4")
    steps2, n_eval2 = check_runner_counts(r, counts2, "coco2voc finetune",
                                          COCO2VOC_TRAIN_KERNELS)
    check(f"Initialized from stage-1 checkpoint at step {spe}" in out2
          and os.path.isfile(os.path.join(ft_dir, "N3K3_G0.1", "FT_DONE")),
          f"coco2voc finetune: not initialized from step {spe}, or no FT_DONE")
    found = eval_metrics(out2)
    check_metrics(found, "coco2voc finetune", 4)
    check(len(found) == 2, f"coco2voc finetune: metrics at "
                           f"{[w for w, _ in found]}")
    step_ms = r.step_ms()
    print(f"coco2voc finetune: fgn_torch.main_ft.run_grid in process, "
          f"initialized from step {spe}, {steps2} b4 Adam steps (one epoch "
          f"of {len(r.train_ds)} merged episodes), one check and the fresh "
          f"pass ({n_eval2} eval batches of the FT=Use VOC-novel evaluator "
          f"at b4) in {wall2:.3f} s (host clock); a step by CUDA events "
          f"median {statistics.median(step_ms):.3f} ms; launches {counts2}; "
          f"metrics "
          f"{[(w, {k.split('/')[1]: round(v, 4) for k, v in m.items()}) for w, m in found]}",
          flush=True)
    # a COCO batch's canvas gives Mp 12288, a VOC batch's (384x512) 11520:
    # both past what stages
    _, _, nms_calls = capture_train_calls(r.raw_step, r.first["train"], gen)
    check(len(nms_calls) == 1 and nms_calls[0][1][0].shape[0] == 4
          and nms_calls[0][1][0].shape[1] in (11520, 12288),
          f"coco2voc-ft-train K2 calls "
          f"{[tuple(a[0].shape) for _, a, _ in nms_calls]}")
    k2_unstaged_record("coco2voc-ft-train", *nms_calls[0][1:],
                       iters=PRINTED_ITERS)
    del r, nms_calls
    runners.clear()
    torch.cuda.empty_cache()

    # 4. the DenseCL path: a seeded frozen_bn model, exported, converted
    dcl = os.path.join(d, "densecl")
    mcfg_dcl = main_mod.model_config_from_cfg(Config.from_file(
        os.path.join(configs, "fgn_r50_c4_densecl.py")))
    check(mcfg_dcl.backbone_norm == "frozen_bn" and mcfg_dcl.backbone_frozen,
          f"densecl: {mcfg_dcl}")
    src = build_model(mcfg_dcl, "cpu", seed=3)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for mod in src.backbone.modules():
            if isinstance(mod, FrozenAffine):
                mod.weight.copy_(1 + 0.1 * torch.randn(mod.weight.shape,
                                                       generator=g))
                mod.bias.copy_(0.1 * torch.randn(mod.bias.shape, generator=g))
    CheckpointManager(os.path.join(dcl, "src")).save(
        0, src.state_dict(), {}, extra={"epoch": 0, "cursor": 0})
    pth = os.path.join(dcl, "densecl.pth")
    out = run_cli("export", ["fgn_torch.tools.export_pretrained_pth",
                             os.path.join(dcl, "src"), pth], 0)
    n_bb = sum(1 for _ in src.backbone.parameters())
    check(f"tensors from step 0" in out and os.path.isfile(pth),
          f"densecl export: {out.strip()[-300:]}")
    print(f"densecl export: {out.strip()} ({os.path.getsize(pth)} bytes)",
          flush=True)
    dcl_fp = write_config(
        os.path.join(d, "densecl_cfg.py"),
        os.path.join(configs, "fgn_train_coco2voc.py"),
        dict(train_ds_cfg=roots("COCO"), eval_ds_cfg0=roots("COCO"),
             work_dir=os.path.join(dcl, "run"), checkpoint_fp=pth))
    print(f"densecl: 2 steps of fgn_train_coco2voc.py, expecting per step "
          f"{DENSECL_TRAIN_KERNELS}", flush=True)

    class TwoSteps(Exception):
        """Stops the run before its third step."""

    class Stopping(Timed):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            inner = self.train_step

            def train_step(batch, generator=None):
                if self.step >= 2:
                    raise TwoSteps
                return inner(batch, generator=generator)

            self.train_step = train_step

    def two_steps():
        try:
            main_mod.main(Config.from_file(dcl_fp))
        except TwoSteps:
            pass

    with mock.patch.object(main_mod, "Runner", Stopping):
        _, out3, counts3, wall3 = run_in_process("densecl", two_steps)
    (r,) = runners
    check(r.step == 2 and counts3 == {k: 2 * v for k, v in
                                      DENSECL_TRAIN_KERNELS.items()},
          f"densecl: {r.step} steps, launches {counts3}")
    check(f"load_torch_backbone: {n_bb} tensors loaded, 0 missing" in out3,
          f"densecl: the converter did not load all {n_bb} backbone tensors")
    saved = dict(src.backbone.named_parameters())
    worst = 0.0
    for name, p in r.model.backbone.named_parameters():
        got, want_p = p.detach().cpu(), saved[name].detach()
        if name.endswith("weight") and p.dim() == 1:
            # γ/√(var + eps) with var = float32(1 − eps): 1 ulp at most
            rel = float(((got - want_p).abs() / want_p.abs()).max())
            worst = max(worst, rel)
            check(rel <= 2.0 ** -23, f"densecl: {name} off by {rel} relative")
        else:
            check(torch.equal(got, want_p), f"densecl: {name} differs")
    print(f"densecl: fgn_torch.main.main on fgn_train_coco2voc.py with "
          f"checkpoint_fp {os.path.basename(pth)}: {n_bb} backbone tensors "
          f"loaded, 0 missing; after 2 steps the frozen backbone equals the "
          f"saved one (convolutions and biases exactly, affine weights within "
          f"{worst:.3g} relative); launches {counts3} in {wall3:.3f} s (host "
          f"clock, datasets and model built)", flush=True)
    del r, src
    runners.clear()
    torch.cuda.empty_cache()

    # 5. the tools on stage 1's checkpoint
    (stats, renders), out4, counts4, wall4 = run_in_process(
        "diagnose", lambda: diagnose_detector.main(cfg_fp, 2))
    summ = diagnose_detector.summary(stats)
    check(len(stats["n_props"]) > 0 and stats["prop_total"] > 0
          and all(np.isfinite(summ[k]) and 0.0 <= summ[k] <= 1.0
                  for k in ("prop_recall", "det_recall", "det_recall_cls"))
          and sum(summ["score_hist"]) == sum(stats["n_dets"])
          and renders and all(os.path.getsize(f) > 0 for f in renders)
          and counts4 == {k: 2 * v for k, v in SERVE_KERNELS.items()},
          f"diagnose: {summ}, renders {renders}, launches {counts4}")
    print(f"diagnose: 2 batches of 2 in {wall4:.3f} s; {summ}; renders "
          f"{[os.path.getsize(f) for f in renders]} bytes; launches {counts4}",
          flush=True)
    (base, shuf), out5, counts5, wall5 = run_in_process(
        "cat shuffle", lambda: eval_cat_shuffle.run(cfg_fp, 8))
    check(all(0.0 <= v <= 1.0 for m in (base, shuf) for v in m.values())
          and counts5 == {k: 4 * v for k, v in SERVE_KERNELS.items()},
          f"cat shuffle: {base}, {shuf}, launches {counts5}")
    print(f"cat shuffle: 8 episodes, two passes of 2 batches in {wall5:.3f} "
          f"s: normal {base}; shuffled {shuf}; launches {counts5}", flush=True)
    return {"stage1": counts1, "finetune": counts2, "densecl": counts3}, k2_rec


# -- data parallelism ------------------------------------------------------------
#
# The ranks of phase_dp are processes started by
# fgn_torch.parallel.dryrun.spawn_ranks; each imports this script for its body
# (below), so the launch counters it reads are its own.

# the flagship trainer's global batch (b6 a rank at 2 ranks)
DP_GLOBAL_B = 12


def dp_collectives(mesh):
    """Each collective the data-parallel path uses, straight through
    torch.distributed on CUDA tensors of this rank's device: all_reduce SUM
    and MAX, broadcast, all_gather, barrier, broadcast_object_list. →
    their names."""
    import torch
    import torch.distributed as dist

    dev, r, W = mesh.device, mesh.rank, mesh.world_size
    x = torch.full((7,), float(r + 1), device=dev)
    dist.all_reduce(x, dist.ReduceOp.SUM)
    check(bool((x == W * (W + 1) / 2).all()) and x.is_cuda,
          f"dp: gloo all_reduce SUM on CUDA gave {x.tolist()}")
    x = torch.full((7,), float(r + 1), device=dev, dtype=torch.float64)
    dist.all_reduce(x, dist.ReduceOp.MAX)
    check(bool((x == W).all()), f"dp: gloo all_reduce MAX gave {x.tolist()}")
    x = torch.full((3, 2), float(r + 5), device=dev)
    dist.broadcast(x, src=0)
    check(bool((x == 5).all()), f"dp: gloo broadcast gave {x.tolist()}")
    x = torch.full((2, 3), float(r), device=dev)
    parts = [torch.empty_like(x) for _ in range(W)]
    dist.all_gather(parts, x)
    check(all(bool((p == i).all()) for i, p in enumerate(parts)),
          "dp: gloo all_gather out of rank order")
    dist.barrier()
    box = [{"rank": r}]
    dist.broadcast_object_list(box, src=0)
    check(box[0] == {"rank": 0}, f"dp: broadcast_object_list gave {box}")
    return ["all_reduce SUM", "all_reduce MAX", "broadcast", "all_gather",
            "barrier", "broadcast_object_list"]


def dp_flagship(mesh, warmup=2, iters=3):
    """The flagship trainer data-parallel: R50-C4, N3K3, 480 px, bf16, Adam,
    the global b12 batch's rows of this rank (b6 at 2 ranks). Each step runs
    with the launch counters set to 0 just before it and read just after;
    the gradient all-reduce is timed on the host clock with the card
    synchronized around it. Then one more step, uncounted, whose kernel
    calls rank 0 holds against the plain versions. → this rank's
    readings."""
    from unittest import mock

    import torch

    import fgn_torch.train.train_step as ts
    from fgn_torch.data.batching import toy_batch
    from fgn_torch.models.fgn import build_model
    from fgn_torch.parallel.mesh import (
        all_gather_rows, barrier, replicate, shard_batch,
    )
    from fgn_torch.train.optim import build_optimizer, make_lr_schedule

    dev = mesh.device
    model = replicate(build_model(flagship_cfg(), dev, seed=0), mesh)
    opt = build_optimizer(model, optimizer="adam",
                          schedule=make_lr_schedule(5e-3, steps_per_epoch=1000))
    step = ts.make_train_step(model, opt, mesh)
    batch = shard_batch(toy_batch(B=DP_GLOBAL_B, H=480, W=480, N=3, K=3,
                                  S=128), mesh)
    gen = torch.Generator(device=dev).manual_seed(0)
    reduce_ms = []
    real_sum = ts.sum_gradients

    def timed_sum(params, m, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_sum(params, m, *a, **k)
        torch.cuda.synchronize()
        reduce_ms.append((time.perf_counter() - t0) * 1e3)

    n_bytes = sum(p.numel() * p.element_size()
                  for p in ts._updated_params(opt))
    counts, ms, wall = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(ts, "sum_gradients", timed_sum):
        for i in range(warmup + iters):
            barrier(mesh)
            torch.cuda.synchronize()
            zero_counts()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            metrics = step(batch, gen)
            end.record()
            end.synchronize()
            t1 = time.perf_counter()
            counts.append(read_counts())
            bad = [k for k, v in metrics.items()
                   if k.startswith("loss_") and not bool(torch.isfinite(v))]
            check(not bad, f"dp flagship rank {mesh.rank}: non-finite {bad}")
            if i >= warmup:
                ms.append(start.elapsed_time(end))
                wall.append((t1 - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    for c in counts:
        check(c == TRAIN_KERNELS, f"dp flagship rank {mesh.rank}: launches "
                                  f"{c} a step, want {TRAIN_KERNELS}")
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    every = all_gather_rows(flat[None], mesh)
    check(all(torch.equal(every[0], e) for e in every),
          "dp flagship: the ranks' parameters differ after the steps")
    del every, flat
    fwd_calls, bwd_calls, nms_calls = capture_train_calls(step, batch, gen)
    recs = None
    if mesh.is_main:
        b = DP_GLOBAL_B // mesh.world_size
        shapes = (sorted(tuple(a[0].shape) + (a[1].shape[1],)
                         for a, _ in fwd_calls),
                  sorted(tuple(a[0].shape) for a, _ in bwd_calls),
                  [tuple(a[0].shape) for _, a, _ in nms_calls])
        check(shapes == (
            sorted([(b * 9, 8, 8, 1024, 1), (b, 30, 30, 1024, 128)]),
            sorted([(b * 9, 1, 7, 7, 1024), (b, 128, 7, 7, 1024)]),
            [(b, 4096, 4)]), f"dp flagship: rank 0's kernel calls {shapes}")
        recs = [k1_record("dp-train", i, a, k, iters=5)
                for i, (a, k) in enumerate(fwd_calls)]
        recs.append(backward_record(bwd_calls, iters=5, where="dp-train"))
        recs.extend(kernel_records(nms_calls, iters=5,
                                   where="dp-train").values())
        for rec in recs:
            rec.pop("_args", None)
            rec.pop("_size", None)
    del fwd_calls, bwd_calls, nms_calls
    barrier(mesh)
    total = {k: sum(c[k] for c in counts) for k in counts[0]}
    return dict(counts=counts[-1], launches=total, ms=ms, wall=wall,
                reduce_ms=reduce_ms[warmup:], reduce_bytes=n_bytes,
                n_params=sum(p.numel() for p in model.parameters()),
                peak=peak, recs=recs)


def dp_twin_spec():
    """The f32 twin's inputs: the flagship's width in f32, seeded weights,
    SGD at make_lr_schedule(5e-3, steps_per_epoch=100, warmup_iters=1) as
    tests/test_dp_equivalence.py steps it, 2 steps on a global b4 batch
    drawing from the generator seeded 100 + step."""
    from fgn_torch.data.batching import toy_batch

    fields = {k: v.numpy() for k, v in toy_batch(
        B=4, H=480, W=480, N=3, K=3, S=128)._asdict().items()}
    return dict(
        cfg=dict(n_ways=3, k_shots=3, backbone_norm="gn",
                 backbone_frozen=False, compute_dtype="float32"),
        optimizer=dict(optimizer="sgd", base_lr=5e-3, schedule=dict(
            base_lr=5e-3, steps_per_epoch=100, warmup_iters=1)),
        steps=[dict(fields=fields, seed=100 + i) for i in range(2)],
        keep={"grads": [0], "params": [1]})


def dp_twin(mesh, spec):
    """``dryrun.train_rank`` with TF32 off and deterministic cuDNN."""
    from fgn_torch.parallel.dryrun import train_rank

    with strict_f32():
        return train_rank(mesh, spec)


def dp_gloo_rank(mesh, twin_spec):
    """Rank body of the 2-rank start over gloo on one card: the
    collectives, the flagship trainer, the f32 twin."""
    return dict(collectives=dp_collectives(mesh), flagship=dp_flagship(mesh),
                twin=dp_twin(mesh, twin_spec))


def dp_nccl_rank(mesh):
    """One rank over NCCL: a b12 bf16 Adam step of the flagship through the
    data-parallel step (its collectives run: a 1-rank group) and through
    the step without a mesh, from the same weights, batch and generator
    seed, with cuDNN and PyTorch's deterministic algorithms: every
    parameter and metric equal bit for bit. → the parameters compared."""
    import os

    import torch

    from fgn_torch.data.batching import to_device, toy_batch
    from fgn_torch.models.fgn import build_model
    from fgn_torch.train.optim import build_optimizer, make_lr_schedule
    from fgn_torch.train.train_step import make_train_step

    check(mesh.backend == "nccl" and mesh.group is not None
          and mesh.world_size == 1, f"dp nccl: mesh {mesh}")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    dev = mesh.device
    batch = to_device(toy_batch(B=DP_GLOBAL_B, H=480, W=480, N=3, K=3,
                                S=128), dev)

    def run(m):
        model = build_model(flagship_cfg(), dev, seed=0)
        opt = build_optimizer(
            model, optimizer="adam",
            schedule=make_lr_schedule(5e-3, steps_per_epoch=1000))
        gen = torch.Generator(device=dev).manual_seed(0)
        metrics = make_train_step(model, opt, m)(batch, gen)
        torch.cuda.synchronize()
        return ({k: v.detach().clone() for k, v in metrics.items()},
                [p.detach().clone() for p in model.parameters()])

    (ma, pa), (mb, pb) = run(None), run(mesh)
    same_m = ma.keys() == mb.keys() and all(torch.equal(ma[k], mb[k])
                                            for k in ma)
    same_p = sum(not torch.equal(a, b) for a, b in zip(pa, pb))
    if not (same_m and same_p == 0):
        ma2, pa2 = run(None)
        print(f"dp nccl: the step without a mesh, twice: "
              f"{sum(not torch.equal(a, b) for a, b in zip(pa, pa2))} "
              f"parameters differ", flush=True)
    check(same_m and same_p == 0,
          f"dp nccl: the 1-rank NCCL step differs from the step without a "
          f"mesh: metrics equal {same_m}, {same_p} of {len(pa)} parameters "
          f"differ")
    return len(pa)


def dp_eval_rank(mesh, spec):
    """One ``Evaluator`` pass over the eval split of ``spec["cfg"]`` with the
    weights of the latest checkpoint in ``spec["ckpt"]``, at the global
    batch ``spec["batch"]``, Python's and numpy's generators seeded 0, the
    launch counters set to 0 just before and read just after. → (metrics,
    the results pickles {name: bytes} on rank 0, launches, batches)."""
    import os
    import random

    import numpy as np
    import torch

    from fgn_torch.config import Config
    from fgn_torch.data.fst_bindings import init_ds_class_by_config
    from fgn_torch.main import model_config_from_cfg
    from fgn_torch.models.fgn import build_model
    from fgn_torch.parallel.mesh import rank0_first
    from fgn_torch.train.checkpoints import CheckpointManager
    from fgn_torch.train.evaluator import Evaluator
    from fgn_torch.train.train_step import make_eval_step

    cfg = Config.from_file(spec["cfg"])
    mcfg = model_config_from_cfg(cfg)
    model = build_model(mcfg, mesh.device, seed=0)
    _, state = CheckpointManager(spec["ckpt"]).load_model(
        map_location=mesh.device)
    model.load_state_dict(state)
    ds = rank0_first(lambda: init_ds_class_by_config(cfg.eval_ds_cfg0), mesh)
    ev = Evaluator(model, ds, batch_size=spec["batch"],
                   eval_step=make_eval_step(model, mesh),
                   work_dir=spec["work"], max_gt=int(cfg.get("max_gt", 30)),
                   mask_thr=mcfg.mask_thr, n_plots=0, mesh=mesh)
    random.seed(0)
    np.random.seed(0)
    torch.cuda.synchronize()
    zero_counts()
    metrics = ev.run()
    torch.cuda.synchronize()
    counts = read_counts()
    pkl = None
    if mesh.is_main:
        d = ev.results_dir()
        pkl = {}
        for name in sorted(os.listdir(d)):
            with open(os.path.join(d, name), "rb") as f:
                pkl[name] = f.read()
    return metrics, pkl, counts, ev.last_times["batches"]


def leaf_close(got, want, rel, atol):
    """→ (all within, the worst |diff| / tolerance) over the leaves: each
    within rel × its largest |want| + atol."""
    import numpy as np

    worst = 0.0
    for name, w in want.items():
        tol = rel * float(np.abs(w).max()) + atol
        d = float(np.abs(got[name].astype(np.float64) - w).max())
        worst = max(worst, d / tol)
    return worst <= 1.0, worst


def phase_dp(dev, gpu, work, raw):
    """Data parallelism on the one card (module docstring): 2 ranks over
    gloo (the collectives, the flagship trainer at b12 = b6 a rank with its
    launches counted and rank 0's kernel calls held, the f32 twin against 1
    rank at b4), 1 rank over NCCL bit for bit, ``python -m
    fgn_torch.parallel.dryrun --ranks 2 --backend gloo``, and ``torchrun
    --nproc_per_node 2 -m fgn_torch.main`` over the split ``phase_engine``
    generated, whose checkpoint a 2-rank eval pass then scores as a 1-rank
    pass does. → each kernel's launches in each rank of the flagship run."""
    import os

    import fgn_torch
    from fgn_torch.parallel.dryrun import spawn_ranks
    from fgn_torch.parallel.mesh import Mesh
    from fgn_torch.train.checkpoints import CheckpointManager

    note = ("2 ranks share the one card: each rank's time holds the other's "
            "work, and the all-reduce is gloo's, staged through host memory")
    twin_spec = dp_twin_spec()
    t0 = time.perf_counter()
    ranks = spawn_ranks(dp_gloo_rank, 2, (twin_spec,), backend="gloo",
                        device="cuda", timeout=420, threads=3)
    print(f"dp: 2 ranks over gloo on {dev} in {time.perf_counter() - t0:.1f}"
          f" s (host clock, process starts included); collectives on CUDA "
          f"tensors: {', '.join(ranks[0]['collectives'])}: held", flush=True)
    for r, res in enumerate(ranks):
        f = res["flagship"]
        print(f"dp flagship rank {r}: b{DP_GLOBAL_B // 2} of a global "
              f"b{DP_GLOBAL_B} bf16 adam 480x480 N3K3: step "
              f"{[round(v, 3) for v in f['ms']]} ms by CUDA events, "
              f"{[round(v, 3) for v in f['wall']]} ms host clock; gradient "
              f"all-reduce {[round(v, 3) for v in f['reduce_ms']]} ms a step "
              f"for {f['reduce_bytes']} bytes ({f['n_params']} f32 "
              f"parameters); peak memory {f['peak'] / 2**30:.2f} GiB "
              f"(torch.cuda.max_memory_allocated); launches a step "
              f"{f['counts']}; {note}; on {gpu}", flush=True)
    wall = [max(a, b) for a, b in zip(ranks[0]["flagship"]["wall"],
                                       ranks[1]["flagship"]["wall"])]
    print(f"dp flagship: the step's wall time across ranks (host clock, from "
          f"a barrier to the later rank's synchronized end) "
          f"{[round(v, 3) for v in wall]} ms, median "
          f"{statistics.median(wall):.3f} ms; {note}; on {gpu}", flush=True)

    # the f32 twin: 2 ranks x b2 against 1 rank x b4
    with strict_f32():
        from fgn_torch.parallel.dryrun import train_rank

        one = train_rank(Mesh(device=dev), twin_spec)
    r0, r1 = (res["twin"] for res in ranks)
    for i, want in enumerate(one):
        check(r0[i]["digest"] == r1[i]["digest"],
              f"dp twin: the ranks' parameters differ after step {i}")
        for k in ("loss_total",):
            check(abs(r0[i]["metrics"][k] - want["metrics"][k])
                  <= 1e-6 * abs(want["metrics"][k]),
                  f"dp twin step {i}: {k} {r0[i]['metrics'][k]} against "
                  f"{want['metrics'][k]}")
    ok_g, worst_g = leaf_close(r0[0]["grads"], one[0]["grads"], 4e-3, 1e-7)
    ok_p, worst_p = leaf_close(r0[1]["params"], one[1]["params"], 1e-4, 1e-5)
    print(f"dp twin f32 (TF32 off, deterministic cuDNN): 2 ranks x b2 "
          f"against 1 rank x b4, SGD: loss_total "
          f"{[r['metrics']['loss_total'] for r in r0]} against "
          f"{[r['metrics']['loss_total'] for r in one]}; gradients at "
          f"{worst_g:.3g} of their tolerance (4e-3 of each leaf's largest "
          f"+ 1e-7), parameters after 2 steps at {worst_p:.3g} of theirs "
          f"(1e-4 of each leaf's largest + 1e-5); the ranks' parameters "
          f"identical after every step", flush=True)
    check(ok_g and ok_p, f"dp twin: gradients {worst_g:.3g}, parameters "
                         f"{worst_p:.3g} of their tolerances")
    launches = [res["flagship"]["launches"] for res in ranks]
    recs = ranks[0]["flagship"]["recs"]
    del ranks, r0, r1, one

    # one rank over NCCL
    t0 = time.perf_counter()
    (n,) = spawn_ranks(dp_nccl_rank, 1, backend="nccl", device="cuda",
                       timeout=300, threads=4)
    print(f"dp nccl: 1 rank over NCCL, a b{DP_GLOBAL_B} bf16 adam step "
          f"through the data-parallel step equal bit for bit to the step "
          f"without a mesh ({n} parameters and every metric) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    out = run_cli("dp dryrun", ["fgn_torch.parallel.dryrun", "--ranks", "2",
                                "--backend", "gloo"], 0, timeout=300)
    line = out.strip().splitlines()[-1] if out.strip() else ""
    check(line.startswith("dryrun_multichip(2): steps=2 ")
          and line.endswith("OK"), f"dp dryrun: printed {line!r}")
    print(f"dp dryrun | {line}", flush=True)

    # torchrun over the engine's split
    configs = os.path.join(os.path.dirname(fgn_torch.__file__), "configs")
    d = os.path.join(work, "dp")
    os.makedirs(d)
    roots = dict(inner_root=raw, root=os.path.join(d, "fst"))
    run_dir = os.path.join(d, "run")
    cfg_fp = write_config(
        os.path.join(d, "dp_cfg.py"),
        os.path.join(configs, "fgn_train_mnistiseg_n3k3.py"),
        dict(train_ds_cfg=roots, eval_ds_cfg0=roots, work_dir=run_dir,
             max_epochs=1, log_interval=1))
    out = run_cli("dp torchrun", [
        "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
        "-m", "fgn_torch.main", cfg_fp, "--backend", "gloo"], 0, timeout=600)
    mgr = CheckpointManager(run_dir)
    steps = out.count(" loss=")
    found = eval_metrics(out)
    check(out.count("ckpt scheduled at step") == 1
          and mgr.all_steps() == [steps] and steps > 0,
          f"dp torchrun: {out.count('ckpt scheduled at step')} saves "
          f"printed, checkpoints {mgr.all_steps()}, {steps} steps logged")
    check([w for w, _ in found] == [steps, "fresh"],
          f"dp torchrun: metrics printed at {[w for w, _ in found]}")
    check_metrics(found, "dp torchrun", 4)
    print(f"dp torchrun: torchrun --nproc_per_node 2 -m fgn_torch.main "
          f"--backend gloo: {steps} steps at a global b8, one check, its "
          f"checkpoint written once (rank 0), metrics printed once a pass "
          f"(rank 0): {found}", flush=True)

    # its checkpoint scored by 2 ranks and by 1
    spec = dict(cfg=cfg_fp, ckpt=run_dir, work=os.path.join(d, "eval2"),
                batch=8)
    (m2, pkl2, c0, nb), (_, _, c1, _) = spawn_ranks(
        dp_eval_rank, 2, (spec,), backend="gloo", device="cuda", timeout=300,
        threads=3)
    m1, pkl1, _, _ = dp_eval_rank(Mesh(device=dev), dict(
        spec, work=os.path.join(d, "eval1"), batch=4))
    want = {k: SERVE_KERNELS[k] * nb for k in SERVE_KERNELS}
    check(c0 == want and c1 == want,
          f"dp eval: launches {c0}, {c1}, want {want} ({nb} batches)")
    check(m2 == m1 and pkl2 == pkl1 and pkl1,
          f"dp eval: 2 ranks {m2} against 1 rank {m1}; pickles equal "
          f"{pkl2 == pkl1}")
    print(f"dp eval: the torchrun checkpoint over the eval split, 2 ranks at "
          f"a global b8 (b4 a rank) against 1 rank at b4: metrics and "
          f"{len(pkl1)} results pickles equal byte for byte; {nb} batches, "
          f"launches a rank {c0}; metrics {m1}", flush=True)
    return launches, recs


def cv2_line():
    """``cv2: <version>|absent; PIL: <version>|absent; grain:
    present|absent``: whether this machine has OpenCV, which the episode
    engine needs, PIL, which ``utils/io.py::image_size`` needs, and grain,
    whose absence sends ``GrainEpisodeLoader`` to its fork pool."""
    import importlib

    parts = []
    for name, mod in (("cv2", "cv2"), ("PIL", "PIL")):
        try:
            parts.append(f"{name}: {importlib.import_module(mod).__version__}")
        except ImportError:
            parts.append(f"{name}: absent")
    try:
        importlib.import_module("grain.python")
        parts.append("grain: present")
    except ImportError:
        parts.append("grain: absent")
    return "; ".join(parts)


# Runs a kernel's time is the median of (``cuda_ms``) in the records that
# are printed only (main path, COCO2VOC serving and N1K1, flagship b4,
# train path, engine-train K1 and K2, ft-train, ft-eval, coco2voc-train K1
# and K1-bwd, coco2voc-eval, coco2voc-ft-train): 4, not 20, the cuts that
# paid for earlier phases; every call is still held against its plain
# version.
# The records the kernels line reads (eval's, the engine's K1-bwd, COCO2VOC
# stage 1's unstaged K2) keep 20.
PRINTED_ITERS = 4

# The phases in the order they run; ``--phases`` picks some (the eval,
# runner and dp phases take the engine's split and model config, so each
# brings the engine phase with it).
PHASES = ("roi_align", "roi_align_backward", "nms", "group_norm",
          "vit_attention", "main_path",
          "plain_twin",
          "coco2voc_serve", "train", "train_twin", "engine", "eval",
          "runner", "cocovoc", "dp")
KERNEL_KEYS = ("name", "route", "source", "replaces", "path", "launches",
               "launches_main_paths", "launches_runner", "launches_finetune",
               "launches_dp", "launches_coco2voc", "coco2voc_unstaged",
               "max_abs_err", "max_ulp", "ms",
               "earlier_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one flagship forward and one train "
                         "step by stage and op, sweep K1's channel tiles and "
                         "ROI groups at its largest call, K1-bwd's channel "
                         "tiles and block sizes at its largest call, and "
                         "K2's blocks an image at its serving calls")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma list of the phases to run (default all: "
                         f"{','.join(PHASES)}); eval, runner and dp also "
                         "run engine. The kernels line holds what the "
                         "chosen phases measured")
    args = ap.parse_args(argv)
    want = set(args.phases.split(","))
    if want - set(PHASES):
        ap.error(f"unknown phases {sorted(want - set(PHASES))}")
    if want & {"eval", "runner", "dp"}:
        want.add("engine")
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
    print(f"gpu: {gpu}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"phases {','.join(p for p in PHASES if p in want)}", flush=True)
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
    phase_t = [time.perf_counter()]

    def phase_done(name):
        now = time.perf_counter()
        print(f"phase {name}: {now - phase_t[0]:.1f} s", flush=True)
        phase_t[0] = now

    # each main path's launches: a forward's at each serving geometry, a
    # train step's
    path_launches = {}
    if "roi_align" in want:
        phase_roi_align(dev, [
            ("support", 72, 8, 8, 1024, 1),
            ("proposals", 8, 30, 30, 1024, 300),
            ("detections", 8, 30, 30, 1024, 100),
            ("coco2voc", 4, 50, 68, 1024, 300),  # ragged: 50x68 in 16-ch tiles
            # the Swin-L cell's 768-channel C4 maps: queries, supports
            ("swin_proposals", 4, 50, 68, 768, 300),
            ("swin_detections", 4, 50, 68, 768, 100),
            ("swin_support", 36, 8, 8, 768, 1),
            ("large", 1, 128, 128, 128, 64),  # past shared memory: direct
        ])
        # the staged kernel's generic instance (out_size, sampling ratio not
        # compiled in), which no call of the model takes
        phase_roi_align(dev, [("generic", 2, 30, 30, 256, 40)], out_size=14)
        phase_roi_align(dev, [("generic", 2, 12, 14, 256, 20)], out_size=4,
                        sampling_ratio=3, aligned=False)
        phase_done("roi_align")
    if "roi_align_backward" in want:
        phase_roi_align_backward(dev, [
            ("supports", 108, 8, 8, 1024, 1),
            ("sampled", 12, 30, 30, 1024, 128),
            ("coco2voc-train", 8, 50, 68, 1024, 128),
            ("coco2voc-supports", 72, 16, 16, 1024, 1),
            ("ragged", 3, 30, 30, 256, 13),  # R not a multiple of the chunk
            ("large", 1, 128, 128, 128, 20),  # past shared memory: atomics
        ])
        # the staged backward's generic instance (out_size, sampling ratio
        # not compiled in), which no call of the model takes
        phase_roi_align_backward(dev, [("generic", 2, 12, 14, 256, 20)],
                                 twin=("generic",), out_size=4,
                                 sampling_ratio=3, aligned=False)
        phase_done("roi_align_backward")
    if "nms" in want:
        phase_nms(dev)
        phase_done("nms")
    recs = {}
    if "group_norm" in want:
        recs["group_norm"] = phase_group_norm(dev, gpu, args.profile)
        phase_done("group_norm")
    if "vit_attention" in want:
        recs["vit_attention"] = phase_vit_attention(dev, gpu)
        phase_done("vit_attention")
    if "main_path" in want:
        model, batch, calls, path_launches["forward_flagship_b8"] = (
            phase_main_path(dev, gpu))
        # printed; the JSON keeps this slice's paths
        kernel_records(calls, iters=PRINTED_ITERS)
        if args.profile:
            k1_sweep(*max(((a, k) for name, a, k in calls
                           if name == "roi_align"),
                          key=lambda c: c[0][1].shape[1]))
            for name, a, _ in calls:
                if name == "nms_keep":
                    k2_sweep("flagship", a)

            phase_breakdown(
                "forward", lambda: model.test_forward(batch), "request")
        del model, batch, calls
        torch.cuda.empty_cache()
        model, batch, calls, path_launches["forward_flagship_b4"] = (
            phase_main_path(dev, gpu, B=4, tag="flagship-b4"))
        del model, batch
        kernel_records(calls, iters=PRINTED_ITERS, where="flagship-b4")
        del calls
        torch.cuda.empty_cache()
        phase_done("main_path")
    if "plain_twin" in want:
        phase_plain_twin(dev)
        torch.cuda.empty_cache()
        phase_done("plain_twin")
    if "coco2voc_serve" in want:
        for tag, n, k in COCO2VOC_WAYS:
            model, batch, calls, path_launches[f"forward_coco2voc_n{n}k{k}"] = (
                phase_main_path(dev, gpu, N=n, K=k, tag=tag,
                                rpn_test_nms_pre=COCO2VOC_NMS_PRE,
                                **COCO2VOC_GEOMETRY))
            del model, batch
            if n == 1:  # K1 on 4 support maps of R = 1, K2 with one way
                kernel_records(calls, iters=PRINTED_ITERS, where=tag)
            else:
                # K2 at the longest walk (Mp = 6144); printed, the JSON
                # keeps the flagship's largest call
                kernel_records(calls, iters=PRINTED_ITERS, where=tag,
                               names=("nms_keep",))
                if args.profile:
                    k2_sweep(tag, next(a for name, a, _ in calls
                                       if name == "nms_keep"))
            del calls
            torch.cuda.empty_cache()
        phase_done("coco2voc_serve")
    if "train" in want:
        (path_launches["train_step_b12"], fwd_calls, bwd_calls,
         nms_calls, recs["optim"]) = phase_train(dev, gpu,
                                                 profile=args.profile)
        for i, (a, k) in enumerate(fwd_calls):
            k1_record("train-path", i, a, k, iters=PRINTED_ITERS)
        kernel_records(nms_calls, iters=PRINTED_ITERS, where="train-path")
        toy = backward_record(bwd_calls, iters=PRINTED_ITERS)
        if args.profile:
            k1bwd_sweep(*toy["_args"])
        del toy, fwd_calls, bwd_calls, nms_calls
        torch.cuda.empty_cache()
        phase_done("train")
    if "train_twin" in want:
        phase_train_twin(dev)
        torch.cuda.empty_cache()
        phase_done("train_twin")
    print(cv2_line(), flush=True)
    from fgn_torch.data.digests import CONFIG

    launches = {}
    with tempfile.TemporaryDirectory() as work:
        if "engine" in want:
            (cfg, mcfg, val, engine_counts,
             (fwd_calls, bwd_calls, nms_calls),
             raw, engine_step_ms) = phase_engine(dev, gpu, work)
            for i, (a, k) in enumerate(fwd_calls):
                k1_record("engine-train", i, a, k, iters=PRINTED_ITERS)
            kernel_records(nms_calls, iters=PRINTED_ITERS,
                           where="engine-train")
            bwd = backward_record(bwd_calls, where="engine-train")
            del fwd_calls, bwd_calls, nms_calls
            torch.cuda.empty_cache()
            # K1-bwd's numbers come from the timed train steps on real
            # episodes (launches) and one more step's calls
            bwd.pop("_args")
            recs["roi_align_backward"] = dict(
                bwd, launches=engine_counts["roi_align_backward"],
                path="engine train steps, " + CONFIG)
            phase_done("engine")
        if "eval" in want:
            eval_counts, eval_calls = phase_eval(dev, gpu, val, mcfg,
                                                 B=int(cfg.eval_batch_size))
            torch.cuda.empty_cache()
            phase_done("eval")
        if "runner" in want:
            launches["runner"], launches["finetune"] = phase_runner(
                dev, gpu, work, raw, engine_step_ms)
            torch.cuda.empty_cache()
            phase_done("runner")
        if "cocovoc" in want:
            launches["coco2voc"], k2_unstaged = phase_cocovoc(dev, gpu, work)
            torch.cuda.empty_cache()
            phase_done("cocovoc")
        if "dp" in want:
            dp_counts, _ = phase_dp(dev, gpu, work, raw)
            launches["dp"] = dp_counts
            phase_done("dp")
    # The kernels line reads this slice's paths, each kernel all its numbers
    # from one: K1 and K2 from eval pass 1 (launches) and its first batch's
    # calls (error, times, bound), K1-bwd from the timed train steps on
    # real episodes (launches) and one more step's calls.
    if "eval" in want:
        for name, rec in kernel_records(eval_calls, where="eval").items():
            recs[name] = dict(rec, launches=eval_counts[name],
                              path="eval pass 1, " + CONFIG)
        del eval_calls
    for name, rec in recs.items():
        if name in ("group_norm", "vit_attention", "optim"):
            continue  # counted by their phases
        if path_launches:  # a forward's (a train step's) launches
            rec["launches_main_paths"] = {w: c[name]
                                          for w, c in path_launches.items()}
        if "runner" in launches:
            rec["launches_runner"] = launches["runner"][name]
            rec["launches_finetune"] = launches["finetune"][name]
        if "dp" in launches:
            rec["launches_dp"] = [c[name] for c in launches["dp"]]
        if "coco2voc" in launches:
            rec["launches_coco2voc"] = {
                run: c[name] + (c["nms_keep_unstaged"] if name == "nms_keep"
                                else 0)
                for run, c in launches["coco2voc"].items()}
            if name == "nms_keep":
                rec["launches_coco2voc"]["unstaged"] = {
                    run: c["nms_keep_unstaged"]
                    for run, c in launches["coco2voc"].items()}
                rec["coco2voc_unstaged"] = k2_unstaged
    print(f"phases: {time.perf_counter() - t0:.1f} s", flush=True)

    kernels = [{k: recs[name][k] for k in KERNEL_KEYS if k in recs[name]}
               for name in ("roi_align", "roi_align_backward", "nms_keep",
                            "group_norm", "vit_attention", "optim")
               if name in recs]
    print(gpu_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
