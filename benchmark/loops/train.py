"""Back-to-back training steps: ``make_train_step(model,
build_optimizer(...))``'s ``step(batch, draws=...)`` with the
configuration's optimizer and schedule, each step's batch taken in turn
from a pool of distinct seeded batches in pinned host memory and
uploaded, its samplers' uniform draws made from the seed.

Set-up builds the one training object and drives it through the first
three steps (pool batches 0-2) through the window's own call and feed;
they give the readings the reference is held to (each step's loss, the
first gradient's norm a leaf as the optimizer consumed it, the
parameters' change a leaf after the three) and the proposals the second
stage took. The window carries on with the same object.

Traffic parameters: ``batch``, ``pool``, ``profile`` (steps in the traced
stretch), ``timed`` (steps with CUDA events around the backward and the
optimizer's step).

End-to-end: ``train_imgs_s``, the images of every step completed in the
window over its seconds; the window closes on a synchronize after the
first step that ends past ``--seconds``.
"""

from __future__ import annotations

import time
from unittest import mock

import torch

from benchmark.harness import common, compare, flops, trace
from benchmark.harness.common import log
from benchmark.harness.data import make_pool, mix, upload

CHECKED_STEPS = 3


def draws_for(seed: int, step: int, dev):
    """The samplers' uniform draws of step ``step``: one stream a draw."""
    def draws(name, shape):
        g = torch.Generator(device=dev).manual_seed(mix(seed, "draws", step, name))
        return torch.rand(shape, generator=g, device=dev)
    return draws


def schedule(opt_cfg):
    from fgn_torch.train.optim import make_lr_schedule

    return make_lr_schedule(
        opt_cfg["lr"], steps_per_epoch=opt_cfg["steps_per_epoch"],
        decay_epochs=opt_cfg["decay_epochs"], gamma=opt_cfg["gamma"],
        warmup_iters=opt_cfg["warmup_iters"],
        warmup_ratio=opt_cfg["warmup_ratio"], min_lr=opt_cfg["min_lr"])


class Trainer:
    """The training object: the program's model, optimizer and step."""

    def __init__(self, ctx):
        from fgn_torch.data.batching import EpisodeBatch
        from fgn_torch.train.optim import build_optimizer
        from fgn_torch.train.train_step import make_train_step

        cfg = ctx.cell.config
        o = cfg["optimizer"]
        self.model = common.program_model(cfg, ctx.seed, ctx.dev).train()
        if ctx.dev.type == "cuda":
            from fgn_torch.ops import _build

            _build.load_all()
        self.opt = build_optimizer(
            self.model, base_lr=o["lr"], weight_decay=o["weight_decay"],
            optimizer=o["type"], roi_head_lr_mult=o["roi_head_lr_mult"],
            schedule=schedule(o),
            frozen_modules=("backbone",) if cfg["model"]["backbone_frozen"] else ())
        self.step_fn = make_train_step(self.model, self.opt)
        self.episode = EpisodeBatch
        self.dev = ctx.dev
        self.seed = ctx.seed

    def step(self, pinned, k: int):
        b = upload(pinned, self.dev)
        return self.step_fn(self.episode(*b), draws=draws_for(self.seed, k, self.dev))


def first_steps(tr: Trainer, pool):
    """Steps 0-2 → the program's readings: losses, first-gradient and
    change norms a leaf, and each step's proposals (host copies)."""
    named = dict(tr.model.named_parameters())
    p0 = {n: p.detach().clone() for n, p in named.items()}
    props = []
    original = tr.model.get_proposals

    def kept(*a, **k):
        out = original(*a, **k)
        props.append(tuple(t.detach().cpu() for t in out))
        return out

    losses, grad = [], {}
    with mock.patch.object(tr.model, "get_proposals", kept):
        for k in range(CHECKED_STEPS):
            losses.append(float(tr.step(pool[k % len(pool)], k)["loss_total"]))
            if k == 0:
                grad = {n: float(p.grad.norm()) if p.grad is not None else 0.0
                        for n, p in named.items()}
    delta = {n: float((p.detach() - p0[n]).norm()) for n, p in named.items()}
    return {"losses": losses, "grad": grad, "delta": delta, "proposals": props}


def _rows(props, B: int):
    """The program's proposals of a step (boxes, scores, valid) at the
    batch's ``B`` rows: rows it did not give are empty (invalid)."""
    if props[0].shape[0] >= B:
        return props
    n = B - props[0].shape[0]
    return tuple(torch.cat([t, t.new_zeros((n,) + t.shape[1:])]) for t in props)


def reference_steps(ctx, pool, props, precision="f32"):
    """The reference's three steps from the same weights, inputs and
    draws, the second stage at the given proposals; and the errors of
    step 0's proposals (``compare.proposal_errors``)."""
    from benchmark.reference.optim import Adagrad
    from benchmark.reference.precision import strict_f32

    cfg = ctx.cell.config
    m = cfg["model"]
    ref = common.reference_model(cfg, ctx.seed, ctx.dev, precision)
    opt = Adagrad(ref.named_parameters(), cfg["optimizer"],
                  ("backbone",) if m["backbone_frozen"] else ())
    named = dict(ref.named_parameters())
    p0 = {n: p.detach().clone() for n, p in named.items()}
    props = [_rows(p, pool[0].qry_img.shape[0]) for p in props]
    b0 = upload(pool[0], ctx.dev)
    prop_err = compare.proposal_errors(ref, cfg, b0, *(t.to(ctx.dev) for t in props[0]))
    losses, grad = [], {}
    with strict_f32():
        for k in range(CHECKED_STEPS):
            batch = upload(pool[k % len(pool)], ctx.dev)
            for p in named.values():
                p.grad = None
            out = ref.train_losses(batch, draws_for(ctx.seed, k, ctx.dev),
                                   props[k][0].to(ctx.dev), props[k][2].to(ctx.dev))
            total = sum(v for n, v in out.items() if n.startswith("loss_"))
            total.backward()
            losses.append(float(total.detach()))
            if k == 0:
                grad = {n: float(p.grad.norm()) if p.grad is not None else 0.0
                        for n, p in named.items()}
            opt.step()
    delta = {n: float((p.detach() - p0[n]).norm()) for n, p in named.items()}
    return {"losses": losses, "grad": grad, "delta": delta, **prop_err}


def check(ctx, pool, prog):
    ref_run = reference_steps(ctx, pool, prog["proposals"])
    log("check: losses program " + ", ".join(f"{v:.8g}" for v in prog["losses"])
        + "; reference " + ", ".join(f"{v:.8g}" for v in ref_run["losses"]))
    return compare.train_readings(prog, ref_run)


def run(ctx) -> common.Outcome:
    tr_cfg = ctx.cell.traffic
    nb = tr_cfg["batch"]
    ctx.mark("imports")
    pool = make_pool(ctx.cell.config, nb, tr_cfg["pool"], ctx.seed, ctx.dev, with_gt=True)
    ctx.mark("pool")
    trainer = Trainer(ctx)
    ctx.mark("model, optimizer and kernels")
    prog = first_steps(trainer, pool)
    ctx.mark("three checked steps")
    ctx.card("window opens")
    setup_s = time.time() - ctx.t_start
    k = CHECKED_STEPS
    totals = []
    t_open = time.perf_counter()
    deadline = t_open + ctx.seconds
    while time.perf_counter() < deadline:
        totals.append(trainer.step(pool[k % len(pool)], k)["loss_total"])
        k += 1
    if ctx.dev.type == "cuda":
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t_open
    ctx.card("window closes")
    peak = ctx.peak_bytes()
    steps = len(totals)
    failed = int((~torch.isfinite(torch.stack(totals))).sum())
    note = f"train: {steps} steps of {nb} in {window_s!r} s"
    log(note)
    metrics = {"train_imgs_s": steps * nb / window_s, "setup_s": setup_s}
    rec = None
    if ctx.trace:
        rec = trace.Records()
        rec.rate_imgs_s = steps * nb / window_s
        rec.flops_per_img = flops.train_flops_per_img(ctx.cell.config, nb)
        if ctx.dev.type == "cuda":
            p = flops.peaks(torch.cuda.get_device_name(ctx.dev))
            rec.peak_flops, rec.hbm_bytes_s = p["bf16"], p["hbm"]

        def units(r):
            nonlocal k
            for _ in range(tr_cfg["profile"]):
                with torch.profiler.record_function("bench/unit"):
                    trainer.step(pool[k % len(pool)], k)
                k += 1
                if r is not None:
                    r.units += 1

        trace.profile(units, ctx.spans, rec, ctx.nodes)
        if ctx.dev.type == "cuda":
            timer = trace.EventTimer()
            with mock.patch.object(torch.Tensor, "backward",
                                   timer.timed("backward", torch.Tensor.backward)), \
                    mock.patch.object(trainer.opt, "step",
                                      timer.timed("optimizer", trainer.opt.step)):
                for _ in range(tr_cfg["timed"]):
                    trainer.step(pool[k % len(pool)], k)
                    k += 1
            rec.timings_ms.update(timer.ms())
    del trainer
    ctx.free()
    readings = check(ctx, pool, prog)
    return common.Outcome(metrics=metrics, attempted=steps, failed=failed,
                          readings=readings, rec=rec, peak_bytes=peak, notes=[note])
