"""Optimizer and learning-rate schedules, the JAX package's ``train/optim.py``
(an optax chain there) written as one ``torch.optim.Optimizer``.

  * Adagrad (or Adam, SGD, Adadelta), lr 5e-3, weight decay 1e-5;
  * the RoI head's modules at 0.1× lr (``ROI_HEAD_MODULES``), modules
    named in ``frozen_modules`` never updated;
  * linear warmup, then step decay or cosine annealing, floored at
    ``min_lr``;
  * ``cumulative_iters``: gradients averaged over k calls of ``step`` and
    one update applied (optax ``MultiSteps``); the schedule advances once
    per applied update.

The update rules are written by hand because ``torch.optim``'s differ from
the reference's optax chain: weight decay is decoupled and applied AFTER
the scaler, to every parameter (biases and norm scales included), and
Adagrad's accumulator starts at 0.1 with ``rsqrt(acc + 1e-7)``. Per
parameter p with gradient g, in float32:

  * adagrad: acc += g²; u = g · rsqrt(acc + 1e-7) where acc > 0, else 0;
  * adam (b1 0.9, b2 0.999, eps 1e-8): mu = 0.1 g + 0.9 mu;
    nu = 0.001 g² + 0.999 nu; t += 1;
    u = (mu / (1 - 0.9^t)) / (sqrt(nu / (1 - 0.999^t)) + 1e-8);
  * sgd (momentum 0.9, Nesterov): m = g + 0.9 m; u = g + 0.9 m;
  * adadelta (rho 0.9, eps 1e-6): eg = 0.1 g² + 0.9 eg;
    u = sqrt(ex + 1e-6) / sqrt(eg + 1e-6) · g; ex = 0.1 u² + 0.9 ex;

then u += wd · p and p += -(lr_mult · schedule(count)) · u, count being
the number of updates applied before this one. Adam's bias corrections are
rounded to float32, as optax computes them, and applied through their
reciprocals, as torch on CUDA divides a tensor by a Python number.

Routes, chosen per tensor from what the step can observe: a CUDA float32
tensor under Adagrad or Adam goes to K5 (``ops/optim_cuda.py``: every such
tensor of a device in one launch, or a few; its gradient is the
``MultiSteps`` mean on the step that applies it; a layout the kernel cannot
walk raises), counted as ``k5.tensors``; every other updated tensor (the
CPU, float64, SGD, Adadelta) takes the plain route below, one tensor at a
time, counted as ``opt.plain_tensors``. Both give the same bits on the
card.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from fgn_torch.ops import optim_cuda
from fgn_torch.utils.profiling import count

# Top-level module names (the flax ones) that belong to the RoI head.
ROI_HEAD_MODULES = (
    "shared5", "rel_conv_roi", "rel_conv_spp", "rel_gn",
    "fc_cls", "fc_reg",
    "mask_convs_0", "mask_convs_1", "mask_convs_2", "mask_convs_3",
    "mask_deconv", "mask_logits",
)
OPTIMIZERS = ("adagrad", "adam", "sgd", "adadelta")
# Each rule's state tensors, in K5's record order (s0, s1).
_STATES = {"adagrad": ("acc",), "adam": ("mu", "nu"), "sgd": ("m",),
           "adadelta": ("eg", "ex")}


@functools.lru_cache(maxsize=256)
def adam_scales(t: int, dtype: torch.dtype) -> Tuple[float, float]:
    """1 / (1 - 0.9^t) and 1 / (1 - 0.999^t): the bias corrections rounded
    to float32, as optax computes them, and their reciprocals in ``dtype``,
    as torch on CUDA computes the reciprocal of a Python divisor."""
    out = []
    for b in (0.9, 0.999):
        c = float(1.0 - torch.tensor(b, dtype=torch.float32) ** t)
        out.append(float(np.float32(1.0) / np.float32(c))
                   if dtype == torch.float32 else 1.0 / c)
    return out[0], out[1]


def make_lr_schedule(
    base_lr: float,
    steps_per_epoch: int,
    decay_epochs: Sequence[int] = (3,),
    gamma: float = 0.1,
    warmup_iters: int = 100,
    warmup_ratio: float = 0.01,
    min_lr: float = 1e-6,
    type: str = "step",  # noqa: A002 — config key name (mmcv lr_config)
    min_lr_ratio: float = 0.01,
    total_epochs: int = 0,
) -> Callable[[int], float]:
    """step → learning rate: step decay (the reference's default) or
    cosine annealing to ``min_lr_ratio · base_lr``, times a linear warmup
    from ``warmup_ratio`` over ``warmup_iters`` steps, floored at
    ``min_lr``."""

    def warm(step):
        return warmup_ratio + (1.0 - warmup_ratio) * min(
            step / max(warmup_iters, 1), 1.0)

    if type == "cosine":
        total = max(int(total_epochs) * int(steps_per_epoch), 1)

        def schedule(step):
            t = min(max(step / total, 0.0), 1.0)
            cos = 0.5 * (1.0 + math.cos(math.pi * t))
            lr = base_lr * (min_lr_ratio + (1.0 - min_lr_ratio) * cos)
            return max(lr * warm(step), min_lr)

        return schedule

    boundaries = sorted(int(e * steps_per_epoch) for e in decay_epochs)

    def schedule(step):
        factor = 1.0
        for b in boundaries:
            if step >= b:
                factor *= gamma
        return max(base_lr * factor * warm(step), min_lr)

    return schedule


def param_label(name: str, frozen_modules: Sequence[str] = ()) -> str:
    """'frozen', 'roi' or 'main' for a parameter's dotted name."""
    top = name.split(".", 1)[0]
    if top in frozen_modules:
        return "frozen"
    return "roi" if top in ROI_HEAD_MODULES else "main"


class FGNOptimizer(torch.optim.Optimizer):
    """The reference's optimizer chain over parameter groups labelled
    'main' (lr × 1), 'roi' (lr × ``roi_head_lr_mult``) and 'frozen' (no
    update). ``step`` reads ``p.grad``; a parameter without one counts as a
    zero gradient, as in the JAX package, where every leaf has a
    gradient."""

    def __init__(self, named_params, optimizer: str = "adagrad",
                 weight_decay: float = 1e-5, roi_head_lr_mult: float = 0.1,
                 schedule: Callable[[int], float] = lambda step: 5e-3,
                 cumulative_iters: int = 1,
                 frozen_modules: Sequence[str] = ()):
        if optimizer not in OPTIMIZERS:
            raise ValueError(f"optimizer {optimizer!r} not in {OPTIMIZERS}")
        if cumulative_iters < 1:
            raise ValueError("cumulative_iters must be >= 1")
        groups = {"main": [], "roi": [], "frozen": []}
        for name, p in named_params:
            groups[param_label(name, frozen_modules)].append(p)
        mults = {"main": 1.0, "roi": roi_head_lr_mult, "frozen": 0.0}
        super().__init__(
            [{"params": ps, "label": k, "lr_mult": mults[k]}
             for k, ps in groups.items() if ps],
            dict(weight_decay=weight_decay),
        )
        self.kind = optimizer
        self.schedule = schedule
        self.cumulative_iters = int(cumulative_iters)
        # updates applied (the schedule's step) and calls of step() since
        # the last applied update
        self.state["count"] = 0
        self.state["mini_step"] = 0

    def _states(self, p):
        """p's state tensors (made at its first update) and, for Adam, its
        step count t advanced."""
        st = self.state[p]
        made = []
        for name in _STATES[self.kind]:
            if name not in st:
                st[name] = (torch.full_like(p, 0.1) if name == "acc"
                            else torch.zeros_like(p))
            made.append(st[name])
        if self.kind == "adam":
            st["t"] = st.get("t", 0) + 1
        return made

    def _scale(self, p, g, states):
        """The scaler's update direction for p, its state advanced."""
        if self.kind == "adagrad":
            (acc,) = states
            acc.add_(g * g)
            inv = torch.where(acc > 0, torch.rsqrt(acc + 1e-7),
                              torch.zeros((), device=p.device))
            return inv * g
        if self.kind == "adam":
            mu, nu = states
            r1, r2 = adam_scales(self.state[p]["t"], p.dtype)
            mu.copy_(0.1 * g + 0.9 * mu)
            nu.copy_(0.001 * (g * g) + 0.999 * nu)
            return (mu * r1) / (torch.sqrt(nu * r2) + 1e-8)
        if self.kind == "sgd":
            (m,) = states
            m.copy_(g + 0.9 * m)
            return g + 0.9 * m
        eg, ex = states
        eg.copy_(0.1 * (g * g) + 0.9 * eg)
        u = torch.sqrt(ex + 1e-6) / torch.sqrt(eg + 1e-6) * g
        ex.copy_(0.1 * (u * u) + 0.9 * ex)
        return u

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("FGNOptimizer.step takes no closure")
        k = self.cumulative_iters
        n = self.state["mini_step"]
        params = [p for group in self.param_groups for p in group["params"]]
        if k > 1:  # running mean of the gradients (optax MultiSteps)
            for p in params:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                acc = self.state[p].setdefault("acc_grad", torch.zeros_like(p))
                acc.add_((g - acc) / (n + 1))
            if n + 1 < k:
                self.state["mini_step"] = n + 1
                return None
            self.state["mini_step"] = 0
        lr = torch.tensor(self.schedule(self.state["count"]), dtype=torch.float32)
        fused, plain = {}, 0  # device → (its K5 tensors, their records)
        for group in self.param_groups:
            if group["label"] == "frozen":
                continue
            step_size = (-group["lr_mult"] * lr).item()
            wd = group["weight_decay"]
            for p in group["params"]:
                g = self.state[p]["acc_grad"] if k > 1 else p.grad
                states = self._states(p)
                if optim_cuda.takes(self.kind, p):
                    ps, rows = fused.setdefault(p.device, ([], []))
                    ps.append(p)
                    r = (adam_scales(self.state[p]["t"], p.dtype)
                         if self.kind == "adam" else (0.0, 0.0))
                    rows.append(optim_cuda.record(p, g, states, step_size,
                                                  wd, *r))
                    continue
                plain += 1
                if g is None:
                    g = torch.zeros_like(p)
                u = self._scale(p, g, states) + wd * p
                p.add_(step_size * u)
        count("opt.plain_tensors", plain)
        for device, (ps, rows) in fused.items():
            optim_cuda.run(self.kind, optim_cuda.pack(rows),
                           optim_cuda.plan(tuple(p.numel() for p in ps)),
                           device)
            torch.autograd.graph.increment_version(ps)
            count("k5.tensors", len(ps))
        if k > 1:
            for p in params:
                self.state[p]["acc_grad"].zero_()
        self.state["count"] += 1
        return None


def build_optimizer(model: torch.nn.Module, base_lr: float = 5e-3,
                    weight_decay: float = 1e-5, optimizer: str = "adagrad",
                    roi_head_lr_mult: float = 0.1, schedule=None,
                    cumulative_iters: int = 1,
                    frozen_modules: Sequence[str] = ()) -> FGNOptimizer:
    """The JAX package's ``build_optimizer`` over ``model``'s parameters,
    with the same arguments (``schedule`` None = constant ``base_lr``)."""
    return FGNOptimizer(
        model.named_parameters(), optimizer=optimizer,
        weight_decay=weight_decay, roi_head_lr_mult=roi_head_lr_mult,
        schedule=schedule or (lambda step: base_lr),
        cumulative_iters=cumulative_iters, frozen_modules=frozen_modules,
    )
