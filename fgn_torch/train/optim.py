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
the number of updates applied before this one.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

# Top-level module names (the flax ones) that belong to the RoI head.
ROI_HEAD_MODULES = (
    "shared5", "rel_conv_roi", "rel_conv_spp", "rel_gn",
    "fc_cls", "fc_reg",
    "mask_convs_0", "mask_convs_1", "mask_convs_2", "mask_convs_3",
    "mask_deconv", "mask_logits",
)
OPTIMIZERS = ("adagrad", "adam", "sgd", "adadelta")


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

    def _scale(self, p, g):
        """The scaler's update direction for p, its state advanced."""
        st = self.state[p]
        if self.kind == "adagrad":
            acc = st.setdefault("acc", torch.full_like(p, 0.1))
            acc.add_(g * g)
            inv = torch.where(acc > 0, torch.rsqrt(acc + 1e-7),
                              torch.zeros((), device=p.device))
            return inv * g
        if self.kind == "adam":
            mu = st.setdefault("mu", torch.zeros_like(p))
            nu = st.setdefault("nu", torch.zeros_like(p))
            t = st["t"] = st.get("t", 0) + 1
            mu.copy_(0.1 * g + 0.9 * mu)
            nu.copy_(0.001 * (g * g) + 0.999 * nu)
            # bias corrections rounded to float32, as optax computes them
            c1 = float(1.0 - torch.tensor(0.9, dtype=torch.float32) ** t)
            c2 = float(1.0 - torch.tensor(0.999, dtype=torch.float32) ** t)
            return (mu / c1) / (torch.sqrt(nu / c2) + 1e-8)
        if self.kind == "sgd":
            m = st.setdefault("m", torch.zeros_like(p))
            m.copy_(g + 0.9 * m)
            return g + 0.9 * m
        eg = st.setdefault("eg", torch.zeros_like(p))
        ex = st.setdefault("ex", torch.zeros_like(p))
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
        for group in self.param_groups:
            if group["label"] == "frozen":
                continue
            step_size = (-group["lr_mult"] * lr).item()
            for p in group["params"]:
                if k > 1:
                    g = self.state[p]["acc_grad"]
                else:
                    g = p.grad if p.grad is not None else torch.zeros_like(p)
                u = self._scale(p, g) + group["weight_decay"] * p
                p.add_(step_size * u)
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
