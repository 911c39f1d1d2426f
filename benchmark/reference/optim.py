"""The reference's optimizer: Adagrad as the FGN reference's optax chain
applies it (``fgn_train_schedule.py``), in float32.

Per parameter p with gradient g: acc starts at 0.1; acc += g²;
u = g · rsqrt(acc + 1e-7); u += weight_decay · p (decoupled, after the
scaler, on every parameter); p -= lr_mult · lr(step) · u, with lr_mult the
RoI head's multiplier for its modules and 1 elsewhere. lr(step) is a
linear warmup from ``warmup_ratio`` over ``warmup_iters`` steps, times a
step decay by ``gamma`` at each of ``decay_epochs``, floored at ``min_lr``.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch

ROI_HEAD_MODULES = (
    "shared5", "rel_conv_roi", "rel_conv_spp", "rel_gn", "fc_cls", "fc_reg",
    "mask_convs_0", "mask_convs_1", "mask_convs_2", "mask_convs_3",
    "mask_deconv", "mask_logits",
)


def lr_at(step: int, opt: Dict) -> float:
    warm = opt["warmup_ratio"] + (1.0 - opt["warmup_ratio"]) * min(
        step / max(opt["warmup_iters"], 1), 1.0)
    factor = 1.0
    for e in opt["decay_epochs"]:
        if step >= int(e * opt["steps_per_epoch"]):
            factor *= opt["gamma"]
    return max(opt["lr"] * factor * warm, opt["min_lr"])


class Adagrad:
    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                 opt: Dict, frozen_modules=()):
        self.opt = opt
        self.params = []  # (param, lr multiplier)
        for name, p in named_params:
            top = name.split(".", 1)[0]
            if top in frozen_modules:
                continue
            mult = opt["roi_head_lr_mult"] if top in ROI_HEAD_MODULES else 1.0
            self.params.append((p, mult))
        self.acc = [torch.full_like(p, 0.1) for p, _ in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self):
        lr = lr_at(self.count, self.opt)
        wd = self.opt["weight_decay"]
        for (p, mult), acc in zip(self.params, self.acc):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            acc.add_(g * g)
            u = g * torch.rsqrt(acc + 1e-7) + wd * p
            p.add_(-(mult * lr) * u)
        self.count += 1
