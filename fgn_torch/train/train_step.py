"""Train and eval steps on one device.

Port of the JAX package's ``train/train_step.py`` without the mesh: the
train step is ``train_forward`` → ``loss_total`` (the sum of the ``loss_*``
entries) → backward → one optimizer step. Data parallelism comes with a
later slice.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from fgn_torch.data.batching import EpisodeBatch
from fgn_torch.models.fgn import FGN, Draws


def total_loss(losses: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Σ of the ``loss_*`` entries, in the dict's order."""
    return sum(v for k, v in losses.items() if k.startswith("loss_"))


def make_train_step(model: FGN, optimizer: torch.optim.Optimizer):
    """→ step(batch, generator=None, draws=None) → metrics: the
    ``train_forward`` outputs (detached) plus ``loss_total``. The
    parameters and the optimizer's state are updated in place."""

    def step(batch: EpisodeBatch, generator: Optional[torch.Generator] = None,
             draws: Optional[Draws] = None) -> Dict[str, torch.Tensor]:
        losses = model.train_forward(batch, generator=generator, draws=draws)
        total = total_loss(losses)
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        optimizer.step()
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["loss_total"] = total.detach()
        return metrics

    return step


def make_eval_step(model: FGN, packed: bool = True):
    """→ step(batch) → ``test_forward``'s outputs. ``packed=True`` returns
    two entries instead of eight: the per-detection tensors concatenated
    into one (B, M, 7) float32 tensor (boxes | score | cat | valid) and the
    mask logits; the proposals are dropped. ``unpack_eval_out`` inverts it
    exactly: float32 carries the int32 cats and the bool valid losslessly."""

    def step(batch: EpisodeBatch) -> Dict[str, torch.Tensor]:
        out = model.test_forward(batch)
        if not packed:
            return out
        pack = torch.cat([
            out["dt_boxes"].to(torch.float32),
            out["dt_scores"].to(torch.float32)[..., None],
            out["dt_cats"].to(torch.float32)[..., None],
            out["dt_valid"].to(torch.float32)[..., None],
        ], dim=-1)
        return {"dt_pack": pack, "dt_mask_logits": out["dt_mask_logits"]}

    return step


def unpack_eval_out(out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Inverse of the packed eval-step output (a no-op on unpacked output)."""
    if "dt_pack" not in out:
        return out
    pack = out["dt_pack"]
    return {
        "dt_boxes": pack[..., :4],
        "dt_scores": pack[..., 4],
        "dt_cats": pack[..., 5].to(torch.int32),
        "dt_valid": pack[..., 6] > 0.5,
        "dt_mask_logits": out["dt_mask_logits"],
    }
