"""Train and eval steps, on one device or data-parallel over ranks.

Port of the JAX package's ``train/train_step.py``: the train step is
``train_forward`` → ``loss_total`` (the sum of the ``loss_*`` entries) →
backward → one optimizer step; the eval step is ``test_forward`` with its
outputs packed into two tensors.

With a ``mesh`` (``parallel/mesh.py``) each rank steps its rows of the
global batch. JAX runs one program over the global batch and XLA inserts
the collectives; here they are explicit and give the same result up to the
order of summation:

  * every loss divides by counts summed over the ranks
    (``FGN.train_forward(..., mesh=)``), so a rank's loss is its share of
    the global loss, and the gradient of the global loss is the SUM over
    the ranks of the local gradients (``sum_gradients``, after
    ``backward``, in buckets in the parameters' order);
  * the returned ``loss_*`` and ``loss_total`` are summed over the ranks;
    the diagnostics are the global batch's already;
  * the eval step gathers both packed outputs back into the global batch's
    row order on every rank, as JAX's replicated outputs.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from fgn_torch.data.batching import EpisodeBatch
from fgn_torch.models.fgn import FGN, Draws
from fgn_torch.parallel.mesh import (
    Mesh, all_gather_rows, global_sum, sum_gradients,
)
from fgn_torch.utils.profiling import span, unit


def total_loss(losses: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Σ of the ``loss_*`` entries, in the dict's order."""
    return sum(v for k, v in losses.items() if k.startswith("loss_"))


def _updated_params(optimizer: torch.optim.Optimizer):
    """The parameters that the optimizer updates: every group but the one
    labelled ``frozen`` (``FGNOptimizer``), in the groups' order."""
    return [p for g in optimizer.param_groups if g.get("label") != "frozen"
            for p in g["params"]]


def make_train_step(model: FGN, optimizer: torch.optim.Optimizer,
                    mesh: Optional[Mesh] = None):
    """→ step(batch, generator=None, draws=None) → metrics: the
    ``train_forward`` outputs (detached) plus ``loss_total``, those of the
    global batch under a ``mesh``. The parameters and the optimizer's state
    are updated in place. Under a ``mesh``, ``batch`` is this rank's rows
    (``shard_batch``) and ``draws`` this rank's rows of the global
    draws."""
    params = _updated_params(optimizer)

    def step(batch: EpisodeBatch, generator: Optional[torch.Generator] = None,
             draws: Optional[Draws] = None) -> Dict[str, torch.Tensor]:
        with unit("step"):
            with span("forward"):
                losses = model.train_forward(batch, generator=generator,
                                             draws=draws, mesh=mesh)
                total = total_loss(losses)
            with span("optimizer"):
                optimizer.zero_grad(set_to_none=True)
            with span("backward"):
                total.backward()
                sum_gradients(params, mesh)
            with span("optimizer"):
                optimizer.step()
            metrics = {k: v.detach() for k, v in losses.items()}
            metrics["loss_total"] = total.detach()
            if mesh is not None and mesh.group is not None:
                keys = [k for k in metrics if k.startswith("loss_")]
                sums = global_sum(torch.stack([metrics[k] for k in keys]),
                                  mesh)
                metrics.update(zip(keys, sums.unbind()))
            return metrics

    return step


def make_eval_step(model: FGN, mesh: Optional[Mesh] = None,
                   packed: bool = True):
    """→ step(batch) → ``test_forward``'s outputs. ``packed=True`` returns
    two entries instead of eight: the per-detection tensors concatenated
    into one (B, M, 7) float32 tensor (boxes | score | cat | valid) and the
    mask logits; the proposals are dropped. ``unpack_eval_out`` inverts it
    exactly: float32 carries the int32 cats and the bool valid losslessly.
    Under a ``mesh`` (packed only), ``batch`` is this rank's rows and both
    entries are gathered back into the global batch on every rank."""
    if mesh is not None and mesh.group is not None and not packed:
        raise ValueError("make_eval_step: a mesh gathers the packed outputs "
                         "only")

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
        return {"dt_pack": all_gather_rows(pack, mesh),
                "dt_mask_logits": all_gather_rows(out["dt_mask_logits"],
                                                  mesh)}

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


def unpack_eval_out_np(out: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """``unpack_eval_out`` on host arrays: the evaluator copies the two
    packed leaves to the host and unpacks them there."""
    if "dt_pack" not in out:
        return out
    pack = np.asarray(out["dt_pack"])
    return {
        "dt_boxes": pack[..., :4],
        "dt_scores": pack[..., 4],
        "dt_cats": pack[..., 5].astype(np.int32),
        "dt_valid": pack[..., 6] > 0.5,
        "dt_mask_logits": np.asarray(out["dt_mask_logits"]),
    }
