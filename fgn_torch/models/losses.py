"""Loss primitives with masked static-shape semantics.

Port of the JAX package's ``models/losses.py``: every loss is a weighted
sum divided by an explicit ``avg_factor`` (clamped at 1), as mmdet's
``weight_reduce_loss`` does; logits are cast to float32 inside.

  * ``sigmoid_bce`` — the RPN classification and mask losses;
  * ``softmax_ce`` — the RCNN classification loss;
  * ``smooth_l1`` — the RPN and RCNN box losses;
  * ``accuracy_balanced`` — plain and balanced accuracy (sklearn's
    ``balanced_accuracy_score`` over the classes present).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _avg(avg_factor):
    if isinstance(avg_factor, torch.Tensor):
        return avg_factor.to(torch.float32).clamp(min=1.0)
    return max(float(avg_factor), 1.0)


def sigmoid_bce(logits, targets, weights, avg_factor):
    """Weighted binary cross entropy from logits, summed / avg_factor."""
    logits = logits.to(torch.float32)
    targets = targets.to(torch.float32)
    # Numerically stable: max(x,0) - x*t + log1p(exp(-|x|))
    per = (logits.clamp(min=0.0) - logits * targets
           + torch.log1p(torch.exp(-logits.abs())))
    return (per * weights).sum() / _avg(avg_factor)


def softmax_ce(logits, labels, weights, avg_factor):
    """Weighted softmax cross entropy, summed / avg_factor. logits (..., C),
    labels (...) int."""
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    picked = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return (-picked * weights).sum() / _avg(avg_factor)


def smooth_l1(pred, target, weights, avg_factor, beta: float = 1.0):
    """Weighted smooth-L1 (Huber), summed / avg_factor."""
    diff = (pred.to(torch.float32) - target.to(torch.float32)).abs()
    per = torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)
    return (per * weights).sum() / _avg(avg_factor)


def accuracy_balanced(logits, labels, weights, n_classes: int):
    """(plain accuracy, balanced accuracy) over weighted samples: balanced
    accuracy is the mean per-class recall over the classes that appear
    among the valid labels."""
    valid = (weights > 0).to(torch.float32)
    correct = (logits.argmax(dim=-1) == labels).to(torch.float32) * valid
    acc = correct.sum() / valid.sum().clamp(min=1.0)
    onehot = F.one_hot(labels.long(), n_classes).to(torch.float32) * valid[..., None]
    dims = tuple(range(onehot.dim() - 1))
    per_class_total = onehot.sum(dim=dims)
    per_class_correct = (onehot * correct[..., None]).sum(dim=dims)
    present = per_class_total > 0
    recall = per_class_correct / per_class_total.clamp(min=1.0)
    bal = (torch.where(present, recall, torch.zeros_like(recall)).sum()
           / present.to(torch.float32).sum().clamp(min=1.0))
    return acc, bal
