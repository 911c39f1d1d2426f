"""Random positive/negative sampling with static output shapes.

Port of the JAX package's ``ops/sample.py`` (mmdet RandomSampler), with
any leading batch dimensions in place of ``vmap``:

  * at most ``num * pos_fraction`` positives, uniformly at random;
  * the remaining ``num - n_pos`` slots filled with random negatives;
  * always ``num`` slots, with a validity mask where candidates run short;
  * positives in the first ``n_pos`` slots, negatives after them.

The uniform draws are an argument, ``u`` (..., 2, A): ``u[..., 0, :]``
ranks the positives and ``u[..., 1, :]`` the negatives. ``jax.random`` and
torch give different streams from one seed, so the caller chooses where
the draws come from (``torch.rand`` with a generator, or the JAX package's
own draws in a parity test).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SampleResult(NamedTuple):
    inds: torch.Tensor  # (..., num) int64 indices into the candidate axis
    is_pos: torch.Tensor  # (..., num) bool — slot holds a positive
    valid: torch.Tensor  # (..., num) bool — slot holds a real sample
    n_pos: torch.Tensor  # (...) int64


def _rand_topk_indices(u, mask, k: int):
    """Indices of up to k uniformly random True entries of mask (..., A),
    ranked by u (..., A). → (idx (..., k), picked (..., k) bool).

    The order is ``jax.lax.top_k``'s: descending, ties to the lower index
    (a stable sort; ``torch.topk`` breaks ties otherwise)."""
    A = mask.shape[-1]
    score = torch.where(mask, u, torch.full((), float("-inf"), dtype=u.dtype,
                                            device=u.device))
    k_eff = min(k, A)
    idx = torch.sort(score, dim=-1, descending=True, stable=True)[1][..., :k_eff]
    if k_eff < k:  # fewer candidates than slots: pad (never picked)
        idx = torch.cat([idx, idx.new_zeros(idx.shape[:-1] + (k - k_eff,))], -1)
    count = mask.sum(dim=-1, keepdim=True)
    slots = torch.arange(k, device=mask.device)
    picked = slots < count.clamp(max=k)
    return idx, picked


def random_sample_pos_neg(u, pos_mask, neg_mask, num: int,
                          pos_fraction: float) -> SampleResult:
    """u (..., 2, A) uniform draws in [0, 1); pos_mask, neg_mask (..., A)."""
    num_expected_pos = int(num * pos_fraction)
    pos_idx, pos_picked = _rand_topk_indices(u[..., 0, :], pos_mask,
                                             num_expected_pos)
    neg_idx, neg_picked = _rand_topk_indices(u[..., 1, :], neg_mask, num)

    n_pos = pos_picked.sum(dim=-1, keepdim=True)
    n_neg = torch.minimum(num - n_pos, neg_picked.sum(dim=-1, keepdim=True))

    slots = torch.arange(num, device=pos_mask.device)
    is_pos = slots < n_pos
    valid = slots < (n_pos + n_neg)
    # slot i: pos_idx[i] while positive, else neg_idx[i - n_pos]
    neg_slot = (slots - n_pos).clamp(0, num - 1)
    inds = torch.gather(neg_idx, -1, neg_slot)
    if num_expected_pos > 0:
        pos_slot = slots.clamp(0, num_expected_pos - 1).expand_as(neg_slot)
        inds = torch.where(is_pos, torch.gather(pos_idx, -1, pos_slot), inds)
    else:
        inds = torch.where(is_pos, torch.zeros_like(inds), inds)
    return SampleResult(inds=inds, is_pos=is_pos, valid=valid,
                        n_pos=n_pos[..., 0])
