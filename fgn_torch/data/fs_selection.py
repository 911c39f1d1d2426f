"""Greedy finetune image selection.

Rebuild of the reference's ``select_indices``
(datasets/fewshotiseg/fs_selection.py:8-212): choose a minimal image
subset whose per-category instance counts land in [budget, budget + 1]
for every allowed category — budget = 3K for base categories, K + 1 for
novel ones (reference :106-194). Candidate images are those with ZERO
instances of disallowed categories (:38-40) and no single image may
overshoot a category budget on its own (:50-54).

The result is cached as ``*_FINETUNE_REAL_INDICES.json`` (:25-27,206).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from fgn_torch.utils.io import read_json, write_json_unsafe


def select_indices(
    img_cat_counts: np.ndarray,  # (P, C) instance counts per image
    cats_allowed: np.ndarray,  # (C,) bool
    budget: int,
    cache_fp: Optional[str] = None,
    seed: int = 0,
) -> List[int]:
    """Greedy selection; returns image indices (into the P axis)."""
    if cache_fp and os.path.isfile(cache_fp):
        return [int(i) for i in read_json(cache_fp)]

    counts = np.asarray(img_cat_counts, np.int64)
    allowed = np.asarray(cats_allowed, bool)
    P, C = counts.shape

    # Candidates: zero instances of disallowed cats; no self-overshoot.
    disallowed_hits = counts[:, ~allowed].sum(axis=1) if (~allowed).any() else 0
    ok = (np.asarray(disallowed_hits) == 0) & (
        counts[:, allowed].max(axis=1, initial=0) <= budget + 1
    )
    candidates = np.nonzero(ok)[0]

    have = np.zeros(C, np.int64)
    chosen: List[int] = []
    chosen_mask = np.zeros(P, bool)
    allowed_idx = np.nonzero(allowed)[0]

    # Rarest-category-first greedy (reference :106-194): repeatedly take
    # the most-starved category and add the candidate image that helps it
    # without overshooting any category past budget + 1.
    rng = np.random.RandomState(seed)
    order = candidates[rng.permutation(len(candidates))]
    progress = True
    while progress:
        deficits = budget - have[allowed_idx]
        if (deficits <= 0).all():
            break
        progress = False
        cat = allowed_idx[int(np.argmax(deficits))]
        for i in order:
            if chosen_mask[i] or counts[i, cat] == 0:
                continue
            new = have + counts[i]
            if (new[allowed_idx] > budget + 1).any():
                continue
            chosen.append(int(i))
            chosen_mask[i] = True
            have = new
            progress = True
            break

    # Self-check (reference fs_selection.py keeps an assert): never
    # overshoot; warn (not fail) if the pool can't reach the budget.
    assert (have[allowed_idx] <= budget + 1).all()
    short = allowed_idx[have[allowed_idx] < budget]
    if len(short):
        print(
            f"WARNING fs_selection: cats {short.tolist()} below budget "
            f"{budget} (counts {have[short].tolist()}) — pool exhausted"
        )
    chosen.sort()
    if cache_fp:
        write_json_unsafe(cache_fp, chosen)
    return chosen
