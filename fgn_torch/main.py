"""Config helpers of the train / finetune / evaluate driver.

The JAX package's ``main.py`` (the reference's entry point,
subprojects/sp02_omniiseg_fgn_mmdet/main.py:364-501) builds the datasets,
the model, the optimizer and the runner from a config file. Its two config
helpers are here: the model's ``FGNConfig`` from a config's ``model`` dict
and the reference's batch-size heuristic.
"""

from __future__ import annotations

import dataclasses

from fgn_torch.config import Config, FGNConfig


def model_config_from_cfg(cfg: Config) -> FGNConfig:
    fields = {f.name for f in dataclasses.fields(FGNConfig)}
    kwargs = {k: v for k, v in dict(cfg.model).items() if k in fields}
    for k in ("anchor_scales", "anchor_ratios", "rcnn_bbox_stds"):
        if k in kwargs:
            kwargs[k] = tuple(kwargs[k])
    return FGNConfig(**kwargs)


def batch_heuristic(n_ways: int, k_shots: int) -> int:
    """Reference batch-size heuristic by (N, K)
    (main.py:487-501): N1K1 → 12, N3K1 → 10, N3K3 → 8.

    N3K1 is capped at 8 here for QUALITY: b10 under-trains
    way-classification on this data (0.235 vs 0.951 fresh bbox mAP,
    RESULTS.md "N3K1 batch-10")."""
    if n_ways == 1 and k_shots == 1:
        return 12
    return 8
