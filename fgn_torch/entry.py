"""The port's single-call entry point: the flagship's episodic inference.

Twin of the JAX package's ``__graft_entry__.entry()``: ``entry()`` returns
``(fn, example_args)``, and ``fn(*example_args)`` runs ``FGN.test_forward``
on the flagship (OMNIISEG N3K3 geometry: R50-C4, GN, unfrozen backbone,
bf16 compute, seeded random weights) over ``toy_batch(B=1, H=480, W=480,
N=3, K=3, S=128)``. Where the JAX ``fn`` takes the flax parameters, this
one takes the model, whose parameters it holds; both run on the device
given (default ``cuda``; pass ``device="cpu"`` for the CPU).

The multi-device dry run of the same file has its twin in
``parallel/dryrun.py``.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from fgn_torch.config import FGNConfig
from fgn_torch.data.batching import EpisodeBatch, to_device, toy_batch
from fgn_torch.models.fgn import FGN, build_model

FLAGSHIP_CFG = dict(n_ways=3, k_shots=3, backbone_norm="gn",
                    backbone_frozen=False, compute_dtype="bfloat16")


def fn(model: FGN, batch: EpisodeBatch) -> Dict[str, torch.Tensor]:
    """Episodic inference: ``model.test_forward(batch)``."""
    return model.test_forward(batch)


def entry(device="cuda") -> Tuple[Callable, Tuple[FGN, EpisodeBatch]]:
    """(fn, example_args): the flagship's ``test_forward`` and its b1 480 px
    example episode, both on ``device``."""
    model = build_model(FGNConfig(**FLAGSHIP_CFG), device, seed=0)
    batch = to_device(toy_batch(B=1, H=480, W=480, N=3, K=3, S=128), device)
    return fn, (model, batch)
