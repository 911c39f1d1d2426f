"""flax param tree (numpy) → ``state_dict`` of ``fgn_torch.models.fgn.FGN``.

The input is a nested mapping of numpy arrays, e.g. the JAX package's
``jax.device_get(model.init(...))``; nothing here imports JAX. Paths map
name for name (``backbone/layer1/block0/conv1/kernel`` →
``backbone.layer1.block0.conv1.weight``) and leaves are re-laid out:

  * conv kernels HWIO → OIHW;
  * dense kernels (in, out) → (out, in);
  * GroupNorm and FrozenAffine ``scale``/``bias`` → ``weight``/``bias``;
  * ``mask_deconv`` (flax ``ConvTranspose``) (kh, kw, in, out) →
    (in, out, kh, kw), flipped on both spatial axes: flax does not flip the
    kernel of a transposed convolution, ``F.conv_transpose2d`` does.

Any leaf that does not map, and any torch parameter left without a leaf,
raises.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

_DECONVS = frozenset({"mask_deconv"})


def _leaves(tree: Mapping, prefix=()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            if not isinstance(v, np.ndarray):
                raise TypeError(
                    f"bridge: leaf {'/'.join(prefix + (str(k),))} is "
                    f"{type(v).__name__}, want numpy (jax.device_get first)"
                )
            yield prefix + (str(k),), v


def flax_to_state_dict(params: Mapping) -> Dict[str, np.ndarray]:
    """Flax param tree → {torch name: numpy array in torch layout}."""
    if "params" in params and isinstance(params["params"], Mapping):
        params = params["params"]
    out = {}
    for path, leaf in _leaves(params):
        *mods, name = path
        prefix = ".".join(mods)
        if name == "kernel" and leaf.ndim == 4:
            if mods[-1] in _DECONVS:
                w = leaf.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
            else:
                w = leaf.transpose(3, 2, 0, 1)
        elif name == "kernel" and leaf.ndim == 2:
            w = leaf.T
        elif name in ("scale", "bias") and leaf.ndim == 1:
            w = leaf
        else:
            raise KeyError(f"bridge: unmapped flax leaf {'/'.join(path)} "
                           f"{leaf.shape}")
        key = f"{prefix}.{'bias' if name == 'bias' else 'weight'}"
        out[key] = np.array(w, dtype=np.float32, order="C")  # owned, writable
    return out


def load_flax_params(model: torch.nn.Module, params: Mapping) -> None:
    """Load a flax param tree into ``model`` in place. Raises on any leaf
    without a torch parameter, any parameter without a leaf, or a shape
    mismatch."""
    sd = flax_to_state_dict(params)
    want = dict(model.state_dict())
    extra = sorted(set(sd) - set(want))
    missing = sorted(set(want) - set(sd))
    if extra or missing:
        raise KeyError(
            f"bridge: {len(extra)} flax leaves unmapped {extra[:5]}, "
            f"{len(missing)} torch params without a leaf {missing[:5]}"
        )
    for k, v in sd.items():
        if tuple(want[k].shape) != v.shape:
            raise ValueError(
                f"bridge: {k} has shape {v.shape}, torch wants "
                f"{tuple(want[k].shape)}"
            )
    model.load_state_dict(
        {k: torch.from_numpy(v).to(want[k].device) for k, v in sd.items()},
        strict=True,
    )
