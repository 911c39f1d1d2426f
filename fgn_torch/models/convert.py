"""Torch checkpoint → FGN backbone (DenseCL / torchvision ResNet-50).

Port of the JAX package's ``models/convert.py``. The reference initializes
its backbone from a DenseCL torch checkpoint
(fgn_r50_c4_densecl.py:4-11,39-41; main.py:402-405). This module maps a
torchvision/mmcv-layout ResNet state_dict onto the port's ``ResNetC4``,
whose module names are the flax ones:

  * ``layer2.block3.conv2`` ← ``layer2.3.conv2``, ``ds_conv``/``ds_bn`` ←
    ``downsample.0``/``downsample.1``; conv weights stay OIHW (no
    transpose: both sides are torch's layout);
  * BatchNorms fold, in float64, into the ``FrozenAffine`` (weight, bias)
    pairs: weight = γ / sqrt(var + eps), bias = β − mean · weight;
  * keys are matched under several prefixes ('backbone.',
    'module.backbone.', 'module.', '') — DenseCL checkpoints carry a
    'backbone.'-prefixed state_dict.

Missing/unconvertible keys are REPORTED (printed with a count); the loader
raises if nothing at all matched, which catches a wrong layout loudly
instead of silently training from random init.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _fold_bn(gamma, beta, mean, var, eps: float = 1e-5):
    gamma = np.asarray(gamma, np.float64)
    beta = np.asarray(beta, np.float64)
    mean = np.asarray(mean, np.float64)
    var = np.asarray(var, np.float64)
    scale = gamma / np.sqrt(var + eps)
    bias = beta - mean * scale
    return scale.astype(np.float32), bias.astype(np.float32)


def _map_path(path: Tuple[str, ...]) -> str:
    """Port module path (with the parameter's name last) → torch module
    prefix.

    ('layer2', 'block3', 'conv2', 'weight') → 'layer2.3.conv2';
    downsample convs/bns ('ds_conv'/'ds_bn') → 'downsample.0/1'."""
    parts = []
    for name in path[:-1]:
        if name.startswith("block"):
            parts.append(name[len("block"):])
        elif name == "ds_conv":
            parts.append("downsample.0")
        elif name == "ds_bn":
            parts.append("downsample.1")
        else:
            parts.append(name)
    return ".".join(parts)


def load_torch_backbone(model: torch.nn.Module, checkpoint_fp: str,
                        verbose: bool = True) -> torch.nn.Module:
    """Fill ``model.backbone``'s parameters, in place, from a torch
    checkpoint; returns ``model``.

    Reports (and tolerates) missing torch keys so partial checkpoints can
    be probed, but raises when NOTHING matches — that means the layout
    assumption is wrong."""
    ckpt = torch.load(checkpoint_fp, map_location="cpu", weights_only=True)
    sd = ckpt.get("state_dict", ckpt)
    sd = {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v)
          for k, v in sd.items()}
    prefixes = ("backbone.", "module.backbone.", "module.", "")

    def find(key: str):
        for pre in prefixes:
            if pre + key in sd:
                return sd[pre + key]
        return None

    loaded, missing = [], []
    for name, p in model.backbone.named_parameters():
        names = tuple(name.split("."))
        torch_prefix = _map_path(names)
        leaf_name = names[-1]
        if p.dim() == 4:  # conv weight, OIHW on both sides
            w = find(torch_prefix + ".weight")
            if w is None:
                missing.append(torch_prefix + ".weight")
                continue
            if w.ndim != 4:
                missing.append(torch_prefix + ".weight (ndim)")
                continue
            if tuple(w.shape) != tuple(p.shape):
                missing.append(f"{torch_prefix}.weight (shape {w.shape})")
                continue
            value = w.astype(np.float32)
            loaded.append(torch_prefix)
        else:  # a norm's weight or bias: fold the BatchNorm
            g = find(torch_prefix + ".weight")
            b = find(torch_prefix + ".bias")
            m = find(torch_prefix + ".running_mean")
            v = find(torch_prefix + ".running_var")
            if any(x is None for x in (g, b, m, v)):
                missing.append(torch_prefix + " (bn stats)")
                continue
            scale, bias = _fold_bn(g, b, m, v)
            if tuple(scale.shape) != tuple(p.shape):
                missing.append(f"{torch_prefix} (bn shape {scale.shape})")
                continue
            value = scale if leaf_name == "weight" else bias
            loaded.append(f"{torch_prefix}.{leaf_name}")
        with torch.no_grad():
            p.copy_(torch.from_numpy(np.ascontiguousarray(value)))

    if verbose:
        print(
            f"load_torch_backbone: {len(loaded)} tensors loaded, "
            f"{len(set(missing))} missing"
        )
        for k in sorted(set(missing))[:20]:
            print(f"  missing: {k}")
    if not loaded:
        raise ValueError(
            f"no tensors matched the checkpoint layout of {checkpoint_fp}; "
            f"sample torch keys: {sorted(sd)[:5]}"
        )
    return model
