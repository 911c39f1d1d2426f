"""Export a self-trained backbone as a DenseCL-layout torch checkpoint.

The port's counterpart of the JAX package's ``tools/export_pretrained_pth.py``.
The frozen-pretrained path (reference fgn_r50_c4_densecl.py:4-41: a
DenseCL ``.pth`` converted into a frozen backbone) needs a DenseCL file,
and none is downloaded. This tool INVERTS
``models/convert.py::load_torch_backbone``: a checkpoint of a
``frozen_bn``-architecture model (``configs/fgn_r50_c4_densecl.py``),
read through ``train/checkpoints.py::CheckpointManager``, becomes a
``backbone.``-prefixed torch state_dict that the converter maps back with
zero misses, so the whole pretrained → frozen pipeline runs end to end.

FrozenAffine (weight, bias) pairs are emitted as BatchNorms with
running_mean = 0 and running_var = 1 − eps, so the converter's BN fold
(γ/√(var+eps), β − mean·scale) gives the weight and bias back (in float64,
rounded to float32 once). A GroupNorm backbone has no BatchNorm form and
raises.

    python -m fgn_torch.tools.export_pretrained_pth <work_dir> <out.pth>

The backbone is read as the DenseCL architecture's (``frozen_bn``, 7×7
stem, no avg-down: every ``frozen_bn`` config of the repo's). Host code
only: the tensors are read and written on the CPU.
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
from torch import nn

BN_EPS = 1e-5


def backbone_to_state_dict(backbone: nn.Module) -> Dict[str, np.ndarray]:
    """A ``ResNetC4``'s parameters → a torch-layout numpy state_dict under
    ``backbone.`` (the caller wraps the values in tensors)."""
    from fgn_torch.models.convert import _map_path
    from fgn_torch.models.resnet import Conv2d, FrozenAffine

    sd = {}
    for name, mod in backbone.named_modules():
        if not any(True for _ in mod.parameters(recurse=False)):
            continue
        prefix = "backbone." + _map_path(tuple(name.split(".")) + ("weight",))
        if isinstance(mod, Conv2d) and mod.bias is None:
            sd[prefix + ".weight"] = _np(mod.weight)  # OIHW on both sides
        elif isinstance(mod, FrozenAffine):
            w = _np(mod.weight)
            sd[prefix + ".weight"] = w
            sd[prefix + ".running_mean"] = np.zeros_like(w)
            sd[prefix + ".running_var"] = np.full_like(w, 1.0 - BN_EPS)
            sd[prefix + ".bias"] = _np(mod.bias)
        else:
            raise ValueError(
                f"unexpected backbone module {type(mod).__name__} at {name} "
                "— export requires a frozen_bn-arch checkpoint (FrozenAffine "
                "norms, bias-free convs)")
    return sd


def _np(p) -> np.ndarray:
    return np.ascontiguousarray(p.detach().cpu().numpy()).astype(np.float32)


def main(work_dir: str, out_fp: str):
    import torch

    from fgn_torch.models.resnet import ResNetC4
    from fgn_torch.train.checkpoints import CheckpointManager

    loaded = CheckpointManager(work_dir).load_model(map_location="cpu")
    if loaded is None:
        raise SystemExit(f"no checkpoint found in {work_dir}")
    step, state = loaded
    backbone = ResNetC4(norm="frozen_bn")
    backbone.load_state_dict({k[len("backbone."):]: v for k, v in state.items()
                              if k.startswith("backbone.")})
    sd = backbone_to_state_dict(backbone)
    torch.save(
        {"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}},
        out_fp,
    )
    print(f"exported {len(sd)} tensors from step {step} of {work_dir} "
          f"-> {out_fp}")
    return sd


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("work_dir", help="the run's work_dir (its checkpoints/)")
    ap.add_argument("out", help="the .pth to write")
    args = ap.parse_args()
    main(args.work_dir, args.out)
