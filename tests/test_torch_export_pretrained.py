"""The port's DenseCL export (``fgn_torch/tools/export_pretrained_pth.py``)
against the JAX package's ``tools/export_pretrained_pth.py``, on the CPU.

The parameters are a ``frozen_bn`` ResNet-50-C4 backbone made by the JAX
package (``model.init``, then every leaf redrawn from a seeded normal so no
affine is the identity) and loaded into the port through ``bridge.py``.

  * The two tools' state_dicts have the same keys and the same arrays,
    exactly.
  * The round trip: a port checkpoint of the DenseCL-architecture model
    (``configs/fgn_r50_c4_densecl.py``) → ``main`` → ``.pth`` →
    ``load_torch_backbone`` into a model built from another seed loads every
    backbone tensor and misses none. Convolution weights and biases come
    back exactly; each affine weight comes back within 1 ulp of float32
    (``rtol=2**-23``): the converter folds the BatchNorm as γ/√(var + eps)
    in float64 with var = float32(1 − 1e-5), so √(var + eps) is 1 only to
    about 1e-8 and the quotient may round to the neighbouring float32.
  * A GroupNorm backbone has no BatchNorm form and raises.
"""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

from fgn_tpu.models.resnet import ResNetC4 as JResNetC4
from fgn_torch.bridge import load_flax_params
from fgn_torch.config import Config
from fgn_torch.main import model_config_from_cfg
from fgn_torch.models.convert import load_torch_backbone
from fgn_torch.models.fgn import build_model
from fgn_torch.models.resnet import ResNetC4
from fgn_torch.tools import export_pretrained_pth as tool
from fgn_torch.train.checkpoints import CheckpointManager
from tools.export_pretrained_pth import backbone_to_state_dict as j_export

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "fgn_torch", "configs")


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, removed after the test: a checkpoint of the
    full-width model takes ~140 MB."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def flax_backbone():
    """A JAX ``frozen_bn`` backbone's params, every leaf redrawn."""
    params = JResNetC4(norm="frozen_bn", frozen=True).init(
        jax.random.PRNGKey(0), np.zeros((1, 32, 32, 3), np.float32))
    rng = np.random.RandomState(3)
    return jax.tree_util.tree_map(
        lambda x: (rng.standard_normal(x.shape) * 0.1
                   + (1.0 if x.ndim == 1 else 0.0)).astype(np.float32),
        jax.device_get(params))


def _port_backbone(params, norm="frozen_bn"):
    bb = ResNetC4(norm=norm, frozen=True)
    load_flax_params(bb, params)
    return bb


def test_state_dict_equals_jax_tool(flax_backbone):
    got = tool.backbone_to_state_dict(_port_backbone(flax_backbone))
    want = j_export(flax_backbone["params"])
    assert sorted(got) == sorted(want)
    # the stem's norm, 13 blocks × 3 and 3 shortcuts
    assert sum(k.endswith("running_var") for k in got) == 43
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32, k
        assert got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k


def test_round_trip_through_the_converter(flax_backbone, tmp_path, capsys):
    mcfg = model_config_from_cfg(Config.from_file(
        os.path.join(CONFIGS, "fgn_r50_c4_densecl.py")))
    assert mcfg.backbone_norm == "frozen_bn" and mcfg.backbone_frozen
    model = build_model(mcfg, "cpu", seed=0)
    load_flax_params(model.backbone, flax_backbone)
    work = str(tmp_path / "run")
    CheckpointManager(work).save(7, model.state_dict(), {},
                                 extra={"epoch": 0, "cursor": 0})
    out = str(tmp_path / "densecl.pth")
    sd = tool.main(work, out)
    assert f"exported {len(sd)} tensors from step 7" in capsys.readouterr().out

    other = build_model(mcfg, "cpu", seed=1)
    load_torch_backbone(other, out)
    n = sum(1 for _ in other.backbone.parameters())
    assert f"{n} tensors loaded, 0 missing" in capsys.readouterr().out
    want = dict(model.backbone.named_parameters())
    for name, p in other.backbone.named_parameters():
        w, g = want[name].detach().numpy(), p.detach().numpy()
        if name.endswith("weight") and p.dim() == 1:
            np.testing.assert_allclose(g, w, rtol=2.0 ** -23, atol=0,
                                       err_msg=name)
        else:
            assert np.array_equal(g, w), name


def test_gn_backbone_raises():
    with pytest.raises(ValueError, match="frozen_bn"):
        tool.backbone_to_state_dict(ResNetC4(norm="gn"))
    with pytest.raises(ValueError, match="GroupNorm"):
        tool.backbone_to_state_dict(ResNetC4(norm="gn", deep_stem=True,
                                             avg_down=True))


def test_no_checkpoint_exits(tmp_path):
    with pytest.raises(SystemExit, match="no checkpoint"):
        tool.main(str(tmp_path), str(tmp_path / "x.pth"))


def test_pth_layout(flax_backbone, tmp_path):
    """The file is a ``{"state_dict": ...}`` of float32 tensors under
    ``backbone.``, with each affine as a BatchNorm of zero mean."""
    sd = tool.backbone_to_state_dict(_port_backbone(flax_backbone))
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}},
               tmp_path / "a.pth")
    back = torch.load(tmp_path / "a.pth", weights_only=True)["state_dict"]
    assert all(k.startswith("backbone.") for k in back)
    assert all(v.dtype == torch.float32 for v in back.values())
    means = [v for k, v in back.items() if k.endswith("running_mean")]
    assert means and all(bool((m == 0).all()) for m in means)
    assert "backbone.layer3.5.conv3.weight" in back
    assert "backbone.layer1.0.downsample.1.running_var" in back
