"""Torch checkpoint → port backbone (``fgn_torch/models/convert.py``): the
cases of ``tests/test_convert.py`` on synthetic torchvision/mmcv-layout
state_dicts, and, for the same ``.pth``, the JAX package's
``load_torch_backbone`` output bridged into the port (``fgn_torch.bridge``)
equal to the port's ``load_torch_backbone`` output exactly."""

import io
import shutil
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from fgn_tpu.models.convert import load_torch_backbone as j_load
from fgn_tpu.models.resnet import ResNetC4 as JResNetC4
from fgn_torch.bridge import flax_to_state_dict
from fgn_torch.models.convert import _fold_bn, _map_path, load_torch_backbone
from fgn_torch.models.resnet import ResNetC4

torch.set_num_threads(2)


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, removed after the test:
    a synthetic ResNet-50 ``.pth`` takes tens of MB."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


class _Holder(nn.Module):
    """A model with a ``backbone``, as ``FGN`` has."""

    def __init__(self, **kw):
        super().__init__()
        self.backbone = ResNetC4(**kw)
        g = torch.Generator().manual_seed(5)
        with torch.no_grad():
            for p in self.backbone.parameters():
                p.copy_(torch.randn(p.shape, generator=g))


def _init_copy(model):
    return {k: v.clone() for k, v in model.backbone.state_dict().items()}


def _full_state_dict(model, rng):
    """Every backbone tensor in the DenseCL/mmcv layout (``backbone.``
    prefix, BN stats), plus neck/head keys that must be ignored."""
    sd = {}
    for name, p in model.backbone.named_parameters():
        names = tuple(name.split("."))
        prefix = "backbone." + _map_path(names)
        if p.dim() == 4:
            sd[prefix + ".weight"] = torch.from_numpy(
                rng.randn(*p.shape).astype(np.float32))
        elif names[-1] == "weight":
            c = p.shape[0]
            sd[prefix + ".weight"] = torch.from_numpy(
                rng.rand(c).astype(np.float32) + 0.5)
            sd[prefix + ".bias"] = torch.from_numpy(
                rng.randn(c).astype(np.float32))
            sd[prefix + ".running_mean"] = torch.from_numpy(
                rng.randn(c).astype(np.float32))
            sd[prefix + ".running_var"] = torch.from_numpy(
                rng.rand(c).astype(np.float32) + 0.5)
            sd[prefix + ".num_batches_tracked"] = torch.tensor(1600)
    sd["neck.mlp.0.weight"] = torch.zeros(128, 2048)
    sd["head.fc.weight"] = torch.zeros(10, 128)
    return sd


def test_map_path():
    assert _map_path(("conv1", "weight")) == "conv1"
    assert _map_path(("bn1", "weight")) == "bn1"
    assert _map_path(("layer2", "block3", "conv2", "weight")) == "layer2.3.conv2"
    assert _map_path(("layer1", "block0", "ds_conv", "weight")) == "layer1.0.downsample.0"
    assert _map_path(("layer1", "block0", "ds_bn", "bias")) == "layer1.0.downsample.1"


def test_fold_bn():
    g = np.array([2.0]); b = np.array([1.0])
    m = np.array([0.5]); v = np.array([4.0])
    scale, bias = _fold_bn(g, b, m, v, eps=0.0)
    # y = (x - 0.5)/2 * 2 + 1 = x + 0.5 → scale 1, bias 0.5
    assert np.allclose(scale, 1.0)
    assert np.allclose(bias, 0.5)


def test_backbone_conversion_partial(tmp_path):
    rng = np.random.RandomState(0)
    model = _Holder(norm="frozen_bn", frozen=True)
    init = _init_copy(model)
    w_conv1 = rng.randn(64, 3, 7, 7).astype(np.float32)
    gamma = rng.rand(64).astype(np.float32) + 0.5
    beta = rng.randn(64).astype(np.float32)
    mean = rng.randn(64).astype(np.float32)
    var = rng.rand(64).astype(np.float32) + 0.5
    sd = {
        "backbone.conv1.weight": torch.from_numpy(w_conv1),
        "backbone.bn1.weight": torch.from_numpy(gamma),
        "backbone.bn1.bias": torch.from_numpy(beta),
        "backbone.bn1.running_mean": torch.from_numpy(mean),
        "backbone.bn1.running_var": torch.from_numpy(var),
    }
    fp = str(tmp_path / "ckpt.pth")
    torch.save({"state_dict": sd}, fp)

    assert load_torch_backbone(model, fp) is model
    bb = model.backbone
    # OIHW on both sides: no transpose
    assert torch.equal(bb.conv1.weight, torch.from_numpy(w_conv1))
    exp_scale, exp_bias = _fold_bn(gamma, beta, mean, var)
    assert np.array_equal(bb.bn1.weight.detach().numpy(), exp_scale)
    assert np.array_equal(bb.bn1.bias.detach().numpy(), exp_bias)
    # untouched tensors stay from init
    assert torch.equal(bb.layer1.block0.conv1.weight,
                       init["layer1.block0.conv1.weight"])


@pytest.mark.parametrize("prefix", ["backbone.", "module.backbone.",
                                    "module.", ""])
def test_full_densecl_layout_loads_completely(tmp_path, prefix):
    """The COMPLETE DenseCL/mmcv layout (every stem/stage tensor, plus
    neck/head keys that must be ignored), under each key prefix: EVERY
    backbone tensor converts."""
    rng = np.random.RandomState(1)
    model = _Holder(norm="frozen_bn", frozen=True)
    sd = _full_state_dict(model, rng)
    for expect in (
        "backbone.conv1.weight",
        "backbone.bn1.running_var",
        "backbone.layer1.0.downsample.0.weight",
        "backbone.layer1.0.downsample.1.running_mean",
        "backbone.layer3.5.bn3.weight",
        "backbone.layer2.3.conv2.weight",
    ):
        assert expect in sd, expect
    sd = {(prefix + k[len("backbone."):] if k.startswith("backbone.") else k): v
          for k, v in sd.items()}
    fp = str(tmp_path / "densecl.pth")
    torch.save({"state_dict": sd}, fp)

    buf = io.StringIO()
    with redirect_stdout(buf):
        load_torch_backbone(model, fp)
    n = sum(1 for _ in model.backbone.parameters())
    assert f"{n} tensors loaded, 0 missing" in buf.getvalue(), buf.getvalue()
    for name, p in model.backbone.named_parameters():
        names = tuple(name.split("."))
        key = prefix + _map_path(names)
        if p.dim() == 4:
            assert torch.equal(p, sd[key + ".weight"]), name
        else:
            scale, bias = _fold_bn(*(sd[f"{key}.{s}"].numpy() for s in (
                "weight", "bias", "running_mean", "running_var")))
            exp = scale if names[-1] == "weight" else bias
            assert np.array_equal(p.detach().numpy(), exp), name


def test_wrong_layout_fails_loudly(tmp_path):
    """A checkpoint whose keys match nothing must raise, not silently
    leave the random init in place."""
    model = _Holder(norm="frozen_bn", frozen=True)
    sd = {"encoder_q.stem.conv.weight": torch.zeros(64, 3, 7, 7)}
    fp = str(tmp_path / "bad.pth")
    torch.save({"state_dict": sd}, fp)
    with pytest.raises(ValueError):
        load_torch_backbone(model, fp, verbose=False)


def test_folded_bn_numerics_golden():
    """conv + folded BN output matches the direct BN formula on a tiny
    fixture (torch-free golden)."""
    g = np.array([1.5, 0.5], np.float32)
    b = np.array([0.1, -0.2], np.float32)
    m = np.array([0.3, -0.1], np.float32)
    v = np.array([0.25, 4.0], np.float32)
    x = np.array([[0.2, -1.0], [3.0, 0.5]], np.float32)  # (2 samples, 2 ch)
    eps = 1e-5
    golden = (x - m) / np.sqrt(v + eps) * g + b
    scale, bias = _fold_bn(g, b, m, v, eps=eps)
    assert np.allclose(x * scale + bias, golden, atol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(norm="frozen_bn"),
    dict(norm="frozen_bn", deep_stem=True, avg_down=True),
    dict(norm="gn"),
], ids=["frozen_bn", "deep_stem_avg_down", "gn"])
def test_equals_jax_converter(tmp_path, kw):
    """The same synthetic ``.pth`` through both converters: the JAX
    package's output, bridged, equals the port's exactly, and both print
    the same report (under ``gn`` both fold the checkpoint's BN stats into
    the GroupNorms' affine)."""
    rng = np.random.RandomState(2)
    jbb = JResNetC4(**kw)
    variables = jax.jit(jbb.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 64, 64, 3)))
    jparams = {"params": {"backbone": jax.device_get(variables["params"])}}
    model = _Holder(**kw)
    # the port starts from the JAX package's init, so kept tensors agree
    init_sd = flax_to_state_dict({"backbone": jparams["params"]["backbone"]})
    model.load_state_dict({k: torch.from_numpy(v) for k, v in init_sd.items()})
    fbn = _Holder(norm="frozen_bn", deep_stem=kw.get("deep_stem", False),
                  avg_down=kw.get("avg_down", False))
    sd = _full_state_dict(fbn, rng)
    fp = str(tmp_path / "same.pth")
    torch.save({"state_dict": sd}, fp)

    jbuf, tbuf = io.StringIO(), io.StringIO()
    with redirect_stdout(jbuf):
        out = j_load(jparams, fp)
    with redirect_stdout(tbuf):
        load_torch_backbone(model, fp)
    assert tbuf.getvalue() == jbuf.getvalue()
    want = flax_to_state_dict(
        {"backbone": jax.tree_util.tree_map(np.asarray,
                                            out["params"]["backbone"])})
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert np.array_equal(got[k].numpy(), v), k
