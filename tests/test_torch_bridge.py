"""fgn_torch.bridge: every leaf of the JAX package's ``model.init`` tree
maps onto a torch parameter of the same shape and back, with zero
unmapped leaves in either direction; the transposed-conv kernel needs
its spatial flip; and importing fgn_torch pulls in neither JAX nor the
JAX package."""

import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as nn

from fgn_tpu.models.fgn import FGN as JFGN
from fgn_tpu.models.fgn import FGNConfig as JConfig
from fgn_torch.bridge import flax_to_state_dict, load_flax_params
from fgn_torch.config import FGNConfig
from fgn_torch.models.fgn import FGN

torch.set_num_threads(2)


def _toy_jbatch(N, K):
    from __graft_entry__ import _toy_batch

    return _toy_batch(B=1, H=64, W=64, N=N, K=K, S=32)


def _init_shapes(cfg: JConfig):
    """Param tree of ``model.init`` as zero numpy arrays (shapes only: the
    init is traced, not run)."""
    model = JFGN(cfg=cfg)
    shapes = jax.eval_shape(
        lambda k, b, r: model.init(k, b, r, method=JFGN.train_forward),
        jax.random.PRNGKey(0), _toy_jbatch(cfg.n_ways, cfg.k_shots),
        jax.random.PRNGKey(1),
    )
    return jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes
    )


CONFIGS = {
    "guided": dict(n_ways=3, k_shots=2),
    "guidance_off": dict(n_ways=1, k_shots=1, guidance=False),
    "deep_stem_avg_down": dict(n_ways=2, k_shots=1, deep_stem=True,
                               avg_down=True),
    "frozen_bn_res5_bn": dict(n_ways=3, k_shots=1, backbone_norm="frozen_bn",
                              res5_norm="bn", backbone_frozen=True),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_every_leaf_maps(name):
    kw = CONFIGS[name]
    params = _init_shapes(JConfig(**kw))
    n_leaves = len(jax.tree_util.tree_leaves(params))
    sd = flax_to_state_dict(params)
    want = FGN(FGNConfig(**kw)).state_dict()
    assert len(sd) == n_leaves
    assert sorted(sd) == sorted(want)  # zero unmapped, either direction
    for k, v in sd.items():
        assert v.shape == tuple(want[k].shape), k
    n_params = sum(v.size for v in sd.values())
    assert n_params == sum(v.numel() for v in want.values())


def test_leaf_layouts_round_trip():
    """Each torch tensor holds exactly its flax leaf, re-laid out."""
    rng = np.random.RandomState(0)
    params = jax.tree_util.tree_map(
        lambda a: rng.randn(*a.shape).astype(np.float32),
        _init_shapes(JConfig(**CONFIGS["guided"])),
    )
    model = FGN(FGNConfig(**CONFIGS["guided"]))
    load_flax_params(model, params)
    sd = model.state_dict()
    p = params["params"]
    assert np.array_equal(sd["rpn_conv.weight"].numpy(),
                          p["rpn_conv"]["kernel"].transpose(3, 2, 0, 1))
    assert np.array_equal(sd["fc_cls.weight"].numpy(), p["fc_cls"]["kernel"].T)
    assert np.array_equal(sd["rel_gn.weight"].numpy(), p["rel_gn"]["scale"])
    assert np.array_equal(
        sd["backbone.layer2.block0.ds_bn.bias"].numpy(),
        p["backbone"]["layer2"]["block0"]["ds_bn"]["bias"],
    )
    assert np.array_equal(
        sd["mask_deconv.weight"].numpy(),
        p["mask_deconv"]["kernel"].transpose(2, 3, 0, 1)[:, :, ::-1, ::-1],
    )


def test_bridge_raises_on_unmapped_leaves():
    params = jax.tree_util.tree_map(
        np.array, _init_shapes(JConfig(**CONFIGS["guided"]))
    )
    model = FGN(FGNConfig(**CONFIGS["guided"]))
    extra = {"params": dict(params["params"], stray={"kernel": np.zeros((2, 2),
                                                                      np.float32)})}
    with pytest.raises(KeyError, match="1 flax leaves unmapped"):
        load_flax_params(model, extra)
    short = {"params": {k: v for k, v in params["params"].items()
                        if k != "fc_reg"}}
    with pytest.raises(KeyError, match="2 torch params without a leaf"):
        load_flax_params(model, short)
    odd = {"params": {"x": {"weird": np.zeros(3, np.float32)}}}
    with pytest.raises(KeyError, match="unmapped flax leaf"):
        flax_to_state_dict(odd)
    with pytest.raises(TypeError, match="want numpy"):
        flax_to_state_dict({"params": {"x": {"bias": jnp.zeros(3)}}})


def test_deconv_needs_the_spatial_flip():
    """flax ConvTranspose (2×2, stride 2) equals F.conv_transpose2d only
    with the kernel flipped on both spatial axes."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, 5, 6).astype(np.float32)
    m = nn.ConvTranspose(4, (2, 2), strides=(2, 2))
    params = jax.device_get(m.init(jax.random.PRNGKey(0), x))
    ref = np.asarray(m.apply(params, x)).transpose(0, 3, 1, 2)  # NCHW
    sd = flax_to_state_dict({"params": {"mask_deconv": params["params"]}})
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    w = torch.from_numpy(sd["mask_deconv.weight"])
    b = torch.from_numpy(sd["mask_deconv.bias"])
    flipped = F.conv_transpose2d(xt, w, b, stride=2).numpy()
    unflipped = F.conv_transpose2d(xt, w.flip(2, 3), b, stride=2).numpy()
    assert np.abs(flipped - ref).max() < 1e-5
    assert np.abs(unflipped - ref).max() > 1e-2


def test_config_mirrors_jax_config():
    """Same field names and defaults, so one set of values drives both."""
    j = {f.name: f.default for f in dataclasses.fields(JConfig)}
    t = {f.name: f.default for f in dataclasses.fields(FGNConfig)}
    assert j == t
    assert FGNConfig().num_anchors == JConfig().num_anchors == 15


def test_import_pulls_in_no_jax():
    code = (
        "import sys\n"
        "import fgn_torch, fgn_torch.bridge, fgn_torch.models.fgn\n"
        "import fgn_torch.ops.roi_align_cuda, fgn_torch.ops.nms_cuda\n"
        "import fgn_torch.data.batching, fgn_torch.ops._build\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'fgn_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
