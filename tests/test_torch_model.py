"""fgn_torch's FGN against the JAX package's FGN on CPU, with the same
weights (flax ``model.init`` → ``fgn_torch.bridge``) and the same numpy
batch, in float32.

Stages are compared one at a time, each fed the JAX package's output of
the stage before, so that a miss names its stage; then the whole
``test_forward``, guidance on and off.

Tolerances (f32 on both sides; the two libraries' convolutions and
GroupNorm statistics round differently, ~1e-6 relative per layer):
  * backbone and res5 maps: ≤ 1e-4 of the map's largest magnitude
    (16 residual blocks deep);
  * per-stage heads fed identical inputs: ≤ 1e-4 absolute, scores ≤ 1e-5;
  * proposals and detection boxes: ≤ 1e-4 of the image side (64 px):
    corners are differences of a centre and a half-width;
  * end to end: proposal and detection valid masks and classes equal;
    scores ≤ 1e-4, mask logits ≤ 1e-4.
The RPN and box-regression weights are scaled by 0.1 in the end-to-end
check so decoded boxes stay near the image: random deltas otherwise
scale anchors by up to e^4, and the clip then hides a cancellation error
of order 1e-3 px in the unclipped corners.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgn_tpu.data.batching import EpisodeBatch as JBatch
from fgn_tpu.models.fgn import FGN as JFGN
from fgn_tpu.models.fgn import FGNConfig as JConfig
from fgn_tpu.models.resnet import ResNetC4 as JResNetC4
from fgn_tpu.models.resnet import SharedRes5 as JSharedRes5
from fgn_torch.bridge import load_flax_params
from fgn_torch.config import FGNConfig
from fgn_torch.data.batching import from_numpy
from fgn_torch.models.fgn import FGN, build_model
from fgn_torch.models.resnet import ResNetC4, SharedRes5

torch.set_num_threads(2)

# tests/test_model.py's SMALL configuration
SMALL = dict(
    n_ways=3, k_shots=1, backbone_norm="gn", backbone_frozen=False,
    rpn_train_nms_pre=256, rpn_train_max_per_img=64, rpn_test_nms_pre=256,
    rpn_test_max_per_img=32, rcnn_num_samples=16, rpn_num_samples=16,
    rcnn_max_per_img=8,
)
IMG = 64.0


def _batch_np(seed, B=2, H=64, W=64, G=4, N=3, K=1, S=32):
    """tests/test_model.py's toy episode, as numpy arrays."""
    rng = np.random.RandomState(seed)
    qry_img = rng.randn(B, H, W, 3).astype(np.float32) * 0.1
    qry_boxes = np.zeros((B, G, 4), np.float32)
    qry_cats = np.zeros((B, G), np.int32)
    qry_valid = np.zeros((B, G), bool)
    qry_masks = np.zeros((B, G, H // 4, W // 4), np.float32)
    for b in range(B):
        for g in range(2):
            x1, y1 = rng.randint(0, W // 2, 2)
            bw, bh = rng.randint(12, 28, 2)
            qry_boxes[b, g] = [x1, y1, min(x1 + bw, W - 1), min(y1 + bh, H - 1)]
            qry_cats[b, g] = g % N
            qry_valid[b, g] = True
            bx = (qry_boxes[b, g] / 4).astype(int)
            qry_masks[b, g, bx[1]:bx[3], bx[0]:bx[2]] = 1.0
    spp_imgs = rng.randn(B, N * K, S, S, 3).astype(np.float32) * 0.1
    spp_masks = np.zeros((B, N * K, S, S), np.uint8)
    spp_masks[:, :, 8:-8, 8:-8] = 255
    return dict(
        qry_img=qry_img, qry_boxes=qry_boxes, qry_cats=qry_cats,
        qry_valid=qry_valid, qry_masks=qry_masks, spp_imgs=spp_imgs,
        spp_boxes=np.tile(np.array([4, 4, S - 4, S - 4], np.float32),
                          (B, N * K, 1)),
        spp_masks=spp_masks,
        img_hw=np.tile(np.array([H, W], np.int32), (B, 1)),
    )


def _jbatch(fields):
    return JBatch(**{k: jnp.asarray(v) for k, v in fields.items()})


def _np(x):
    return np.asarray(x)


def _close(got, ref, tol, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = float(np.abs(got - ref).max()) if ref.size else 0.0
    assert err <= tol, f"{what}: max abs diff {err} > {tol}"


def _scaled_reg(params):
    params = jax.tree_util.tree_map(np.array, params)
    for k in ("rpn_reg", "fc_reg"):
        params["params"][k]["kernel"] *= 0.1
    return params


class Pair:
    """One configuration on both sides with the same weights."""

    def __init__(self, guidance: bool, seed: int):
        kw = dict(SMALL)
        if not guidance:
            kw.update(n_ways=1, guidance=False)
        n = kw["n_ways"]
        self.jcfg = JConfig(**kw)
        self.tcfg = FGNConfig(**kw)
        self.fields = _batch_np(seed, N=n)
        self.jb = _jbatch(self.fields)
        self.tb = from_numpy(**self.fields)
        self.jm = JFGN(cfg=self.jcfg)
        params = jax.jit(
            lambda k, b, r: self.jm.init(k, b, r, method=JFGN.train_forward)
        )(jax.random.PRNGKey(0), self.jb, jax.random.PRNGKey(1))
        self.params = _scaled_reg(jax.device_get(params))
        self.tm = FGN(self.tcfg).eval()
        load_flax_params(self.tm, self.params)

    def japply(self, method, *args):
        return jax.jit(
            lambda p, *a: self.jm.apply(p, *a, method=method)
        )(self.params, *args)


@pytest.fixture(scope="module")
def guided():
    return Pair(guidance=True, seed=3)


@pytest.fixture(scope="module")
def unguided():
    return Pair(guidance=False, seed=1)


@pytest.mark.parametrize(
    "norm,deep_stem,avg_down", [("gn", False, False), ("frozen_bn", True, True)]
)
def test_resnet_c4_matches_flax(norm, deep_stem, avg_down):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 64, 64, 3).astype(np.float32)
    jm = JResNetC4(norm=norm, deep_stem=deep_stem, avg_down=avg_down)
    params = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0), x))
    if norm == "frozen_bn":  # non-identity affines, so they are exercised
        params = jax.tree_util.tree_map(
            lambda a: a * 0.9 + 0.05 if a.ndim == 1 else a, params
        )
    ref = _np(jax.jit(jm.apply)(params, x))
    tm = ResNetC4(norm=norm, deep_stem=deep_stem, avg_down=avg_down)
    load_flax_params(tm, params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == ref.shape == (2, 4, 4, 1024)
    _close(got, ref, 1e-4 * np.abs(ref).max(), "ResNetC4")


def test_shared_res5_matches_flax():
    rng = np.random.RandomState(1)
    x = np.maximum(rng.randn(4, 7, 7, 1024), 0).astype(np.float32)
    jm = JSharedRes5()
    params = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(2), x))
    ref = _np(jax.jit(jm.apply)(params, x))
    tm = SharedRes5()
    load_flax_params(tm, params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    _close(got, ref, 1e-4 * np.abs(ref).max(), "SharedRes5")


def test_stage_extract(guided):
    jq, js = guided.japply(JFGN._extract, guided.jb)
    with torch.no_grad():
        tq, ts = guided.tm._extract(guided.tb)
    _close(tq, jq, 1e-4 * np.abs(_np(jq)).max(), "qry_fmap")
    _close(ts, js, 1e-4 * np.abs(_np(js)).max(), "spp_fmaps")


@pytest.fixture(scope="module")
def guided_stages(guided):
    """The JAX package's intermediate results for the guided pair."""
    p = guided
    jq, js = p.japply(JFGN._extract, p.jb)
    jcls, jreg = p.japply(JFGN._rpn_forward, jq, js)
    mcls, mreg = JFGN._merge_ways(jcls, jreg)
    props = jax.jit(
        lambda prm, c, r, hw: p.jm.apply(
            prm, c, r, hw, p.jcfg.rpn_test_nms_pre,
            p.jcfg.rpn_test_max_per_img, method=JFGN.get_proposals,
        )
    )(p.params, mcls, mreg, p.jb.img_hw)
    spp = p.japply(JFGN._count_spp, js, p.jb.spp_boxes, p.jb.spp_masks)
    feats = p.japply(JFGN._bbox_feats, jq, props[0])
    rel = p.japply(JFGN._relation_impl, feats, spp[0])
    return dict(q=jq, s=js, cls=jcls, reg=jreg, mcls=mcls, mreg=mreg,
                props=props, spp=spp, feats=feats, rel=rel)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_stage_rpn_and_merge(guided, guided_stages):
    st = guided_stages
    with torch.no_grad():
        cls, reg = guided.tm._rpn_forward(_t(st["q"]), _t(st["s"]))
        mcls, mreg = FGN._merge_ways(_t(st["cls"]), _t(st["reg"]))
    _close(cls, st["cls"], 1e-4, "rpn cls")
    _close(reg, st["reg"], 1e-4, "rpn reg")
    # the merge is a selection: exact on identical inputs
    _close(mcls, st["mcls"], 0.0, "merged cls")
    _close(mreg, st["mreg"], 0.0, "merged reg")


def test_stage_get_proposals(guided, guided_stages):
    st = guided_stages
    c = guided.tcfg
    with torch.no_grad():
        boxes, scores, valid = guided.tm.get_proposals(
            _t(st["mcls"]), _t(st["mreg"]), _t(guided.fields["img_hw"]),
            c.rpn_test_nms_pre, c.rpn_test_max_per_img,
        )
    jboxes, jscores, jvalid = (_np(x) for x in st["props"])
    assert np.array_equal(valid.numpy(), jvalid)
    _close(scores, jscores, 1e-5, "proposal scores")
    _close(boxes, jboxes, 1e-4 * IMG, "proposals")


def test_stage_count_spp(guided, guided_stages):
    st = guided_stages
    with torch.no_grad():
        maps, vecs = guided.tm._count_spp(
            _t(st["s"]), guided.tb.spp_boxes, guided.tb.spp_masks
        )
    jmaps, jvecs = st["spp"]
    _close(maps, jmaps, 1e-4 * np.abs(_np(jmaps)).max(), "spp_maps")
    _close(vecs, jvecs, 1e-4 * np.abs(_np(jvecs)).max(), "spp_vecs_mask")


def test_stage_bbox_feats_relation_mask(guided, guided_stages):
    st = guided_stages
    with torch.no_grad():
        feats = guided.tm._bbox_feats(_t(st["q"]), _t(st["props"][0]))
        cls, reg = guided.tm._relation_impl(_t(st["feats"]), _t(st["spp"][0]))
        logits = guided.tm._mask_head_impl(_t(st["feats"]).reshape(-1, 7, 7, 1024))
    _close(feats, st["feats"], 1e-4 * np.abs(_np(st["feats"])).max(),
           "bbox_feats")
    _close(cls, st["rel"][0], 1e-4, "relation cls")
    _close(reg, st["rel"][1], 1e-4, "relation reg")
    ref = guided.japply(JFGN._mask_head_impl,
                        jnp.asarray(st["feats"]).reshape(-1, 7, 7, 1024))
    _close(logits, ref, 1e-4, "mask logits")


def _compare_forward(pair):
    ref = {k: _np(v) for k, v in pair.japply(JFGN.test_forward, pair.jb).items()}
    got = pair.tm.test_forward(pair.tb)
    assert set(got) == set(ref)
    for k in ("prop_valid", "dt_valid", "dt_cats"):
        assert np.array_equal(got[k].numpy(), ref[k]), k
    assert ref["dt_valid"].any() and ref["prop_valid"].any()
    _close(got["proposals"], ref["proposals"], 1e-4 * IMG, "proposals")
    _close(got["prop_scores"], ref["prop_scores"], 1e-4, "prop_scores")
    _close(got["dt_boxes"], ref["dt_boxes"], 1e-4 * IMG, "dt_boxes")
    _close(got["dt_scores"], ref["dt_scores"], 1e-4, "dt_scores")
    _close(got["dt_mask_logits"], ref["dt_mask_logits"], 1e-4, "dt_mask_logits")
    assert got["dt_cats"].dtype == torch.int32
    assert got["dt_mask_logits"].dtype == torch.float32


def test_test_forward_matches_jax_guided(guided):
    _compare_forward(guided)


def test_test_forward_matches_jax_guidance_off(unguided):
    _compare_forward(unguided)


def test_guidance_off_ignores_supports(unguided):
    a = unguided.tm.test_forward(unguided.tb)
    tb2 = unguided.tb._replace(spp_imgs=unguided.tb.spp_imgs * 0 + 1)
    b = unguided.tm.test_forward(tb2)
    assert torch.equal(a["dt_scores"], b["dt_scores"])


def test_bf16_forward_runs_and_is_close(guided):
    """compute_dtype=bfloat16 on the same weights: finite outputs of the
    right shapes and dtypes, proposals' scores near the f32 run (the RPN
    scores leave bf16 for f32 before the sigmoid)."""
    cfg = dataclasses.replace(guided.tcfg, compute_dtype="bfloat16")
    tm = FGN(cfg).eval()
    tm.load_state_dict(guided.tm.state_dict())
    out = tm.test_forward(guided.tb)
    ref = guided.tm.test_forward(guided.tb)
    for k, v in out.items():
        assert v.shape == ref[k].shape and v.dtype == ref[k].dtype, k
        if v.is_floating_point():
            assert torch.isfinite(v).all(), k
    assert out["prop_valid"].any() and out["dt_valid"].any()


def test_build_model_is_seeded_and_wants_a_device():
    cfg = FGNConfig(**SMALL)
    a = build_model(cfg, device="cpu", seed=5)
    b = build_model(cfg, device="cpu", seed=5)
    c = build_model(cfg, device="cpu", seed=6)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["rpn_conv.weight"], sc["rpn_conv.weight"])
    # lecun-normal scale, as flax initializes
    w = sa["backbone.layer3.block0.conv2.weight"]
    assert abs(float(w.std()) - (1 / (256 * 9)) ** 0.5) < 0.1 * (1 / (256 * 9)) ** 0.5
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(cfg)
