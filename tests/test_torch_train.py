"""fgn_torch's training forward against the JAX package's on CPU.

The same numpy inputs go through both packages; the JAX package's random
draws go into the port through ``train_forward``'s ``draws`` seam (and into
the sampler's ``u`` argument), since ``jax.random`` and torch give
different streams. Weights come from flax ``model.init`` through
``fgn_torch.bridge``.

Tolerances:
  * losses, box assignment and sampling: losses ≤ 1e-6 relative (f32, the
    same formulas), assignments and samples equal;
  * ``train_forward`` in float32 on both sides: every ``loss_*`` ≤ 1e-4
    relative; ``acc``, ``acc_balanced`` and the ``rpn_log_*`` counts equal;
  * gradients in float64 on both sides (``compute_dtype="float64"``, JAX
    with x64 on): every parameter's gradient within 1e-5 × the largest
    entry of the JAX package's gradient of that leaf; losses ≤ 1e-5
    relative (the loss functions sum in float32 in both packages). In float32 the gradient of this small network is badly
    conditioned: the JAX package's own f32 gradient differs from its f64
    gradient by up to a few percent of a leaf's largest entry (through
    the GroupNorms of the 4x4 and 2x2 maps), so an f32 implementation
    cannot be held to the JAX package's f32 gradient at 1e-3. The f32
    check is instead that the port's f32 gradient is about as close to the
    f64 gradient as the JAX package's f32 gradient is;
  * remat on and off in the port: the same loss, gradients ≤ 1e-5 of scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgn_tpu.data.batching import EpisodeBatch as JBatch
from fgn_tpu.models import losses as j_losses
from fgn_tpu.models.fgn import FGN as JFGN
from fgn_tpu.models.fgn import FGNConfig as JConfig
from fgn_tpu.ops.assign import max_iou_assign as j_assign
from fgn_tpu.ops.sample import random_sample_pos_neg as j_sample
from fgn_torch.bridge import flax_to_state_dict, load_flax_params
from fgn_torch.config import FGNConfig
from fgn_torch.data.batching import from_numpy
from fgn_torch.models import losses as t_losses
from fgn_torch.models.fgn import FGN
from fgn_torch.ops.assign import max_iou_assign as t_assign
from fgn_torch.ops.sample import random_sample_pos_neg as t_sample

torch.set_num_threads(2)

# tests/test_remat.py's _SMALL geometry
SMALL = dict(
    n_ways=3, k_shots=1, backbone_norm="gn",
    rpn_train_nms_pre=64, rpn_train_max_per_img=16,
    rpn_test_nms_pre=64, rpn_test_max_per_img=16,
    rpn_num_samples=8, rcnn_num_samples=8, rcnn_max_per_img=4,
)
B, H, N, K, S, G = 2, 64, 3, 1, 32, 4
M_ANCHORS = (H // 16) ** 2 * 15
LOSS_KEYS = ("loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "loss_bbox",
             "loss_mask")


def _t(x):
    return torch.from_numpy(np.array(x))


def _batch_np(seed):
    """A 64 px episode whose gt boxes (24-44 px) give the RPN positives."""
    rng = np.random.RandomState(seed)
    qry_img = rng.randn(B, H, H, 3).astype(np.float32) * 0.1
    qry_boxes = np.zeros((B, G, 4), np.float32)
    qry_cats = np.zeros((B, G), np.int32)
    qry_valid = np.zeros((B, G), bool)
    qry_masks = np.zeros((B, G, H // 4, H // 4), np.float32)
    for b in range(B):
        for g in range(3):
            x1, y1 = rng.randint(0, H // 3, 2)
            bw, bh = rng.randint(24, 44, 2)
            qry_boxes[b, g] = [x1, y1, min(x1 + bw, H - 1), min(y1 + bh, H - 1)]
            qry_cats[b, g] = g % N
            qry_valid[b, g] = True
            bx = (qry_boxes[b, g] / 4).astype(int)
            qry_masks[b, g, bx[1]:bx[3], bx[0]:bx[2]] = 1.0
    spp_masks = np.zeros((B, N * K, S, S), np.uint8)
    spp_masks[:, :, 8:-8, 8:-8] = 255
    return dict(
        qry_img=qry_img, qry_boxes=qry_boxes, qry_cats=qry_cats,
        qry_valid=qry_valid, qry_masks=qry_masks,
        spp_imgs=rng.randn(B, N * K, S, S, 3).astype(np.float32) * 0.1,
        spp_boxes=np.tile(np.array([4, 4, S - 4, S - 4], np.float32),
                          (B, N * K, 1)),
        spp_masks=spp_masks,
        img_hw=np.tile(np.array([H, H], np.int32), (B, 1)),
    )


def _key_pair_draws(key, n):
    """The sampler's draws for one key: uniform(kp), uniform(kn)."""
    kp, kn = jax.random.split(key)
    return jnp.stack([jax.random.uniform(kp, (n,)), jax.random.uniform(kn, (n,))])


def jax_draws(rng, b, n_ways, m, gp):
    """The uniform draws FGN.train_forward makes from ``rng`` in the JAX
    package, by the same splits: {"rpn": (B, N, 2, M), "rcnn": (B, 2, G+P)}."""
    rng_rpn, rng_rcnn = jax.random.split(rng)
    rpn = jax.vmap(lambda k: _key_pair_draws(k, m))(
        jax.random.split(rng_rpn, b * n_ways))
    rcnn = jax.vmap(lambda k: _key_pair_draws(k, gp))(
        jax.random.split(rng_rcnn, b))
    return {"rpn": np.asarray(rpn).reshape(b, n_ways, 2, m),
            "rcnn": np.asarray(rcnn)}


def _jbatch(fields):
    return JBatch(**{k: jnp.asarray(v) for k, v in fields.items()})


def draws_fn(draws):
    def fn(name, shape):
        assert draws[name].shape == shape, (name, draws[name].shape, shape)
        return _t(draws[name])
    return fn


def _grads(model):
    return {n: (p.grad.numpy().copy() if p.grad is not None
                else np.zeros(tuple(p.shape), np.float32))
            for n, p in model.named_parameters()}


def torch_loss_and_grads(model, fields, draws):
    model.zero_grad(set_to_none=True)
    losses = model.train_forward(from_numpy(**fields), draws=draws_fn(draws))
    sum(v for k, v in losses.items() if k.startswith("loss_")).backward()
    return {k: float(v.detach()) for k, v in losses.items()}, _grads(model)


class Ref:
    """The JAX package's losses and gradients for one configuration, at
    f32 and at f64, with the draws of each run."""

    def __init__(self, seed=3, **kw):
        self.kw = dict(SMALL, **kw)
        self.fields = fields = _batch_np(seed)
        jm = JFGN(cfg=JConfig(**self.kw))
        # The tree of model.init(method=train_forward), traced, not run;
        # its leaves filled from a seed at flax's default scales (kernels
        # normal with variance 1/fan_in, norm scales 1, biases 0).
        shapes = jax.eval_shape(
            lambda k, b, r: jm.init(k, b, r, method=JFGN.train_forward),
            jax.random.PRNGKey(0), _jbatch(fields), jax.random.PRNGKey(1))
        r = np.random.RandomState(seed)

        def leaf(path, s):
            name = jax.tree_util.keystr(path[-1:])
            if "kernel" in name:
                fan_in = int(np.prod(s.shape[:-1]))
                return (r.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)
            return np.full(s.shape, "scale" in name, np.float32)

        self.params = jax.tree_util.tree_map_with_path(leaf, shapes)
        rng = jax.random.PRNGKey(2)
        gp = G + self.kw["rpn_train_max_per_img"]
        self.out = {}
        jb = _jbatch(fields)
        for dt in ("float32", "float64"):
            with jax.enable_x64(dt == "float64"):
                model = JFGN(cfg=JConfig(compute_dtype=dt, **self.kw))

                def loss_fn(p):
                    losses = model.apply(p, jb, rng, method=JFGN.train_forward)
                    total = sum(v for k, v in losses.items()
                                if k.startswith("loss_"))
                    return total, losses

                (_, losses), grads = jax.jit(
                    jax.value_and_grad(loss_fn, has_aux=True))(self.params)
                self.out[dt] = (
                    {k: float(v) for k, v in losses.items()},
                    flax_to_state_dict(jax.device_get(grads)),
                    jax_draws(rng, B, self.kw["n_ways"], M_ANCHORS, gp),
                )

    def torch_model(self, **kw):
        model = FGN(FGNConfig(**dict(self.kw, **kw)))
        load_flax_params(model, self.params)
        return model


@pytest.fixture(scope="module")
def guided():
    return Ref()


@pytest.fixture(scope="module")
def guided_torch(guided):
    """The port's losses and gradients at f32 and f64 on the JAX package's
    draws of each run."""
    out = {}
    for dt in ("float32", "float64"):
        out[dt] = torch_loss_and_grads(guided.torch_model(compute_dtype=dt),
                                       guided.fields, guided.out[dt][2])
    return out


# -- losses, assignment, sampling ----------------------------------------------


def test_losses_match_jax(rng):
    logits = rng.randn(5, 7, 4).astype(np.float32) * 3
    labels = rng.randint(0, 4, (5, 7)).astype(np.int32)
    weights = (rng.rand(5, 7) > 0.3).astype(np.float32)
    targets = (rng.rand(5, 7, 4) > 0.5).astype(np.float32)
    pred, tgt = rng.randn(2, 5, 7, 4).astype(np.float32) * 2
    for avg in (0.0, 3.0, 17.5):
        pairs = [
            (j_losses.sigmoid_bce(logits, targets, weights[..., None], avg),
             t_losses.sigmoid_bce(_t(logits), _t(targets), _t(weights)[..., None],
                                  avg)),
            (j_losses.softmax_ce(logits, labels, weights, avg),
             t_losses.softmax_ce(_t(logits), _t(labels), _t(weights), avg)),
            (j_losses.smooth_l1(pred, tgt, weights[..., None], avg),
             t_losses.smooth_l1(_t(pred), _t(tgt), _t(weights)[..., None],
                                torch.tensor(avg))),
        ]
        for ref, got in pairs:
            assert float(got) == pytest.approx(float(ref), rel=1e-6, abs=1e-7)
    labels[0] = 2  # a class with a single prediction
    acc, bal = j_losses.accuracy_balanced(logits, labels, weights, 4)
    tacc, tbal = t_losses.accuracy_balanced(_t(logits), _t(labels), _t(weights), 4)
    assert float(tacc) == float(acc) and float(tbal) == float(bal)
    assert 0 < float(acc) < 1


def test_assign_matches_jax(rng):
    """Batched assignment equals the JAX function per image: thresholds,
    padding gts, box_valid, and shared best boxes (the last gt wins)."""
    Bn, A, Gn = 3, 300, 5
    ctr = rng.uniform(0, 100, (Bn, A, 2))
    wh = rng.uniform(5, 40, (Bn, A, 2))
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)
    gts = boxes[:, :Gn].copy() + rng.uniform(-3, 3, (Bn, Gn, 4)).astype(np.float32)
    gts[:, 3] = gts[:, 2]  # two identical gts: their best boxes tie
    gt_valid = np.ones((Bn, Gn), bool)
    gt_valid[1, 4] = False
    gt_valid[2] = False  # no valid gt: every valid box negative
    box_valid = rng.rand(Bn, A) > 0.1
    for low, bv in ((True, box_valid), (False, None), (True, None)):
        got = t_assign(_t(boxes), _t(gts), _t(gt_valid), 0.5, 0.3, 0.3,
                       match_low_quality=low,
                       box_valid=None if bv is None else _t(bv))
        for b in range(Bn):
            ref = j_assign(jnp.asarray(boxes[b]), jnp.asarray(gts[b]),
                           jnp.asarray(gt_valid[b]), 0.5, 0.3, 0.3,
                           match_low_quality=low,
                           box_valid=None if bv is None else jnp.asarray(bv[b]))
            assert np.array_equal(got.assigned_gt_inds[b].numpy(),
                                  np.asarray(ref.assigned_gt_inds))
            assert np.array_equal(got.pos_mask[b].numpy(), np.asarray(ref.pos_mask))
            assert np.array_equal(got.neg_mask[b].numpy(), np.asarray(ref.neg_mask))
            np.testing.assert_allclose(got.max_overlaps[b].numpy(),
                                       np.asarray(ref.max_overlaps), atol=1e-6)
    assert got.assigned_gt_inds.dtype == torch.int32
    assert (got.assigned_gt_inds[0] == 4).any()  # the later twin gt won


@pytest.mark.parametrize("A,num,frac,p_pos,p_neg", [
    (200, 16, 0.25, 0.05, 0.5),   # enough of both
    (200, 16, 0.5, 0.01, 0.02),   # too few of both: short result
    (10, 16, 0.5, 0.3, 0.4),      # fewer candidates than slots
    (50, 8, 0.0, 0.2, 0.5),       # no positive slots
])
def test_sample_matches_jax(A, num, frac, p_pos, p_neg):
    r = np.random.RandomState(A + num)
    Bn = 4
    u = r.rand(Bn, A)
    pos = u < p_pos
    neg = (u >= p_pos) & (u < p_pos + p_neg)
    keys = jax.random.split(jax.random.PRNGKey(A), Bn)
    draws = np.asarray(jax.vmap(lambda k: _key_pair_draws(k, A))(keys))
    got = t_sample(_t(draws), _t(pos), _t(neg), num, frac)
    for b in range(Bn):
        ref = j_sample(keys[b], jnp.asarray(pos[b]), jnp.asarray(neg[b]), num,
                       frac)
        assert np.array_equal(got.inds[b].numpy(), np.asarray(ref.inds))
        assert np.array_equal(got.is_pos[b].numpy(), np.asarray(ref.is_pos))
        assert np.array_equal(got.valid[b].numpy(), np.asarray(ref.valid))
        assert int(got.n_pos[b]) == int(ref.n_pos)


def test_sample_keeps_jax_tie_order():
    """Equal draws rank by the lower index, as jax.lax.top_k does."""
    u = torch.full((1, 2, 12), 0.5)
    mask = torch.ones((1, 12), dtype=torch.bool)
    got = t_sample(u, mask, mask, 6, 0.5)
    assert got.inds[0].tolist() == [0, 1, 2, 0, 1, 2]
    assert got.is_pos[0].tolist() == [True] * 3 + [False] * 3


# -- train_forward -------------------------------------------------------------


def test_bridge_covers_the_training_params(guided):
    """The training path makes no parameter test_forward lacks: the flax
    tree of model.init(method=train_forward) maps onto the port exactly."""
    sd = flax_to_state_dict(guided.params)
    want = guided.torch_model().state_dict()
    assert sorted(sd) == sorted(want)


def test_train_forward_losses_match_jax_f32(guided, guided_torch):
    ref, _, _ = guided.out["float32"]
    got, _ = guided_torch["float32"]
    assert set(got) == set(ref)
    for k in LOSS_KEYS:
        assert got[k] == pytest.approx(ref[k], rel=1e-4), k
        assert np.isfinite(got[k])
    for k in ref:
        if not k.startswith("loss_"):
            assert got[k] == ref[k], k
    # not a vacuous episode: RPN positives and RCNN positives exist
    assert sum(ref[f"rpn_log_pos_way{n}"] for n in range(N)) > 0
    assert ref["loss_bbox"] > 0 and ref["loss_rpn_bbox"] > 0


def test_train_forward_grads_match_jax_f64(guided, guided_torch):
    ref, ref_g, _ = guided.out["float64"]
    got, got_g = guided_torch["float64"]
    for k in LOSS_KEYS:
        assert got[k] == pytest.approx(ref[k], rel=1e-5), k
    assert set(got_g) == set(ref_g)
    for name, g in ref_g.items():
        scale = float(np.abs(g).max())
        err = float(np.abs(got_g[name] - g).max())
        assert err <= 1e-5 * max(scale, 1e-12), (name, err, scale)


def test_train_forward_grads_f32_as_accurate_as_jax(guided, guided_torch):
    """Against the f64 gradient, the port's f32 gradient errs about as far
    as the JAX package's f32 gradient does: per leaf, within twice the JAX
    package's largest f32 error of any leaf (relative to the leaf's
    scale), plus 1e-4."""
    _, g64, _ = guided.out["float64"]
    _, g32, _ = guided.out["float32"]
    _, t32 = guided_torch["float32"]

    def rel_err(a, b):
        return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-12)

    jax_worst = max(rel_err(g32[n], g64[n]) for n in g64)
    for n in g64:
        assert rel_err(t32[n], g64[n]) <= 2 * jax_worst + 1e-4, n


def test_remat_identical_loss_and_grads(guided):
    draws = draws_fn(guided.out["float32"][2])
    results = []
    for remat in ("", "backbone,res5,relation,mask"):
        model = guided.torch_model(remat=remat)
        losses = model.train_forward(from_numpy(**guided.fields), draws=draws)
        total = sum(v for k, v in losses.items() if k.startswith("loss_"))
        total.backward()
        results.append((float(total.detach()), _grads(model)))
    (l0, g0), (l1, g1) = results
    assert l0 == l1
    for n, a in g0.items():
        scale = max(float(np.abs(a).max()), 1e-6)
        assert float(np.abs(a - g1[n]).max()) <= 1e-5 * scale, n


def test_remat_tokens_are_a_set():
    with pytest.raises(ValueError, match="unknown blocks"):
        FGN(FGNConfig(remat="backbone,relations", **SMALL))
    assert FGN(FGNConfig(remat="mask,,res5", **SMALL)).remats == {"mask", "res5"}


def test_train_forward_draws_from_a_generator(guided):
    """Without draws, the samplers draw from the generator: the same seed
    gives the same losses, and a generator or draws is required."""
    model = guided.torch_model()
    batch = from_numpy(**guided.fields)
    with torch.no_grad():
        a = model.train_forward(batch, torch.Generator().manual_seed(7))
        b = model.train_forward(batch, torch.Generator().manual_seed(7))
        with pytest.raises(ValueError, match="generator or draws"):
            model.train_forward(batch)
    assert all(float(a[k]) == float(b[k]) for k in a)
    assert all(np.isfinite(float(a[k])) for k in LOSS_KEYS)


def test_frozen_backbone_gets_no_gradient(guided):
    """backbone_frozen detaches the backbone's output, as the JAX package's
    stop_gradient does: its parameters get no gradient, the heads do."""
    model = guided.torch_model(backbone_frozen=True)
    losses = model.train_forward(from_numpy(**guided.fields),
                                 torch.Generator().manual_seed(1))
    sum(v for k, v in losses.items() if k.startswith("loss_")).backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert all(g is None for n, g in grads.items() if n.startswith("backbone."))
    assert all(grads[n] is not None and bool(grads[n].abs().sum() > 0)
               for n in ("rpn_conv.weight", "fc_cls.weight",
                         "shared5.res5.block0.conv1.weight",
                         "mask_logits.weight"))
