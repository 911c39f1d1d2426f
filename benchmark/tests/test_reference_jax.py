"""The frozen reference (``benchmark/reference/``) against the JAX
package's FGN, the model it was ported from, at toy size on the CPU.

JAX is imported here only: nothing the benchmark runs on the card imports
it. The weights are the JAX package's flax init, mapped onto the port's
parameter names by the port's bridge and loaded into the reference by
those names. Served outputs: the JAX package's ``test_forward`` is judged
by the benchmark's own comparison (``compare.serve_readings``), which
must read it as the reference's equal. Training: each loss of the JAX
package's ``train_forward`` against the reference's ``train_losses`` on
the same draws and the JAX package's own proposals. Tolerances: float32
on both sides, the libraries' convolutions and GroupNorm statistics
round differently by ~1e-6 relative a layer (as in the port's own parity
tests).
"""

from __future__ import annotations

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from benchmark.harness import compare  # noqa: E402
from benchmark.harness.data import Batch  # noqa: E402
from benchmark.reference.fgn import RefFGN  # noqa: E402
from fgn_torch.bridge import load_flax_params  # noqa: E402
from fgn_torch.config import FGNConfig  # noqa: E402
from fgn_torch.models.fgn import FGN  # noqa: E402
from fgn_tpu.data.batching import EpisodeBatch as JBatch  # noqa: E402
from fgn_tpu.models.fgn import FGN as JFGN  # noqa: E402
from fgn_tpu.models.fgn import FGNConfig as JConfig  # noqa: E402

jax.config.update("jax_default_device", jax.devices("cpu")[0])
torch.set_num_threads(2)

SMALL = dict(
    n_ways=3, k_shots=2, backbone_norm="gn", backbone_frozen=False,
    deep_stem=True, avg_down=True,
    rpn_train_nms_pre=256, rpn_train_max_per_img=64, rpn_test_nms_pre=256,
    rpn_test_max_per_img=32, rcnn_num_samples=16, rpn_num_samples=16,
    rcnn_max_per_img=8,
)
H = S = 64
G = 4


def _fields(seed, B=2, N=3, K=2, Sp=32):
    rng = np.random.RandomState(seed)
    qry_boxes = np.zeros((B, G, 4), np.float32)
    qry_cats = np.zeros((B, G), np.int32)
    qry_valid = np.zeros((B, G), bool)
    qry_masks = np.zeros((B, G, H // 4, H // 4), np.uint8)
    for b in range(B):
        for g in range(3):
            x1, y1 = rng.randint(0, H // 2, 2)
            bw, bh = rng.randint(12, 28, 2)
            qry_boxes[b, g] = [x1, y1, min(x1 + bw, H - 1), min(y1 + bh, H - 1)]
            qry_cats[b, g] = g % N
            qry_valid[b, g] = True
            bx = (qry_boxes[b, g] / 4).astype(int)
            qry_masks[b, g, bx[1]:bx[3], bx[0]:bx[2]] = 255
    spp_masks = np.zeros((B, N * K, Sp, Sp), np.uint8)
    spp_masks[:, :, 8:-8, 8:-8] = 255
    return dict(
        qry_img=rng.randint(0, 256, (B, H, H, 3)).astype(np.uint8),
        qry_boxes=qry_boxes, qry_cats=qry_cats, qry_valid=qry_valid,
        qry_masks=qry_masks,
        spp_imgs=rng.randint(0, 256, (B, N * K, Sp, Sp, 3)).astype(np.uint8),
        spp_boxes=np.tile(np.array([4, 4, Sp - 4, Sp - 4], np.float32), (B, N * K, 1)),
        spp_masks=spp_masks,
        img_hw=np.tile(np.array([H, H], np.int32), (B, 1)),
        norm_mean=np.array([120.0, 110.0, 100.0], np.float32),
        norm_std=np.array([60.0, 57.0, 58.0], np.float32),
    )


def _model_cfg():
    c = FGNConfig(**SMALL)
    return {k: (list(v) if isinstance(v, tuple) else v)
            for k, v in c.__dict__.items()}


@pytest.fixture(scope="module")
def pair():
    fields = _fields(5)
    jb = JBatch(**{k: jnp.asarray(v) for k, v in fields.items()})
    jm = JFGN(cfg=JConfig(**SMALL))
    params = jax.jit(lambda k, b, r: jm.init(k, b, r, method=JFGN.train_forward))(
        jax.random.PRNGKey(0), jb, jax.random.PRNGKey(1))
    params = jax.tree_util.tree_map(np.array, jax.device_get(params))
    for k in ("rpn_reg", "fc_reg"):  # decoded boxes stay near the image
        params["params"][k]["kernel"] *= 0.1
    port = FGN(FGNConfig(**SMALL))
    load_flax_params(port, params)
    ref = RefFGN(_model_cfg())
    ref.load_state_dict(port.state_dict(), strict=True)
    tb = Batch(**{k: torch.from_numpy(v) for k, v in fields.items()})
    return dict(jm=jm, jb=jb, params=params, ref=ref, tb=tb, fields=fields)


def _apply(p, method, *args):
    return jax.jit(lambda prm, *a: p["jm"].apply(prm, *a, method=method))(p["params"], *args)


def test_jax_serving_reads_as_the_references_equal(pair):
    out = {k: torch.from_numpy(np.array(v)) for k, v in _apply(pair, JFGN.test_forward, pair["jb"]).items()}
    assert bool(out["dt_valid"].any()) and bool(out["prop_valid"].any())
    r = compare.serve_readings(pair["ref"], {"model": _model_cfg()}, pair["tb"], out)
    assert r["score_err"] <= 1e-4 and r["box_err"] <= 1e-4, r
    assert r["mask_err"] <= 1e-4, r
    assert r["unanswered"] == 0 and r["overlap"] == 0, r


def test_reference_stages_match_jax(pair):
    jq, js = _apply(pair, JFGN._extract, pair["jb"])
    with torch.no_grad():
        q, s = pair["ref"].extract(pair["tb"])
    for got, want in ((q, jq), (s, js)):
        want = np.asarray(want)
        assert float(np.abs(got.numpy() - want).max()) <= 1e-4 * np.abs(want).max()
    jcls, jreg = _apply(pair, JFGN._rpn_forward, jq, js)
    with torch.no_grad():
        cls, reg = pair["ref"].rpn(torch.from_numpy(np.array(jq)), torch.from_numpy(np.array(js)))
    assert float(np.abs(cls.numpy() - np.asarray(jcls)).max()) <= 1e-4
    assert float(np.abs(reg.numpy() - np.asarray(jreg)).max()) <= 1e-4


def _key_pair_draws(key, n):
    kp, kn = jax.random.split(key)
    return jnp.stack([jax.random.uniform(kp, (n,)), jax.random.uniform(kn, (n,))])


def _jax_draws(rng, b, n_ways, m, gp):
    """The draws the JAX package's train_forward makes from ``rng``."""
    rng_rpn, rng_rcnn = jax.random.split(rng)
    rpn = jax.vmap(lambda k: _key_pair_draws(k, m))(jax.random.split(rng_rpn, b * n_ways))
    rcnn = jax.vmap(lambda k: _key_pair_draws(k, gp))(jax.random.split(rng_rcnn, b))
    return {"rpn": np.asarray(rpn).reshape(b, n_ways, 2, m), "rcnn": np.asarray(rcnn)}


def test_reference_losses_match_jax(pair):
    rng = jax.random.PRNGKey(7)
    jl = _apply(pair, JFGN.train_forward, pair["jb"], rng)
    jq, js = _apply(pair, JFGN._extract, pair["jb"])
    jcls, jreg = _apply(pair, JFGN._rpn_forward, jq, js)
    mcls, mreg = JFGN._merge_ways(jcls, jreg)
    props = jax.jit(lambda prm, c, r, hw: pair["jm"].apply(
        prm, c, r, hw, SMALL["rpn_train_nms_pre"], SMALL["rpn_train_max_per_img"],
        method=JFGN.get_proposals))(pair["params"], mcls, mreg, pair["jb"].img_hw)
    B, N = 2, SMALL["n_ways"]
    M = int(np.prod(jcls.shape[2:]))
    draws = _jax_draws(rng, B, N, M, G + SMALL["rpn_train_max_per_img"])

    def fn(name, shape):
        assert draws[name].shape == shape
        return torch.from_numpy(np.array(draws[name]))

    with torch.no_grad():
        got = pair["ref"].train_losses(pair["tb"], fn, torch.from_numpy(np.array(props[0])),
                                       torch.from_numpy(np.array(props[2])))
    for k, v in got.items():
        want = float(jl[k])
        assert abs(float(v) - want) <= 1e-4 * max(abs(want), 1e-3), (k, float(v), want)


OPT = {"type": "adagrad", "lr": 5e-3, "weight_decay": 1e-5, "roi_head_lr_mult": 0.1,
       "decay_epochs": [2], "gamma": 0.1, "warmup_iters": 3, "warmup_ratio": 0.01,
       "min_lr": 1e-6, "steps_per_epoch": 2}


def _optax(params, frozen=()):
    from fgn_tpu.train import optim as j_optim

    sched = j_optim.make_lr_schedule(
        OPT["lr"], steps_per_epoch=OPT["steps_per_epoch"], decay_epochs=OPT["decay_epochs"],
        gamma=OPT["gamma"], warmup_iters=OPT["warmup_iters"],
        warmup_ratio=OPT["warmup_ratio"], min_lr=OPT["min_lr"])
    return j_optim.build_optimizer(
        params, base_lr=OPT["lr"], weight_decay=OPT["weight_decay"], optimizer="adagrad",
        roi_head_lr_mult=OPT["roi_head_lr_mult"], schedule=sched, frozen_modules=frozen)


@pytest.mark.parametrize("frozen", [(), ("backbone",)])
def test_reference_adagrad_matches_optax(pair, frozen):
    """Five steps of ``reference.optim.Adagrad`` against the JAX package's
    optax chain on the same seeded gradients, through the warmup and a
    decay boundary, the RoI head at 0.1×: every parameter within 1e-6 of
    its leaf's largest magnitude, frozen leaves unmoved."""
    import optax

    from benchmark.reference.optim import Adagrad
    from fgn_torch.bridge import flax_to_state_dict

    params = {"params": pair["params"]["params"]}
    tx = _optax(params, frozen)
    state = tx.init(params)
    update = jax.jit(tx.update)
    sd0 = flax_to_state_dict(params)
    named = [(n, torch.nn.Parameter(torch.from_numpy(v.copy()))) for n, v in sd0.items()]
    opt = Adagrad(named, OPT, frozen)
    r = np.random.RandomState(4)
    jp = params
    for _ in range(5):
        grads = jax.tree_util.tree_map(lambda a: (r.randn(*a.shape) * 0.05).astype(np.float32),
                                       params)
        updates, state = update(grads, state, jp)
        jp = optax.apply_updates(jp, updates)
        gsd = flax_to_state_dict(grads)
        for n, p in named:
            p.grad = torch.from_numpy(gsd[n])
        opt.step()
    want = flax_to_state_dict(jax.device_get(jp))
    for n, p in named:
        got = p.detach().numpy()
        assert float(np.abs(got - want[n]).max()) <= 1e-6 * float(np.abs(want[n]).max()), n
        assert np.array_equal(got, sd0[n]) == (n.split(".")[0] in frozen), n


def _jax_grads(pair, rng, dtype):
    from fgn_torch.bridge import flax_to_state_dict

    with jax.enable_x64(dtype == "float64"):
        jm = JFGN(cfg=JConfig(compute_dtype=dtype, **SMALL))

        def loss_fn(p):
            losses = jm.apply(p, pair["jb"], rng, method=JFGN.train_forward)
            return sum(v for k, v in losses.items() if k.startswith("loss_"))

        grads = jax.device_get(jax.jit(jax.grad(loss_fn))(pair["params"]))
    flat = {n: np.asarray(v, np.float64) for n, v in flax_to_state_dict(grads).items()}
    return flat, grads


@pytest.fixture(scope="module")
def grads(pair):
    """The first gradient of the total loss, as the benchmark reads it (a
    norm a leaf): the reference's in float32, on the JAX package's draws
    and proposals, and the JAX package's in float32 and float64."""
    rng = jax.random.PRNGKey(7)
    jq, js = _apply(pair, JFGN._extract, pair["jb"])
    jcls, jreg = _apply(pair, JFGN._rpn_forward, jq, js)
    mcls, mreg = JFGN._merge_ways(jcls, jreg)
    props = jax.jit(lambda prm, c, r, hw: pair["jm"].apply(
        prm, c, r, hw, SMALL["rpn_train_nms_pre"], SMALL["rpn_train_max_per_img"],
        method=JFGN.get_proposals))(pair["params"], mcls, mreg, pair["jb"].img_hw)
    M = int(np.prod(jcls.shape[2:]))
    draws = _jax_draws(rng, 2, SMALL["n_ways"], M, G + SMALL["rpn_train_max_per_img"])
    ref = pair["ref"]
    ref.zero_grad(set_to_none=True)
    out = ref.train_losses(pair["tb"], lambda name, shape: torch.from_numpy(np.array(draws[name])),
                           torch.from_numpy(np.array(props[0])), torch.from_numpy(np.array(props[2])))
    sum(v for k, v in out.items() if k.startswith("loss_")).backward()
    got = {n: p.grad.double().numpy() if p.grad is not None else np.zeros(p.shape)
           for n, p in ref.named_parameters()}
    ref.zero_grad(set_to_none=True)
    return got, _jax_grads(pair, rng, "float32"), _jax_grads(pair, rng, "float64")[0]


def _norms(g):
    return {n: float(np.linalg.norm(v)) for n, v in g.items()}


def test_reference_gradient_matches_jax(grads):
    """The reference's first gradient, as the benchmark compares it (a
    leaf's norm, its gap over the larger of that leaf's and the median
    leaf's norm), against the JAX package's: from the JAX package's
    float64 gradient and from its float32 one, no farther than twice the
    JAX package's own float32 gradient is from its float64 one, plus
    1e-4 (the toy's float32 gradient is badly conditioned through the
    GroupNorms of its 4x4 and 2x2 maps: tests/test_torch_train.py)."""
    got, (j32, _), j64 = grads
    assert set(got) == set(j32)
    own = max(compare.leaf_gaps(_norms(j32), _norms(j64)).values())
    for want in (j64, j32):
        gaps = compare.leaf_gaps(_norms(got), _norms(want))
        assert max(gaps.values()) <= 2 * own + 1e-4, (max(gaps, key=gaps.get), own)


def test_reference_update_matches_optax(pair, grads):
    """One step of the reference's Adagrad against the JAX package's optax
    chain, both from the JAX package's float32 gradient of the toy's
    losses: each leaf's change, as the benchmark compares it, at 1e-4; and
    the first gradient worked out from the accumulator (acc − 0.1 = g²),
    as the optimizer got it."""
    from benchmark.reference.optim import Adagrad
    from fgn_torch.bridge import flax_to_state_dict

    _, (j32, tree), _ = grads
    params = {"params": pair["params"]["params"]}
    tx = _optax(params)
    updates, _ = jax.jit(tx.update)({"params": tree["params"]}, tx.init(params), params)
    want = _norms({n: np.asarray(v, np.float64) for n, v in flax_to_state_dict(
        jax.device_get(updates)).items()})
    # the reference's step in float64, so that its change is not lost to
    # the rounding of float32 parameters a thousand times larger
    sd0 = {n: v.astype(np.float64) for n, v in flax_to_state_dict(params).items()}
    named = [(n, torch.nn.Parameter(torch.from_numpy(v.copy()))) for n, v in sd0.items()]
    opt = Adagrad(named, OPT)
    for n, p in named:
        p.grad = torch.from_numpy(j32[n])
    opt.step()
    delta = {n: float((p.detach() - torch.from_numpy(sd0[n])).norm()) for n, p in named}
    gaps = compare.leaf_gaps(delta, want)
    assert max(gaps.values()) <= 1e-4, max(gaps, key=gaps.get)
    from_state = {n: float((acc - 0.1).clamp(min=0).sqrt().norm())
                  for (n, _), acc in zip(named, opt.acc)}
    gaps = compare.leaf_gaps(from_state, _norms(j32))
    assert max(gaps.values()) <= 1e-4, max(gaps, key=gaps.get)
