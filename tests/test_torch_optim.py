"""fgn_torch's optimizer, schedules, train step and eval step against the
JAX package's on CPU.

  * Schedules: step and cosine, with warmup and the ``min_lr`` floor, equal
    to ``make_lr_schedule`` within 1e-6 relative at a range of steps.
  * Optimizer: the same seeded gradient sequence, 5 steps, warmup and a
    decay boundary inside them, the RoI head at 0.1× lr, fed to the JAX
    package's ``build_optimizer`` (optax) and to the port's, on bridged
    parameters (leaves of the flax ``model.init`` tree, mapped by
    ``fgn_torch.bridge``): adagrad, adam, sgd and adadelta, plus a case
    with ``frozen_modules`` and one with ``cumulative_iters=2``. Parameters
    within 1e-6 of each leaf's largest magnitude.
  * Train step: one step of the port's ``make_train_step`` against the JAX
    package's ``make_train_step`` on a 1-device mesh, with the JAX
    package's draws, guidance off, in float64 compute on both sides (see
    tests/test_torch_train.py for why gradients are compared in float64)
    and SGD, whose update is linear in the gradient: the losses and
    ``loss_total`` within 1e-5 relative (the loss functions sum in float32),
    updated parameters within 1e-6 of each leaf's scale.
  * Eval step: the unpacked output of the packed eval step equals
    ``test_forward``'s outputs exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fgn_tpu.models.fgn import FGN as JFGN
from fgn_tpu.models.fgn import FGNConfig as JConfig
from fgn_tpu.parallel.mesh import make_mesh, shard_batch
from fgn_tpu.train import optim as j_optim
from fgn_tpu.train.train_step import make_train_step as j_make_train_step
from fgn_torch.bridge import flax_to_state_dict, load_flax_params
from fgn_torch.config import FGNConfig
from fgn_torch.data.batching import from_numpy
from fgn_torch.models.fgn import FGN, init_params
from fgn_torch.train import optim as t_optim
from fgn_torch.train.train_step import (
    make_eval_step, make_train_step, total_loss, unpack_eval_out,
)
from tests.test_torch_train import (
    B, G, M_ANCHORS, SMALL, _batch_np, _jbatch, draws_fn, jax_draws,
)

torch.set_num_threads(2)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(decay_epochs=(1, 2), gamma=0.5, warmup_iters=10),
    dict(type="cosine", total_epochs=3),
    dict(type="cosine", total_epochs=3, min_lr=1e-3, warmup_iters=0),
])
def test_schedule_matches_jax(kw):
    jf = j_optim.make_lr_schedule(5e-3, steps_per_epoch=100, **kw)
    tf = t_optim.make_lr_schedule(5e-3, steps_per_epoch=100, **kw)
    for step in (0, 1, 7, 50, 99, 100, 101, 150, 199, 200, 250, 299, 300,
                 301, 450, 1000):
        ref = float(jf(jnp.asarray(step, jnp.int32)))
        assert tf(step) == pytest.approx(ref, rel=1e-6), step


# Leaves of the flax tree: top-level modules of both lr groups, and the
# stem of the backbone (the frozen case freezes it).
SUBSET = ("rpn_cls", "rpn_reg", "fc_cls", "fc_reg", "rel_gn", "mask_logits",
          "mask_deconv", "backbone")


@pytest.fixture(scope="module")
def param_subset():
    """Leaves of model.init's tree (traced, filled from a seed): the
    modules in SUBSET, the backbone cut to its stem."""
    fields = _batch_np(0)
    jm = JFGN(cfg=JConfig(**SMALL))
    shapes = jax.eval_shape(
        lambda k, b, r: jm.init(k, b, r, method=JFGN.train_forward),
        jax.random.PRNGKey(0), _jbatch(fields), jax.random.PRNGKey(1))
    r = np.random.RandomState(0)
    tree = {k: v for k, v in shapes["params"].items() if k in SUBSET}
    tree["backbone"] = {k: tree["backbone"][k] for k in ("conv1", "bn1")}
    return {"params": jax.tree_util.tree_map(
        lambda s: r.randn(*s.shape).astype(np.float32) * 0.1, tree)}


CASES = {
    "adagrad": dict(optimizer="adagrad"),
    "adam": dict(optimizer="adam"),
    "sgd": dict(optimizer="sgd"),
    "adadelta": dict(optimizer="adadelta"),
    "adam_frozen_backbone": dict(optimizer="adam", frozen_modules=("backbone",)),
    "adagrad_cumulative_2": dict(optimizer="adagrad", cumulative_iters=2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_matches_optax(param_subset, case):
    kw = CASES[case]
    sched = dict(steps_per_epoch=2, decay_epochs=(2,), warmup_iters=3)
    params = param_subset
    tx = j_optim.build_optimizer(
        params, schedule=j_optim.make_lr_schedule(5e-3, **sched), **kw)
    state = tx.init(params)
    update = jax.jit(tx.update)

    sd0 = flax_to_state_dict(params)
    tparams = [(n, torch.nn.Parameter(torch.from_numpy(v.copy())))
               for n, v in sd0.items()]
    opt = t_optim.FGNOptimizer(
        tparams, schedule=t_optim.make_lr_schedule(5e-3, **sched), **kw)

    r = np.random.RandomState(1)
    jp = params
    for _ in range(5):
        grads = jax.tree_util.tree_map(
            lambda a: (r.randn(*a.shape) * 0.05).astype(np.float32), params)
        updates, state = update(grads, state, jp)
        jp = optax.apply_updates(jp, updates)
        gsd = flax_to_state_dict(grads)
        for n, p in tparams:
            p.grad = torch.from_numpy(gsd[n])
        opt.step()
    ref = flax_to_state_dict(jax.device_get(jp))
    frozen = kw.get("frozen_modules", ())
    for n, p in tparams:
        got = p.detach().numpy()
        scale = float(np.abs(ref[n]).max())
        assert float(np.abs(got - ref[n]).max()) <= 1e-6 * scale, n
        moved = not np.array_equal(got, sd0[n])
        assert moved == (n.split(".")[0] not in frozen), n
    groups = {g["label"]: g["lr_mult"] for g in opt.param_groups}
    assert groups["roi"] == 0.1 and groups["main"] == 1.0
    assert opt.state["count"] == 5 // kw.get("cumulative_iters", 1)


def test_param_labels():
    assert t_optim.param_label("shared5.res5.block0.conv1.weight") == "roi"
    assert t_optim.param_label("backbone.conv1.weight") == "main"
    assert t_optim.param_label("backbone.conv1.weight", ("backbone",)) == "frozen"
    assert t_optim.param_label("rpn_conv.bias") == "main"
    assert set(t_optim.ROI_HEAD_MODULES) == set(j_optim.ROI_HEAD_MODULES)
    with pytest.raises(ValueError, match="optimizer"):
        t_optim.FGNOptimizer([("x", torch.nn.Parameter(torch.zeros(1)))],
                             optimizer="lamb")


# guidance off (the single-way plain Mask R-CNN mode): the guided model's
# train_forward is held to the JAX package in tests/test_torch_train.py
UNGUIDED = dict(SMALL, n_ways=1, guidance=False)


@pytest.fixture(scope="module")
def step_pair():
    """One train step in both packages, float64 compute, SGD, guidance off."""
    fields = _batch_np(3)
    fields["qry_cats"][:] = 0
    jb = _jbatch(fields)
    rng = jax.random.PRNGKey(2)
    sched = dict(steps_per_epoch=100, warmup_iters=1)
    with jax.enable_x64(True):
        jm = JFGN(cfg=JConfig(compute_dtype="float64", **UNGUIDED))
        shapes = jax.eval_shape(
            lambda k, b, r: jm.init(k, b, r, method=JFGN.train_forward),
            jax.random.PRNGKey(0), jb, jax.random.PRNGKey(1))
        r = np.random.RandomState(2)
        params = jax.tree_util.tree_map_with_path(
            lambda path, s: (
                (r.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1])))
                if "kernel" in jax.tree_util.keystr(path[-1:])
                else np.full(s.shape, "scale" in jax.tree_util.keystr(path[-1:]))
            ).astype(np.float32), shapes)
        tx = j_optim.build_optimizer(
            params, optimizer="sgd",
            schedule=j_optim.make_lr_schedule(5e-3, **sched))
        mesh = make_mesh(jax.devices("cpu")[:1])
        step, mesh = j_make_train_step(jm, tx, mesh)
        new, _, metrics = step(jax.device_get(params), jax.jit(tx.init)(params),
                               shard_batch(jb, mesh), rng)
        ref = (flax_to_state_dict(jax.device_get(new)),
               {k: float(v) for k, v in metrics.items()})
        draws = jax_draws(rng, B, 1, M_ANCHORS,
                          G + SMALL["rpn_train_max_per_img"])

    tm = FGN(FGNConfig(compute_dtype="float64", **UNGUIDED))
    load_flax_params(tm, params)
    opt = t_optim.build_optimizer(
        tm, optimizer="sgd", schedule=t_optim.make_lr_schedule(5e-3, **sched))
    metrics = make_train_step(tm, opt)(from_numpy(**fields),
                                       draws=draws_fn(draws))
    got = ({k: v.numpy() for k, v in tm.state_dict().items()},
           {k: float(v) for k, v in metrics.items()})
    return ref, got, flax_to_state_dict(params)


def test_train_step_matches_jax(step_pair):
    (ref_p, ref_m), (got_p, got_m), before = step_pair
    assert set(got_m) == set(ref_m)
    # the loss functions sum in float32 in both packages, in other orders
    for k in ref_m:
        assert got_m[k] == pytest.approx(ref_m[k], rel=1e-5, abs=1e-9), k
    for n, ref in ref_p.items():
        scale = float(np.abs(ref).max())
        assert float(np.abs(got_p[n] - ref).max()) <= 1e-6 * scale, n
    moved = [n for n in ref_p if not np.array_equal(got_p[n], before[n])]
    assert len(moved) == len(ref_p)  # every leaf stepped (wd at least)


def test_total_loss_sums_the_loss_keys():
    losses = {"loss_a": torch.tensor(1.5), "acc": torch.tensor(0.5),
              "loss_b": torch.tensor(2.0), "rpn_log_pos_way0": torch.tensor(3.0)}
    assert float(total_loss(losses)) == 3.5


@pytest.mark.parametrize("guidance", [True, False])
def test_eval_step_unpacks_to_test_forward(guidance):
    kw = dict(SMALL)
    if not guidance:
        kw.update(n_ways=1, guidance=False)
    model = FGN(FGNConfig(**kw)).eval()
    init_params(model, torch.Generator().manual_seed(4))
    with torch.no_grad():  # small regression weights keep boxes on the image
        model.fc_reg.weight.mul_(0.1)
        model.rpn_reg.weight.mul_(0.1)
    batch = from_numpy(**_batch_np(5))
    if not guidance:
        batch = batch._replace(qry_cats=torch.zeros_like(batch.qry_cats))
    ref = model.test_forward(batch)
    packed = make_eval_step(model)(batch)
    assert set(packed) == {"dt_pack", "dt_mask_logits"}
    assert packed["dt_pack"].shape == ref["dt_boxes"].shape[:2] + (7,)
    got = unpack_eval_out(packed)
    for k, v in got.items():
        assert v.dtype == ref[k].dtype, k
        assert torch.equal(v, ref[k]), k
    assert bool(ref["dt_valid"].any())
    plain = make_eval_step(model, packed=False)(batch)
    assert unpack_eval_out(plain) is plain
    assert all(torch.equal(plain[k], ref[k]) for k in ref)
