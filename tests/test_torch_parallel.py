"""The port's data parallelism (``fgn_torch/parallel/``) on the CPU.

Ranks are spawned processes (``fgn_torch.parallel.dryrun.spawn_ranks``:
``spawn``, a ``file://`` rendezvous in a temporary directory, gloo, a
timeout after which every rank is killed); the rank bodies are the port's
(``dryrun.train_rank``, ``eval_rank``, ``dryrun_rank``), so a rank imports
torch and fgn_torch only. The JAX package's references are computed in
this process and the inputs and outputs pass as numpy.

  * the mesh helpers: the one-rank mesh has no group and its collectives
    are the identity; the backend rule (ranks that share a card only over
    gloo, asked for; no CUDA raises); rank rows; ``shard_batch`` gives each
    rank its rows of the global batch byte for byte, ``norm_*`` whole;
  * 2 ranks against the JAX package's ``make_train_step`` on a 2-device
    mesh (``tests/test_dp_equivalence.py``'s configuration, a global batch
    of 2), both in float64 (``compute_dtype="float64"``, JAX with x64),
    JAX's draws for the global batch split by rank through
    ``train_forward(draws=)``: every ``loss_*`` within 1e-5 relative, every
    gradient within 1e-5 of the JAX leaf's largest entry, ``acc``,
    ``acc_balanced`` and the ``rpn_log_*`` equal;
  * 2 SGD steps of 2 ranks against 1 rank, drawing from the generator
    (float64 parameters and computation): losses within 1e-6 relative, parameters within 1e-8 of each
    leaf's scale, the ranks' parameters identical;
  * the gathered eval detections against the JAX package's eval step on a
    2-device mesh (float64 both), per image with
    ``tests/test_dp_equivalence.py``'s tolerances;
  * a frozen backbone under 2 ranks: no backbone parameter moves, the heads
    move as 1 rank moves them;
  * ``python -m fgn_torch.parallel.dryrun --ranks 2 --device cpu``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _toy_batch
from fgn_tpu.data.batching import EpisodeBatch as JBatch
from fgn_tpu.models.fgn import FGN as JFGN
from fgn_tpu.models.fgn import FGNConfig as JConfig
from fgn_tpu.parallel import mesh as j_mesh
from fgn_tpu.train.train_step import make_eval_step as j_make_eval_step
from fgn_tpu.train.train_step import unpack_eval_out as j_unpack_eval_out
from fgn_torch.bridge import flax_to_state_dict, load_flax_params
from fgn_torch.config import FGNConfig
from fgn_torch.data.batching import EpisodeBatch
from fgn_torch.models.fgn import FGN
from fgn_torch.parallel import dryrun, mesh
from tests.test_torch_train import jax_draws

torch.set_num_threads(2)

# tests/test_dp_equivalence.py's configuration with fewer RoIs (4 sampled
# an image, 16 proposals and 4 detections at test): the JAX package's
# float64 RoI head on the CPU takes ~35 s a step at its 16 RoIs an image
CFG = dict(
    n_ways=3, k_shots=1, backbone_norm="gn", backbone_frozen=False,
    rpn_train_nms_pre=256, rpn_train_max_per_img=64,
    rpn_test_nms_pre=256, rpn_test_max_per_img=16,
    rpn_num_samples=16, rcnn_num_samples=4, rcnn_max_per_img=4,
)
B, H, N, K, S, G = 2, 64, 3, 1, 32, 8
M_ANCHORS = (H // 16) ** 2 * 15
F64 = dict(CFG, compute_dtype="float64")
DIAG = ("acc", "acc_balanced")


def _fields():
    batch = _toy_batch(B=B, H=H, W=H, N=N, K=K, S=S)
    return {k: np.asarray(v) for k, v in batch._asdict().items()}


@pytest.fixture(scope="module")
def ref():
    """The JAX package's 2-device mesh step in float64: its losses and
    gradients, its draws, and its eval detections; the weights as a torch
    state_dict."""
    fields = _fields()
    jb = JBatch(**{k: jnp.asarray(v) for k, v in fields.items()})
    model = JFGN(cfg=JConfig(**CFG))
    params = jax.jit(lambda k, b, r: model.init(
        k, b, r, method=JFGN.train_forward))(
        jax.random.PRNGKey(0), jb, jax.random.PRNGKey(1))
    params = jax.device_get(params)
    tm = FGN(FGNConfig(**CFG))
    load_flax_params(tm, params)
    state = {k: v.numpy().copy() for k, v in tm.state_dict().items()}
    rng = jax.random.PRNGKey(7)
    jmesh = j_mesh.make_mesh(jax.devices("cpu")[:2])
    rep = j_mesh.replicate(jmesh)
    with jax.enable_x64(True):
        m64 = JFGN(cfg=JConfig(**F64))

        def loss_fn(p, b, r):
            losses = m64.apply(p, b, r, method=JFGN.train_forward)
            total = sum(v for k, v in losses.items() if k.startswith("loss_"))
            return total, losses

        grad_fn = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True),
            in_shardings=(rep, j_mesh.episode_batch_shardings(jmesh), rep),
            out_shardings=(rep, rep))
        (total, losses), grads = grad_fn(
            jax.device_put(params, rep), j_mesh.shard_batch(jb, jmesh), rng)
        losses = {k: float(v) for k, v in losses.items()}
        losses["loss_total"] = float(total)
        grads = flax_to_state_dict(jax.device_get(grads))
        draws = jax_draws(rng, B, N, M_ANCHORS, G + CFG["rpn_train_max_per_img"])
        eval_step, _ = j_make_eval_step(m64, jmesh)
        dets = j_unpack_eval_out(jax.device_get(eval_step(
            jax.device_put(params, rep), j_mesh.shard_batch(jb, jmesh))))
    return dict(fields=fields, state=state, losses=losses, grads=grads,
                draws=draws, dets={k: np.asarray(v) for k, v in dets.items()})


def _spec(ref, steps, param_dtype="float32", **opt):
    return dict(cfg=F64, state=ref["state"], steps=steps,
                param_dtype=param_dtype,
                optimizer=dict(dict(optimizer="sgd", base_lr=5e-3), **opt))


@pytest.fixture(scope="module")
def runs(ref):
    """One start of 2 ranks and one of 1 rank (``dryrun.run_bodies``):
    {case: [rank results]}. Cases: "jax", one step on the JAX package's
    draws; "sgd", 2 SGD steps from the generator in float64 parameters;
    "frozen", one step with the backbone frozen (2 ranks and 1); "eval",
    the gathered detections (2 ranks)."""
    sgd = [dict(fields=ref["fields"], seed=100 + i) for i in range(2)]
    cases = {
        "jax": (dryrun.train_rank, _spec(
            ref, [dict(fields=ref["fields"], draws=ref["draws"])])),
        "sgd": (dryrun.train_rank, _spec(ref, sgd, param_dtype="float64")),
        "frozen": (dryrun.train_rank, _spec(
            ref, [dict(fields=ref["fields"], seed=3)], param_dtype="float64",
            frozen_modules=("backbone",))),
        "eval": (dryrun.eval_rank, dict(cfg=F64, state=ref["state"],
                                        fields=ref["fields"])),
    }
    two = dryrun.spawn_ranks(dryrun.run_bodies, 2, (list(cases.values()),))
    one_names = ("sgd", "frozen")
    one = dryrun.spawn_ranks(dryrun.run_bodies, 1,
                             ([cases[k] for k in one_names],))[0]
    out = {k: [r[i] for r in two] for i, k in enumerate(cases)}
    out.update({k + "_1": one[i] for i, k in enumerate(one_names)})
    return out


def _assert_leaves_close(got, want, rel, what):
    assert set(got) == set(want), what
    for name, w in want.items():
        tol = rel * float(np.abs(w).max())
        d = float(np.abs(got[name].astype(np.float64) - w).max())
        assert d <= tol, f"{what} {name}: max|diff| {d:.3e} > {tol:.3e}"


# -- the mesh helpers -------------------------------------------------------------


def test_one_rank_mesh_has_no_group():
    m = mesh.make_mesh(device="cpu")
    assert m.group is None and m.world_size == 1 and m.is_main
    t = torch.arange(6.0).reshape(3, 2)
    assert mesh.global_sum(t, m) is t and mesh.global_max(t, m) is t
    assert mesh.all_gather_rows(t, m) is t
    assert mesh.broadcast_object({"a": 1}, m) == {"a": 1}
    assert mesh.rank_rows(5, m) == slice(0, 5)


def test_backend_rule(monkeypatch):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh._rank_device("cuda", None, 0, 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for backend in (None, "nccl"):
        with pytest.raises(RuntimeError, match="NCCL needs a card"):
            mesh._rank_device("cuda", backend, 1, 2)
    assert mesh._rank_device("cuda", "gloo", 1, 2) == (
        torch.device("cuda", 0), "gloo")
    assert mesh._rank_device("cuda", None, 0, 1) == (
        torch.device("cuda", 0), "nccl")
    assert mesh._rank_device("cpu", None, 1, 2) == (torch.device("cpu"), "gloo")
    with pytest.raises(ValueError):
        mesh._rank_device("cpu", "nccl", 0, 2)


def test_shard_batch_rows():
    fields = _fields()
    batch = EpisodeBatch(**fields)
    shardings = mesh.episode_batch_shardings()
    assert {f for f, how in shardings._asdict().items()
            if how == "replicated"} == {"norm_mean", "norm_std"}
    for world in (1, 2):
        got = []
        for r in range(world):
            m = mesh.Mesh(rank=r, world_size=world)
            part = mesh.shard_batch(batch, m)
            for f in ("norm_mean", "norm_std"):
                assert np.array_equal(getattr(part, f).numpy(), fields[f])
            got.append(part)
        for f in EpisodeBatch._fields[:-2]:
            whole = torch.cat([getattr(p, f) for p in got]).numpy()
            assert whole.dtype == fields[f].dtype
            assert whole.tobytes() == fields[f].tobytes(), f
    with pytest.raises(ValueError, match="does not divide"):
        mesh.shard_batch(batch, mesh.Mesh(rank=0, world_size=3))


def test_rank_draws_are_rows_of_the_global_draws():
    gen = torch.Generator().manual_seed(5)
    whole = mesh.rank_draws(gen, "cpu", None)
    ref = [whole("rpn", (4, 3, 2, 7)), whole("rcnn", (4, 2, 9))]
    for r in range(2):
        gen.manual_seed(5)
        d = mesh.rank_draws(gen, "cpu", mesh.Mesh(rank=r, world_size=2))
        assert torch.equal(d("rpn", (2, 3, 2, 7)), ref[0][2 * r:2 * r + 2])
        assert torch.equal(d("rcnn", (2, 2, 9)), ref[1][2 * r:2 * r + 2])


# -- the train step against the JAX package's mesh step ----------------------------


def test_dp_losses_match_jax_mesh_step(ref, runs):
    for rank in runs["jax"]:
        got = rank[0]["metrics"]
        for k, v in ref["losses"].items():
            if k.startswith("loss_"):
                assert got[k] == pytest.approx(v, rel=1e-5), k
            else:  # the global batch's diagnostics
                assert got[k] == v, k
        assert set(got) == set(ref["losses"])
    assert {k for k in got if k.startswith("rpn_log")}
    assert all(k in got for k in DIAG)


def test_dp_grads_match_jax_mesh_step(ref, runs):
    for rank in runs["jax"]:
        grads = rank[0]["grads"]
        assert set(grads) == set(ref["grads"])
        _assert_leaves_close(grads, ref["grads"], 1e-5, "gradient")


def test_two_sgd_steps_match_one_rank(runs):
    ranks, one = runs["sgd"], runs["sgd_1"]
    for r in ranks:
        for got, want in zip(r, one):
            for k, v in want["metrics"].items():
                assert got["metrics"][k] == pytest.approx(v, rel=1e-6), k
        _assert_leaves_close(r[-1]["params"], one[-1]["params"], 1e-8,
                             "parameter")
    for a, b in zip(ranks[0], ranks[1]):
        for name, p in a["params"].items():
            assert np.array_equal(p, b["params"][name]), name


def test_frozen_backbone_two_ranks(ref, runs):
    one = runs["frozen_1"]
    before = ref["state"]
    for rank in runs["frozen"]:
        params = rank[0]["params"]
        back = [n for n in params if n.startswith("backbone.")]
        heads = [n for n in params if not n.startswith("backbone.")]
        assert back and heads
        for n in back:
            assert np.array_equal(params[n], before[n].astype(np.float64)), n
        assert any(not np.array_equal(params[n], before[n].astype(np.float64))
                   for n in heads)
        _assert_leaves_close(params, one[0]["params"], 1e-8, "parameter")


# -- the eval step ---------------------------------------------------------------


def test_dp_eval_matches_jax_mesh_eval(ref, runs):
    want = ref["dets"]
    for d in runs["eval"]:  # every rank holds the gathered global batch
        assert d["dt_valid"].shape == want["dt_valid"].shape
        for b in range(B):
            v1, v2 = want["dt_valid"][b], d["dt_valid"][b]
            assert v1.sum() == v2.sum(), (b, v1.sum(), v2.sum())
            o1 = np.argsort(-want["dt_scores"][b][v1], kind="stable")
            o2 = np.argsort(-d["dt_scores"][b][v2], kind="stable")
            np.testing.assert_allclose(
                d["dt_scores"][b][v2][o2], want["dt_scores"][b][v1][o1],
                rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(
                d["dt_boxes"][b][v2][o2], want["dt_boxes"][b][v1][o1],
                rtol=1e-4, atol=5e-3)
            np.testing.assert_array_equal(
                d["dt_cats"][b][v2][o2], want["dt_cats"][b][v1][o1])
            np.testing.assert_allclose(
                d["dt_mask_logits"][b][v2][o2],
                want["dt_mask_logits"][b][v1][o1], rtol=1e-3, atol=1e-3)
    assert want["dt_valid"].any()


# -- the dry run -----------------------------------------------------------------


def test_dryrun_two_ranks_on_cpu(capsys):
    assert dryrun.main(["--ranks", "2", "--device", "cpu",
                        "--timeout", "120"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip(2): steps=2 ") and line.endswith(
        "eval_ok=True ckpt_restore_ok=True OK"), line


def test_a_failing_rank_fails_the_run():
    with pytest.raises(dryrun.RankFailure, match="exit codes"):
        dryrun.spawn_ranks(dryrun.train_rank, 2, ({},), timeout=60)
