"""The port's Runner (``fgn_torch/train/loop.py``) on the CPU.

  * the cases of ``tests/test_runner.py``: the run trains, checkpoints and
    resumes with no extra steps; a mid-epoch resume consumes each episode
    exactly once;
  * the Runner case of ``tests/test_seed.py``: the same seed gives the same
    draws, another seed others; a resume neither replays the draws of step
    0 nor varies from one restart to another at the same step;
  * the cases of ``tests/test_rss_relief.py``: exit 42 over the limit (with
    ``os._exit`` monkeypatched), no exit at the no-op limits;
  * parity with the JAX package's Runner: both Runners train on the same
    tiny MNISTISEG split, from the same weights (flax ``model.init``
    through ``fgn_torch.bridge``), with SGD in float64, for 2 epochs of 2
    steps with one mid-epoch check whose evaluator runs in each package
    (in float32: the JAX package's float64 convolutions on the CPU take
    seconds, so the model's RoI head samples few RoIs and its evaluation
    runs a float32 twin of the model). The port's ``train_step`` is wrapped
    so that it takes the JAX Runner's per-step key's draws
    (``tests/test_torch_train.py::jax_draws``). 2 epochs of 2 steps with a
    check every 4 steps and a checkpoint-only save every 3
    (``FGN_CKPT_EVERY``) give an end-of-epoch check alone (step 2), a save
    mid-epoch (3), and a check on an epoch's last step (4), whose
    end-of-epoch save both managers skip. The batches' episodes (query and
    supports), in
    order, every epoch; after every save, the latest checkpoint's step and
    its ``epoch``/``cursor`` and the sidecars of the retained steps, byte
    for byte; and the number of eval results printed are equal; the final
    parameters are within 1e-6 of each leaf's scale.

Each test's directory is removed after it: a checkpoint of the toy model
takes hundreds of MB.

The split is generated on the host at 64 px (supports 32 px), a smaller
twin of ``tests/test_torch_evaluator.py``'s 128 px one.

``FewShotISEG.__getitem__`` and the loaders' prefetch threads draw from
Python's global ``random``, so an eval pass between two steps moves the
later training episodes: each package's run starts from the same reseed,
and one package's run (and so its loaders) ends before the other's starts.
A train loader's thread builds its epoch's few batches while the first step
of the epoch runs, before any check of that epoch can start an eval pass.
"""

import os
import random
import shutil

import jax
import numpy as np
import pytest
import torch
from torch import nn

from fgn_tpu.data.batching import collate_episodes as j_collate
from fgn_tpu.models.fgn import FGN as JFGN
from fgn_tpu.models.fgn import FGNConfig as JConfig
from fgn_tpu.parallel.mesh import make_mesh
from fgn_tpu.train import loop as j_loop
from fgn_tpu.train import optim as j_optim
from fgn_tpu.train.evaluator import Evaluator as JEvaluator
from fgn_tpu.train.train_step import make_eval_step as j_make_eval_step
from fgn_tpu.train.train_step import make_train_step as j_make_train_step
from fgn_torch.bridge import flax_to_state_dict, load_flax_params
from fgn_torch.config import FGNConfig
from fgn_torch.data.batching import EpisodeLoader
from fgn_torch.models.fgn import FGN, build_model
from fgn_torch.train import loop as loop_mod
from fgn_torch.train import optim as t_optim
from fgn_torch.train.evaluator import Evaluator
from fgn_torch.train.loop import Runner, resume_seed
from fgn_torch.train.train_step import make_eval_step, make_train_step
from fgn_tpu.data.fst_bindings import MNISTFewShotISEG as JMNISTFewShotISEG
from fgn_tpu.data.mnistiseg import MNISTISEG as JMNISTISEG
from fgn_torch.data.fst_bindings import MNISTFewShotISEG
from fgn_torch.data.mnistiseg import MNISTISEG
from tests.test_torch_evaluator import TINY_RAW
from tests.test_torch_train import draws_fn, jax_draws

torch.set_num_threads(2)

RAW64 = dict(TINY_RAW, img_size=64, target_size=64, max_size=64,
             ds_name="tiny64_mnistiseg")
Tiny64 = type("Tiny64", (MNISTISEG,), dict(RAW64))
Tiny64FewShot = type("Tiny64FewShot", (MNISTFewShotISEG,), dict(
    inner_ds_cl=Tiny64, spp_img_size=32))
JTiny64 = type("JTiny64", (JMNISTISEG,), dict(RAW64))
JTiny64FewShot = type("JTiny64FewShot", (JMNISTFewShotISEG,), dict(
    inner_ds_cl=JTiny64, spp_img_size=32))

# tests/test_torch_train.py's SMALL sizes at one way, 2 RoIs an image
TOY = dict(
    n_ways=1, k_shots=1, backbone_norm="gn", backbone_frozen=False,
    rpn_train_nms_pre=64, rpn_train_max_per_img=16,
    rpn_test_nms_pre=64, rpn_test_max_per_img=16,
    rpn_num_samples=8, rcnn_num_samples=2, rcnn_max_per_img=4,
)
B, MAX_GT, LR = 2, 8, 2e-3


def _ds_cfg(root, subset="train"):
    return dict(
        n_ways=1, k_shots=1,
        ds_base_="MNISTISEG", ds_base__subset="train",
        ds_novel="MNISTISEG", ds_novel_subset="val",
        sampling_origin_ds="MNISTISEG", sampling_origin_ds_subset=subset,
        sampling_cats="base_", sampling_scenario="parents",
        repeats=1, finetune="Ignore", shuffle=subset == "train",
        qry_cats_choice_random=True,
        delete_qry_insts_in_spp_insts_on_train=False,
        inner_root=root,
    )


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_runner")
    root = str(tmp / "raw")
    Tiny64.create(root=root, quantities={"train": 6, "val": 2}, seed=9)
    ds = Tiny64FewShot(dict(_ds_cfg(root), root=str(tmp / "fst")))
    assert len(ds) // B == 2, "want 2 steps an epoch"
    return root, ds, tmp


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, removed after the test."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _build(ds, work_dir, **kw):
    model = build_model(FGNConfig(**TOY), "cpu", seed=0)
    schedule = t_optim.make_lr_schedule(1e-3, steps_per_epoch=4,
                                        warmup_iters=1)
    opt = t_optim.build_optimizer(model, optimizer="adam", schedule=schedule)
    return Runner(
        model, opt, make_train_step(model, opt), ds, batch_size=B,
        work_dir=work_dir, max_epochs=2, evaluators=[], max_gt=MAX_GT,
        log_interval=1, lr_schedule=schedule,
        hparams={"note": "runner-test"}, **kw,
    )


def test_runner_trains_checkpoints_and_resumes(tiny, tmp_path):
    _, ds, _ = tiny
    work = str(tmp_path / "run1")
    runner = _build(ds, work)
    gens = []
    step = runner.train_step
    runner.train_step = lambda b, generator: (gens.append(generator),
                                              step(b, generator=generator))[1]
    runner.run()
    steps_per_epoch = len(ds) // B
    assert runner.step == 2 * steps_per_epoch
    assert all(g is runner.generator for g in gens)
    assert runner.ckpt.all_steps() == [steps_per_epoch, 2 * steps_per_epoch]
    assert os.listdir(os.path.join(work, "tb"))

    # Fresh runner in the same work_dir resumes at the last step; the
    # final checkpoint records epoch=max_epochs so completed epochs are
    # NEVER replayed (the reference/mmcv saves epoch+1 the same way).
    runner2 = _build(ds, work)
    assert runner2.resume()
    assert runner2.step == runner.step
    assert runner2.epoch == 2  # training is complete
    for a, b in zip(runner2.model.state_dict().values(),
                    runner.model.state_dict().values()):
        assert torch.equal(a, b)
    runner2.run()  # nothing left to do
    assert runner2.step == runner.step


def test_mid_epoch_resume_consumes_each_episode_once(tiny, tmp_path):
    """Kill mid-epoch, resume: every batch of the epoch must be consumed
    exactly once across the two half-runs."""
    _, ds, _ = tiny
    work = str(tmp_path / "run_cursor")
    steps_per_epoch = len(ds) // B

    # First half: run 1 step, checkpoint with cursor=1, then "crash".
    runner = _build(ds, work)
    runner.max_epochs = 1
    runner.train_ds.reshuffle(0)
    seen_first = []
    for i, (batch, meta) in enumerate(
            runner._device_feed(EpisodeLoader(runner.train_ds, B,
                                              max_gt=MAX_GT))):
        if i >= 1:
            break
        runner.train_step(batch, generator=runner.generator)
        seen_first.append(tuple(meta.idx.tolist()))
        runner.step += 1
    runner.check(epoch=0, cursor=1)

    # Second half: fresh runner resumes mid-epoch with the saved cursor.
    runner2 = _build(ds, work)
    runner2.max_epochs = 1
    assert runner2.resume()
    assert runner2.step == 1
    assert runner2._start_cursor == 1
    seen_second = []
    feed = runner2._device_feed
    runner2._device_feed = lambda loader: (
        (seen_second.append(tuple(m.idx.tolist())), (b, m))[1]
        for b, m in feed(loader))
    runner2.run()
    assert runner2.step == steps_per_epoch

    all_first = {i for t in seen_first for i in t}
    all_second = {i for t in seen_second for i in t}
    assert not (all_first & all_second), "episode consumed twice"
    assert len(all_first) + len(all_second) == steps_per_epoch * B


class _StubDS:
    def __len__(self):
        return 4

    def state_dict(self):
        return {"order": np.arange(4), "group_hw": {}}

    def load_state_dict(self, state):
        self.loaded = state


def _stub_runner(work, seed):
    model = nn.Linear(3, 2)
    opt = t_optim.build_optimizer(model, optimizer="sgd")
    return Runner(model, opt, None, _StubDS(), batch_size=1,
                  work_dir=str(work), seed=seed)


def test_runner_seed_and_resume_draws(tmp_path):
    """The generator derives from the seed; resume reseeds it from
    (seed, step), so a restart does not replay the draws of step 0 and two
    restarts at one step draw the same."""
    def draws(r):
        return torch.rand(8, generator=r.generator)

    r0 = _stub_runner(tmp_path / "a", 0)
    first = draws(r0)
    assert torch.equal(first, draws(_stub_runner(tmp_path / "b", 0)))
    assert not torch.equal(first, draws(_stub_runner(tmp_path / "c", 1)))
    assert r0.generator.device == torch.device("cpu")
    # the global generator is not touched
    state = torch.random.get_rng_state()
    draws(r0)
    assert torch.equal(state, torch.random.get_rng_state())

    r0.step = 123
    r0.save_ckpt(epoch=0, cursor=3)
    resumed = []
    for _ in range(2):
        r = _stub_runner(tmp_path / "a", 0)
        assert r.resume() and r.step == 123
        resumed.append(draws(r))
    assert torch.equal(resumed[0], resumed[1])
    assert not torch.equal(resumed[0], first)
    assert resume_seed(0, 123) == resume_seed(0, 123) != resume_seed(0, 124)
    assert resume_seed(0, 123) != resume_seed(1, 123)


class _RSSRunner(loop_mod.Runner):
    def __init__(self):  # bypass full construction
        self.tb = None

        class _Ckpt:
            waited = False

            def wait(self):
                self.waited = True

        self.ckpt = _Ckpt()
        self.step = 123


def test_rss_relief_exits_42_over_limit(monkeypatch):
    r = _RSSRunner()
    codes = []
    monkeypatch.setattr(loop_mod.os, "_exit", lambda c: codes.append(c))
    monkeypatch.setenv("FGN_MAX_RSS_GB", "0.001")
    r._rss_relief()
    assert codes == [loop_mod.Runner.RSS_RELIEF_EXIT_CODE] == [42]
    assert r.ckpt.waited, "must flush the checkpoint before exiting"


@pytest.mark.parametrize("limit", ["0", "-1", "100000"])
def test_rss_relief_noop(monkeypatch, limit):
    r = _RSSRunner()
    monkeypatch.setattr(
        loop_mod.os, "_exit",
        lambda c: (_ for _ in ()).throw(AssertionError("must not exit")),
    )
    monkeypatch.setenv("FGN_MAX_RSS_GB", limit)
    r._rss_relief()  # disabled (<=0) or far above current RSS


# -- parity with the JAX package's Runner -------------------------------------


def _episodes(meta):
    """Each episode of a batch: its query and its supports."""
    return [(int(q), tuple(int(v) for v in sp))
            for q, sp in zip(meta.qry_child_idx, meta.spp_insts_ids)]


def _sidecars(d):
    """{file name: bytes} of the ``ds_state`` sidecars in ``d``."""
    out = {}
    for name in sorted(os.listdir(d)):
        if name.startswith("ds_state_"):
            with open(os.path.join(d, name), "rb") as f:
                out[name] = f.read()
    return out


class _JRunner(j_loop.Runner):
    """The JAX Runner, recording each fed batch's episodes and, after each
    save, (its step, the latest step, that checkpoint's epoch and cursor,
    the sidecars)."""

    def _device_feed(self, loader):
        for batch, meta in super()._device_feed(loader):
            self.seen.append(_episodes(meta))
            yield batch, meta

    def save_ckpt(self, epoch=None, cursor=0):
        super().save_ckpt(epoch=epoch, cursor=cursor)
        self.ckpt.wait()
        last = self.ckpt.latest_step()
        extra = self.ckpt.mngr.restore(last)["extra"]
        self.saves.append((self.step, last, int(extra["epoch"]),
                           int(extra["cursor"]), _sidecars(self.ckpt.dir)))


class _TRunner(Runner):
    def _device_feed(self, loader):
        for batch, meta in super()._device_feed(loader):
            self.seen.append(_episodes(meta))
            yield batch, meta

    def save_ckpt(self, epoch=None, cursor=0):
        super().save_ckpt(epoch=epoch, cursor=cursor)
        last, st = self.ckpt.restore()
        self.saves.append((self.step, last, st["extra"]["epoch"],
                           st["extra"]["cursor"], _sidecars(self.ckpt.dir)))


def _eval_lines(out):
    return [line for line in out.splitlines()
            if " eval: {" in line or "final fresh-support eval: {" in line]


def test_parity_with_jax_runner(tiny, tmp_path, capsys, monkeypatch):
    root, _, _ = tiny
    tmp = tmp_path
    jds = JTiny64FewShot(dict(_ds_cfg(root), root=str(tmp / "pj_fst")))
    tds = Tiny64FewShot(dict(_ds_cfg(root), root=str(tmp / "pt_fst")))
    jval = JTiny64FewShot(dict(_ds_cfg(root, "val"), root=str(tmp / "pj_fst")))
    tval = Tiny64FewShot(dict(_ds_cfg(root, "val"), root=str(tmp / "pt_fst")))
    assert len(jds) == len(tds) and len(jval) == len(tval) > 0
    spe = len(tds) // B
    # a check at step 2 (end of epoch 0), a save at 3 (epoch 1, cursor 1),
    # a check at 4 (epoch 1, cursor 2, then the end of epoch 1 at the same
    # step)
    epochs, part = 2, 2 * spe
    monkeypatch.setenv("FGN_CKPT_EVERY", str(spe + 1))
    sched = dict(steps_per_epoch=spe, warmup_iters=2)
    f64 = dict(TOY, compute_dtype="float64")
    m = (64 // 16) ** 2 * 15
    gp = MAX_GT + TOY["rpn_train_max_per_img"]

    with jax.enable_x64(True):
        jm = JFGN(cfg=JConfig(**f64))
        jb, _ = j_collate([jds[0], jds[1]], jds.mean, jds.std, max_gt=MAX_GT)
        params = jax.device_get(jax.jit(
            lambda k, b, r: jm.init(k, b, r, method=JFGN.train_forward)
        )(jax.random.PRNGKey(0), jb, jax.random.PRNGKey(1)))
        params = jax.tree_util.tree_map(np.array, params)
        jsched = j_optim.make_lr_schedule(LR, **sched)
        tx = j_optim.build_optimizer(params, optimizer="sgd", schedule=jsched)
        mesh = make_mesh(jax.devices("cpu")[:1])
        jstep, mesh = j_make_train_step(jm, tx, mesh)
        keys = []

        def jstep_rec(p, o, b, r):
            keys.append(r)
            return jstep(p, o, b, r)

        jev_step, _ = j_make_eval_step(JFGN(cfg=JConfig(**TOY)), mesh)
        jwork = str(tmp / "parity_jax")
        jev = JEvaluator(jm, jval, batch_size=B, eval_step=jev_step,
                         work_dir=jwork, max_gt=MAX_GT, n_plots=0)
        jr = _JRunner(jm, params, jax.jit(tx.init)(params), jstep_rec, jds,
                      batch_size=B, work_dir=jwork, mesh=mesh,
                      max_epochs=epochs, evaluators=[jev],
                      eval_interval_iters=part, max_gt=MAX_GT,
                      max_keep_ckpts=1, log_interval=1, lr_schedule=jsched)
        jr.seen, jr.saves = [], []
        random.seed(0)
        np.random.seed(0)
        jr.run()
        jr.ckpt.wait()
        jparams = flax_to_state_dict(jax.device_get(jr.params))
        draws = [jax_draws(k, B, 1, m, gp) for k in keys]
        jr.ckpt.close()
    jout = _eval_lines(capsys.readouterr().out)

    model = FGN(FGNConfig(**f64))
    load_flax_params(model, params)
    tsched = t_optim.make_lr_schedule(LR, **sched)
    opt = t_optim.build_optimizer(model, optimizer="sgd", schedule=tsched)
    step = make_train_step(model, opt)
    calls = []

    def tstep(batch, generator=None):
        assert generator is not None
        calls.append(len(calls))
        return step(batch, draws=draws_fn(draws[calls[-1]]))

    twin = FGN(FGNConfig(**TOY))
    twin_step = make_eval_step(twin)

    def eval_step(batch):  # the float32 twin at the model's weights
        twin.load_state_dict(model.state_dict())
        return twin_step(batch)

    twork = str(tmp / "parity_torch")
    tev = Evaluator(model, tval, batch_size=B, eval_step=eval_step,
                    work_dir=twork, max_gt=MAX_GT, n_plots=0)
    tr = _TRunner(model, opt, tstep, tds, batch_size=B, work_dir=twork,
                  max_epochs=epochs, evaluators=[tev],
                  eval_interval_iters=part, max_gt=MAX_GT, max_keep_ckpts=1,
                  log_interval=1, lr_schedule=tsched)
    tr.seen, tr.saves = [], []
    random.seed(0)
    np.random.seed(0)
    tr.run()
    tout = _eval_lines(capsys.readouterr().out)

    n = epochs * spe
    assert len(calls) == len(keys) == tr.step == jr.step == n
    assert tr.seen == jr.seen and len(tr.seen) == n
    assert tr.seen[:spe] != tr.seen[spe:2 * spe]  # the epochs are reshuffled
    assert [s[:4] for s in tr.saves] == [s[:4] for s in jr.saves] == [
        (2, 2, 1, 0), (3, 3, 1, 1), (4, 4, 1, 2), (4, 4, 1, 2)]
    for t, j in zip(tr.saves, jr.saves):
        assert list(t[4]) == list(j[4]) == [f"ds_state_{t[1]}.json"]
        assert t[4] == j[4], t[:4]
    # 3 checks and the fresh pass, each printing its metrics
    assert len(tout) == len(jout) == 4, (tout, jout)
    got = {k: v.numpy() for k, v in model.state_dict().items()}
    init = flax_to_state_dict(params)
    moved = 0
    for n, ref in jparams.items():
        scale = float(np.abs(ref).max())
        assert float(np.abs(got[n] - ref).max()) <= 1e-6 * scale, n
        moved += not np.array_equal(ref, init[n])
    assert moved > len(jparams) // 2
