"""The port's Runner and ``main`` under data parallelism, on the CPU.

The ranks are spawned processes (``fgn_torch.parallel.dryrun.spawn_ranks``,
gloo, a ``file://`` rendezvous, a timeout). This module imports torch and
fgn_torch only, since the ranks import it for their bodies (``runner_rank``,
``main_rank``). It works on ``tests/test_torch_runner.py``'s 64 px split
(``Tiny64``, its classes repeated here: that module imports JAX), and the
1-rank Runner here is the one ``tests/test_torch_runner.py`` holds to the
JAX package's Runner.

  * a 2-rank Runner (global batch 2, one episode a rank) against the 1-rank
    Runner, float64 parameters and computation, SGD, 2 epochs of 2 steps,
    checks at the ends of the epochs and at step 3, each with an evaluator
    on the val split: each step's
    global batch (every array, byte for byte) is the 1-rank run's; rank 0
    saves each checkpoint and rank 1 none, and the steps, their
    ``epoch``/``cursor`` and the sidecars equal the 1-rank run's; the
    results pickles equal the 1-rank run's byte for byte and the printed
    metrics are the same; the final parameters are within 1e-8 of each
    leaf's scale (summation order only), equal on both ranks; rank 0 alone
    logs;
  * ``FGN_MAX_RSS_GB`` under the process's size: both ranks exit 42 at the
    first check, after its checkpoint, and a second start resumes from it
    to the end;
  * ``main`` under 2 ranks with ``--device cpu``, on a config derived from
    ``fgn_train_mnistiseg_n1k1.py``: it trains, rank 0 alone logs and
    writes the checkpoints.
"""

import contextlib
import io
import os
import random
import shutil

import numpy as np
import pytest
import torch

from fgn_torch.config import Config, FGNConfig
from fgn_torch.data import fst_bindings
from fgn_torch.data.fst_bindings import MNISTFewShotISEG
from fgn_torch.data.mnistiseg import MNISTISEG
from fgn_torch.parallel.dryrun import spawn_ranks
from fgn_torch.parallel.mesh import rank0_first

torch.set_num_threads(2)

# tests/test_torch_runner.py's split, model and sizes
RAW64 = dict(
    img_size=64, target_size=64, max_size=64, ds_name="tiny64_mnistiseg",
    sizes_max_amount={"small": 2, "large": 2},
    sizes_min_max_ratios={"small": [0.7, 1.0], "large": [1.0, 1.4]},
)
Tiny64 = type("Tiny64", (MNISTISEG,), dict(RAW64))
Tiny64FewShot = type("Tiny64FewShot", (MNISTFewShotISEG,), dict(
    inner_ds_cl=Tiny64, spp_img_size=32))
TOY = dict(
    n_ways=1, k_shots=1, backbone_norm="gn", backbone_frozen=False,
    rpn_train_nms_pre=64, rpn_train_max_per_img=16,
    rpn_test_nms_pre=64, rpn_test_max_per_img=16,
    rpn_num_samples=8, rcnn_num_samples=2, rcnn_max_per_img=4,
)
B, MAX_GT, LR = 2, 8, 2e-3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _files(d, prefix=""):
    """{relative path: bytes} of the files under ``d`` whose names start
    with ``prefix``."""
    out = {}
    for base, _, names in os.walk(d):
        for name in sorted(names):
            if name.startswith(prefix):
                path = os.path.join(base, name)
                with open(path, "rb") as f:
                    out[os.path.relpath(path, d)] = f.read()
    return out


# -- rank bodies (the ranks import this module) ----------------------------------


def runner_rank(mesh, spec):
    """A Runner on this rank (``spec["dp"]``: under ``mesh``; else the
    plain 1-rank Runner), float64, SGD, with one evaluator. → what it fed,
    saved, printed and ended with."""
    from fgn_torch.models.fgn import build_model
    from fgn_torch.train import optim
    from fgn_torch.train.evaluator import Evaluator
    from fgn_torch.train.loop import Runner
    from fgn_torch.train.train_step import make_eval_step, make_train_step

    os.environ.update(spec.get("env", {}))
    mesh = mesh if spec["dp"] else None
    root, fst, work = spec["root"], spec["fst"], spec["work"]
    ds, val = rank0_first(lambda: (
        Tiny64FewShot(dict(_ds_cfg(root), root=fst)),
        Tiny64FewShot(dict(_ds_cfg(root, "val"), root=fst))), mesh)
    model = build_model(FGNConfig(**TOY, compute_dtype="float64"), "cpu",
                        seed=0).to(torch.float64)
    sched = optim.make_lr_schedule(LR, steps_per_epoch=len(ds) // B,
                                   warmup_iters=2)
    opt = optim.build_optimizer(model, optimizer="sgd", schedule=sched)
    ev = Evaluator(model, val, batch_size=B,
                   eval_step=make_eval_step(model, mesh), work_dir=work,
                   max_gt=MAX_GT, n_plots=0, mesh=mesh)
    runner = Runner(model, opt, make_train_step(model, opt, mesh), ds,
                    batch_size=B, work_dir=work, max_epochs=2,
                    evaluators=[ev], eval_interval_iters=3, max_gt=MAX_GT,
                    max_keep_ckpts=1, log_interval=1, lr_schedule=sched,
                    mesh=mesh)
    fed, saves = [], []
    feed, save = runner._device_feed, runner.ckpt._save

    def recorded_feed(loader):
        for batch, meta in feed(loader):
            fed.append({f: getattr(batch, f).numpy().copy()
                        for f in batch._fields})
            yield batch, meta

    def recorded_save(step, *a, **k):
        saves.append(int(step))
        return save(step, *a, **k)

    runner._device_feed, runner.ckpt._save = recorded_feed, recorded_save
    out = io.StringIO()
    random.seed(0)
    np.random.seed(0)
    with contextlib.redirect_stdout(out):
        runner.resume()
        runner.run()
    last, state = runner.ckpt.restore()
    return dict(
        fed=fed, saves=saves, out=out.getvalue(), step=runner.step,
        params={n: p.detach().numpy().copy()
                for n, p in model.named_parameters()},
        ckpt=(last, state["extra"]["epoch"], state["extra"]["cursor"],
              _files(runner.ckpt.dir, "ds_state_")),
        pkl=_files(os.path.join(work, "results_pkl")))


def main_rank(mesh, cfg_fp):
    """``fgn_torch.main.main`` on this rank, the tiny split's classes
    standing in for MNISTISEG. → (its standard output, its final
    parameters)."""
    from fgn_torch import main as t_main

    fst_bindings._DS_CLASSES["MNISTISEG"] = Tiny64FewShot
    out = io.StringIO()
    random.seed(0)
    np.random.seed(0)
    with contextlib.redirect_stdout(out):
        model = t_main.main(Config.from_file(cfg_fp), mesh=mesh)
    return out.getvalue(), {n: p.detach().numpy().copy()
                            for n, p in model.named_parameters()}


# -- tests ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dp_runner") / "raw")
    Tiny64.create(root=root, quantities={"train": 6, "val": 2}, seed=9)
    return root


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, removed after the test: a checkpoint of the
    toy model takes hundreds of MB."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _spec(raw, tmp, name, dp=True, **env):
    return dict(root=raw, fst=str(tmp / "fst"), work=str(tmp / name), dp=dp,
                env={k: str(v) for k, v in env.items()})


def test_two_rank_runner_matches_one_rank(raw, tmp_path):
    one = spawn_ranks(runner_rank, 1, (_spec(raw, tmp_path, "one", dp=False),),
                      timeout=240)[0]
    two = spawn_ranks(runner_rank, 2, (_spec(raw, tmp_path, "two"),),
                      timeout=240)
    assert one["step"] == 4 and len(one["fed"]) == 4
    r0, r1 = two
    for r in two:
        assert r["step"] == one["step"] and len(r["fed"]) == len(one["fed"])
    # each global batch: rank 0's row then rank 1's, the 1-rank batch's rows
    for b0, b1, want in zip(r0["fed"], r1["fed"], one["fed"]):
        for f, w in want.items():
            if f in ("norm_mean", "norm_std"):
                got = b0[f]
                assert np.array_equal(b1[f], w)
            else:
                got = np.concatenate([b0[f], b1[f]])
            assert got.dtype == w.dtype and got.tobytes() == w.tobytes(), f
    # checks at the ends of the epochs (steps 2 and 4) and at step 3
    assert one["saves"] == r0["saves"] == [2, 3, 4] and r1["saves"] == []
    assert r0["ckpt"] == r1["ckpt"] == one["ckpt"]
    assert one["ckpt"][:3] == (4, 2, 0)
    assert r0["pkl"] and r0["pkl"] == one["pkl"]

    def metric_lines(out):
        return [line.split("] ", 1)[1] for line in out.splitlines()
                if " eval: {" in line or "fresh-support eval: {" in line]

    assert len(metric_lines(one["out"])) == 4
    assert metric_lines(r0["out"]) == metric_lines(one["out"])
    assert "ckpt scheduled" in r0["out"] and " it3 " in r0["out"]
    assert r1["out"] == ""
    for name, w in one["params"].items():
        tol = 1e-8 * float(np.abs(w).max())
        d = float(np.abs(r0["params"][name] - w).max())
        assert d <= tol, f"{name}: {d:.3e} > {tol:.3e}"
        assert np.array_equal(r0["params"][name], r1["params"][name]), name


def test_rss_kill_exits_42_on_every_rank_and_resumes(raw, tmp_path):
    spec = _spec(raw, tmp_path, "killed", FGN_MAX_RSS_GB=0.001)
    assert spawn_ranks(runner_rank, 2, (spec,), timeout=240,
                       exit_codes={0: 42, 1: 42}) == [None, None]
    from fgn_torch.train.checkpoints import CheckpointManager

    mgr = CheckpointManager(spec["work"])
    assert mgr.all_steps() == [2]
    assert not [n for n in os.listdir(mgr.dir) if n.startswith(".tmp")]
    r0, r1 = spawn_ranks(runner_rank, 2, (dict(spec, env={
        "FGN_MAX_RSS_GB": "0"}),), timeout=240)
    assert r0["step"] == r1["step"] == 4
    assert len(r0["fed"]) == len(r1["fed"]) == 2
    assert "Resumed from step 2 (epoch 1, cursor 0)" in r0["out"]
    assert r1["out"] == "" and r1["saves"] == [] and r0["saves"]


def test_main_two_ranks_on_cpu(raw, tmp_path):
    cfg = Config.from_file(os.path.join(
        ROOT, "fgn_torch", "configs", "fgn_train_mnistiseg_n1k1.py"))
    cfg.model.update(TOY)
    roots = dict(inner_root=raw, root=str(tmp_path / "fst"))
    cfg.train_ds_cfg.update(roots)
    cfg.eval_ds_cfg0.update(roots)
    work = str(tmp_path / "run")
    fp = str(tmp_path / "cfg.py")
    with open(fp, "w") as f:
        f.write(f"_base_ = [{os.path.join(ROOT, 'fgn_torch', 'configs', 'fgn_train_mnistiseg_n1k1.py')!r}]\n")
        f.write(f"model = {dict(TOY)!r}\n")
        f.write(f"train_ds_cfg = {roots!r}\n")
        f.write(f"eval_ds_cfg0 = {roots!r}\n")
        for k, v in dict(batch_size=2, eval_batch_size=2, max_epochs=1,
                         max_gt=MAX_GT, work_dir=work, log_interval=1).items():
            f.write(f"{k} = {v!r}\n")
    (out0, p0), (out1, p1) = spawn_ranks(main_rank, 2, (fp,), timeout=240)
    assert "ckpt scheduled at step" in out0 and " eval: {" in out0
    assert "fresh-support eval: {" in out0 and out1 == ""
    for name in p0:
        assert np.array_equal(p0[name], p1[name]), name
    from fgn_torch.train.checkpoints import CheckpointManager

    assert CheckpointManager(work).latest_step() >= 1
    assert os.listdir(os.path.join(work, "results_pkl"))
