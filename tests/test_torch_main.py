"""The port's driver (``fgn_torch/main.py``) and finetune grid
(``fgn_torch/main_ft.py``) on the CPU, on a tiny MNISTISEG split (64 px,
generated on the host; ``MNISTISEG`` dispatches to it for the test).

  * ``main(cfg, device="cpu")`` on a config derived from
    ``fgn_train_mnistiseg_n1k1.py``: one epoch, a checkpoint, eval metrics
    printed at the check and the fresh pass, a results pickle;
  * the N/K consistency asserts;
  * the schedule under ``cumulative_iters`` 1, 2 and 3 (step decay and
    cosine) equals, step by step, the JAX schedule built with the JAX
    package's ``main.py:147-159`` arguments (within 1e-6 relative or one
    float32 ulp of the base rate: the JAX schedule computes in float32, and
    the cosine's tail, 1 + cos near 0, keeps only that), and the optimizer
    applies it once per ``cumulative_iters`` steps;
  * ``backbone_frozen``: over 2 steps no backbone parameter moves, the
    heads do (``tests/test_frozen_backbone.py``);
  * the finetune path: ``ft_ds_cfg0`` merged with ``ft_ds_cfg1``, the
    stage-1 weights from ``init_from``, ``FileNotFoundError`` without a
    checkpoint;
  * ``main_ft.run_grid`` over one cell: the cell's config mutated as the
    JAX package's ``run_grid`` mutates it, the cell trained, ``FT_DONE``
    written, and a second call skips it; ``_parse_args`` equals the JAX
    package's on the same argv;
  * ``python -m fgn_torch.main`` (and ``main_ft``) without ``--device`` on a
    host without CUDA raises instead of running on the CPU.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from __graft_entry__ import _toy_batch
from fgn_tpu import main_ft as j_main_ft
from fgn_tpu.train.optim import make_lr_schedule as j_make_lr_schedule
from fgn_torch import main as t_main
from fgn_torch import main_ft
from fgn_torch.config import Config
from fgn_torch.data import fst_bindings
from fgn_torch.data.batching import from_numpy
from fgn_torch.models.fgn import build_model
from fgn_torch.train.checkpoints import CheckpointManager
from fgn_torch.train.train_step import make_train_step
from fgn_torch.utils.io import read_pkl
from tests.test_torch_runner import TOY, Tiny64, Tiny64FewShot

torch.set_num_threads(2)


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, removed after the test:
    a checkpoint of the toy model takes hundreds of MB."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "fgn_torch", "configs")


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_main") / "raw")
    Tiny64.create(root=root, quantities={"train": 6, "val": 4}, seed=9)
    return root


@pytest.fixture(scope="module")
def ft_raw(tmp_path_factory):
    """A larger split: the finetune selection takes only images whose
    digits are all of the allowed categories."""
    root = str(tmp_path_factory.mktemp("torch_main_ft") / "raw")
    Tiny64.create(root=root, quantities={"train": 80, "val": 40}, seed=9)
    return root


@pytest.fixture
def tiny_ds(monkeypatch):
    monkeypatch.setitem(fst_bindings._DS_CLASSES, "MNISTISEG", Tiny64FewShot)


def _train_cfg(raw, work, **over):
    cfg = Config.from_file(os.path.join(CONFIGS, "fgn_train_mnistiseg_n1k1.py"))
    cfg.model.update(TOY)
    roots = dict(inner_root=raw, root=os.path.join(work, "fst"))
    cfg.train_ds_cfg.update(roots)
    cfg.eval_ds_cfg0.update(roots)
    cfg.update(batch_size=2, eval_batch_size=2, max_epochs=1, max_gt=8,
               work_dir=os.path.join(work, "run"), log_interval=1)
    cfg.update(over)
    return cfg


def test_main_trains_on_cpu(raw, tiny_ds, tmp_path, capsys):
    cfg = _train_cfg(raw, str(tmp_path))
    model = t_main.main(cfg, device="cpu")
    out = capsys.readouterr().out
    assert next(model.parameters()).device.type == "cpu"
    mgr = CheckpointManager(cfg.work_dir)
    step = mgr.latest_step()
    assert step is not None and step >= 1
    assert f"ckpt scheduled at step {step}" in out
    assert mgr.restore()[1]["extra"]["epoch"] == 1
    assert f"step {step} eval: {{'MNISTISEG_val_FT_Ignore/bbox_mAP" in out
    assert "final fresh-support eval: {'MNISTISEG_val_FT_Ignore" in out
    assert "eval pass starting" in out and "e0 it0 loss=" in out
    res_dir = os.path.join(cfg.work_dir, "results_pkl")
    (tag,) = os.listdir(res_dir)
    results = read_pkl(os.path.join(res_dir, tag, "chunk_00000.pkl"))
    assert results and {"idx", "dt_scores", "dt_isegmaps_rle",
                        "qry_isegmaps_rle"} <= set(results[0])


@pytest.mark.parametrize("key", ["n_ways", "k_shots"])
def test_nk_asserts(raw, tiny_ds, tmp_path, key):
    cfg = _train_cfg(raw, str(tmp_path))
    cfg.model[key] = 3
    with pytest.raises(AssertionError):
        t_main.main(cfg, device="cpu")


def _jax_schedule(cfg, steps_per_epoch):
    """The JAX package's main.py:147-159, verbatim but for the names."""
    cum_iters = max(int(cfg.optimizer.get("cumulative_iters", 1)), 1)
    lr_kwargs = {k: v for k, v in dict(cfg.lr_schedule).items()}
    if lr_kwargs.get("type") == "cosine":
        lr_kwargs.setdefault("total_epochs", int(cfg.max_epochs))
    if cum_iters > 1:
        lr_kwargs["warmup_iters"] = max(
            int(lr_kwargs.get("warmup_iters", 100)) // cum_iters, 1
        )
    return j_make_lr_schedule(
        base_lr=float(cfg.optimizer.lr),
        steps_per_epoch=max(steps_per_epoch // cum_iters, 1),
        **lr_kwargs,
    )


@pytest.mark.parametrize("kind", ["step", "cosine"])
@pytest.mark.parametrize("cum", [1, 2, 3])
def test_schedule_matches_jax(cum, kind):
    cfg = Config.from_file(os.path.join(CONFIGS, "fgn_train_mnistiseg_n3k3.py"))
    cfg.optimizer.cumulative_iters = cum
    cfg.lr_schedule.update(type=kind, warmup_iters=7)
    spe = 30
    sched, got_cum = t_main.lr_schedule_from_cfg(cfg, spe)
    jsched = _jax_schedule(cfg, spe)
    ulp = float(cfg.optimizer.lr) * 2.0 ** -23
    assert got_cum == cum
    for s in range(0, 3 * spe + 5):
        assert sched(s) == pytest.approx(float(jsched(s)), rel=1e-6,
                                         abs=ulp), s

    # the optimizer applies the schedule once per `cum` calls of step()
    model = torch.nn.Linear(2, 1)
    opt = t_main.optimizer_from_cfg(cfg, model, spe)
    assert opt.cumulative_iters == cum and opt.kind == cfg.optimizer.type
    for i in range(2 * cum):
        model.zero_grad()
        model(torch.ones(1, 2)).sum().backward()
        opt.step()
    assert opt.state["count"] == 2 and opt.state["mini_step"] == 0


def test_frozen_backbone_params_never_move(tmp_path):
    cfg = Config.from_file(
        os.path.join(CONFIGS, "fgn_train_mnistiseg_n1k1_frozen.py"))
    cfg.model.update(TOY, backbone_norm="frozen_bn", backbone_frozen=True)
    cfg.optimizer.update(type="adam", lr=5e-3, weight_decay=1e-3)
    mcfg = t_main.model_config_from_cfg(cfg)
    assert mcfg.backbone_frozen
    model = build_model(mcfg, "cpu", seed=0)
    opt = t_main.optimizer_from_cfg(cfg, model, steps_per_epoch=4)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step = make_train_step(model, opt)
    batch = from_numpy(**{k: np.array(v) for k, v in _toy_batch(
        B=2, H=64, W=64, N=1, K=1, S=32)._asdict().items()})
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        metrics = step(batch, generator=gen)
        assert np.isfinite(float(metrics["loss_total"]))
    after = model.state_dict()
    n_bb = 0
    for k, v in after.items():
        if k.startswith("backbone."):
            n_bb += 1
            assert torch.equal(v, before[k]), k
    assert n_bb > 0
    assert any(not torch.equal(v, before[k]) for k, v in after.items()
               if not k.startswith("backbone."))


def _ft_cfg_file(raw, work, init_from):
    """A config file derived from ``fgn_ft_mnistiseg.py``: the tiny split,
    the toy model at N1 K1, one repeat, one epoch."""
    fp = os.path.join(work, "ft_cfg.py")
    roots = dict(inner_root=raw, root=os.path.join(work, "fst"), repeats=1,
                 n_ways=1, k_shots=1)
    with open(fp, "w") as f:
        f.write(f"_base_ = [{os.path.join(CONFIGS, 'fgn_ft_mnistiseg.py')!r}]\n"
                f"model = {dict(TOY)!r}\n"
                + "".join(f"{k} = {roots!r}\n" for k in (
                    "ft_ds_cfg0", "ft_ds_cfg1", "eval_ds_cfg0", "eval_ds_cfg1"))
                + f"work_dir = {os.path.join(work, 'ft')!r}\n"
                f"init_from = {init_from!r}\n"
                "max_epochs = 1\nbatch_size = 2\neval_batch_size = 2\n"
                "max_gt = 8\nlog_interval = 1\n")
    return fp


def _stage1(work, cfg, step=7):
    """A stage-1 run's checkpoint of ``cfg``'s model (weights from seed 5)
    → its state_dict."""
    model = build_model(t_main.model_config_from_cfg(cfg), "cpu", seed=5)
    CheckpointManager(work).save(step, model.state_dict(), {},
                                 extra={"epoch": 1, "cursor": 0})
    return {k: v.clone() for k, v in model.state_dict().items()}


def test_finetune_merge_and_init_from(ft_raw, tiny_ds, tmp_path, capsys,
                                      monkeypatch):
    stage1 = str(tmp_path / "stage1")
    cfg = Config.from_file(_ft_cfg_file(ft_raw, str(tmp_path), stage1))
    want = _stage1(stage1, cfg)
    n0 = len(fst_bindings.init_ds_class_by_config(cfg.ft_ds_cfg0))
    n1 = len(fst_bindings.init_ds_class_by_config(cfg.ft_ds_cfg1))
    seen = {}

    def no_training(runner):
        seen["runner"] = runner
        return runner.model

    monkeypatch.setattr(t_main.Runner, "run", no_training)
    model = t_main.main(cfg, device="cpu")
    assert "Initialized from stage-1 checkpoint at step 7" in capsys.readouterr().out
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    runner = seen["runner"]
    ds = runner.train_ds
    assert ds.sampling_cats == "all" and ds.finetune == "Ignore"
    assert len(ds) == n0 + n1 and n0 > 0 and n1 > 0
    assert len(runner.evaluators) == 2  # eval_ds_cfg0, eval_ds_cfg1
    assert runner.batch_size == 2  # the FT config's batch, no heuristic

    cfg.init_from = str(tmp_path / "no_stage1")
    with pytest.raises(FileNotFoundError):
        t_main.main(cfg, device="cpu")


def test_run_grid_one_cell(ft_raw, tiny_ds, tmp_path, capsys, monkeypatch):
    stage1 = str(tmp_path / "stage1")
    fp = _ft_cfg_file(ft_raw, str(tmp_path), stage1)
    _stage1(stage1, Config.from_file(fp), step=3)
    grid = dict(gammas=(0.1,), nks=((1, 1),))

    # the JAX package's grid mutates the cell's config the same way
    jcfgs = []
    monkeypatch.setattr(j_main_ft, "main", lambda c: jcfgs.append(c))
    j_main_ft.run_grid(fp, **grid)
    (jcfg,) = jcfgs
    os.remove(os.path.join(jcfg.work_dir, "FT_DONE"))  # its stub's marker
    cfgs = []
    real_main = main_ft.main
    monkeypatch.setattr(main_ft, "main", lambda c, device: (
        cfgs.append((c, device)), real_main(c, device=device))[1])
    main_ft.run_grid(fp, device="cpu", **grid)
    ((cfg, device),) = cfgs
    assert device == "cpu"
    assert dict(cfg) == dict(jcfg)
    assert cfg.work_dir.endswith("N1K1_G0.1") and cfg.lr_schedule.gamma == 0.1
    out = capsys.readouterr().out
    assert "=== FT grid cell N1K1_G0.1 ===" in out
    assert "Initialized from stage-1 checkpoint at step 3" in out
    assert CheckpointManager(cfg.work_dir).latest_step() >= 1
    assert os.path.isfile(os.path.join(cfg.work_dir, "FT_DONE"))

    main_ft.run_grid(fp, device="cpu", **grid)
    assert len(cfgs) == 1
    assert f"Skipping completed {cfg.work_dir}" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["cfg.py"],
    ["cfg.py", "--gammas", "0.01,0.1"],
    ["cfg.py", "--nks", "3x3,3x1", "--gammas", "0.05"],
    ["cfg.py", "--nks", "1x1"],
])
def test_parse_args_equals_jax(argv):
    assert main_ft._parse_args(argv) == j_main_ft._parse_args(argv)
    assert main_ft._device_arg(argv + ["--device", "cpu"]) == ("cpu", argv)
    assert main_ft._device_arg(argv) == ("cuda", argv)
    with pytest.raises(SystemExit):
        main_ft._parse_args(argv + ["--bogus", "1"])


@pytest.mark.skipif(torch.cuda.is_available(), reason="a host without CUDA")
@pytest.mark.parametrize("module,extra", [
    ("fgn_torch.main", []),
    ("fgn_torch.main_ft", ["--gammas", "0.1", "--nks", "1x1"]),
])
def test_cli_defaults_to_cuda(tmp_path, module, extra):
    fp = os.path.join(CONFIGS, "fgn_train_mnistiseg_n1k1.py")
    if module.endswith("main_ft"):
        fp = _ft_cfg_file(str(tmp_path / "raw"), str(tmp_path),
                          str(tmp_path / "stage1"))
    proc = subprocess.run(
        [sys.executable, "-m", module, fp] + extra, cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr, proc.stderr[-2000:]
    assert not os.path.exists(os.path.join(ROOT, "runs", "mnistiseg_n1k1"))
