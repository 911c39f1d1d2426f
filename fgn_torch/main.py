"""Train / finetune / evaluate driver.

Port of the JAX package's ``main.py``, the reference entry point
(subprojects/sp02_omniiseg_fgn_mmdet/main.py:364-501): ``main(cfg)``
builds the episodic dataset(s), the FGN model, the optimizer and runner,
wires eval hooks discovered by ``eval_ds_cfg\\d`` key scan, handles the
finetune merge path (ft_ds_cfg0 + ft_ds_cfg1 → merge_ds), and resumes
from checkpoints. The N/K consistency asserts between model and dataset
configs are kept (reference main.py:396-400).

Everything runs on ``cuda`` unless the caller passes ``device="cpu"`` (or
``--device cpu``); without a GPU the default raises.

Under ``torchrun`` each process is one rank of a data-parallel run
(``parallel/mesh.py``): the config's batch sizes are the global batches,
each rank steps its rows, rank 0 logs, writes checkpoints and scores the
evals. NCCL needs a card for each rank; ranks that share a card run over
gloo only when asked to (``--backend gloo``).

Usage:
    python -m fgn_torch.main fgn_torch/configs/fgn_train_mnistiseg_n1k1.py \
        [--device cpu]
    torchrun --nproc_per_node W -m fgn_torch.main <config> \
        [--backend gloo] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import re
import tempfile
from typing import Callable, List, Optional, Tuple

import torch

if os.environ.get("FGN_STACK_DUMP_S"):
    # Hang forensics: periodically dump every thread's Python stack. Dumps
    # go to FGN_STACK_DUMP_FILE (default fgn_stacks_<pid>.log in the
    # temporary directory), NOT stderr: the watchdog and stall-nudger
    # detect hangs via log-file mtime, and periodic dumps into the same
    # log keep refreshing it — a deadlocked run then looks alive forever.
    import faulthandler

    _dump_fp = os.environ.get(
        "FGN_STACK_DUMP_FILE",
        os.path.join(tempfile.gettempdir(), f"fgn_stacks_{os.getpid()}.log"),
    )
    _dump_f = open(_dump_fp, "a", buffering=1)
    faulthandler.dump_traceback_later(
        int(os.environ["FGN_STACK_DUMP_S"]), repeat=True, file=_dump_f
    )

from fgn_torch.config import Config, FGNConfig
from fgn_torch.data.fst_bindings import init_ds_class_by_config
from fgn_torch.models.fgn import build_model
from fgn_torch.parallel.mesh import (
    Mesh, close, make_mesh, rank0_first, replicate,
)
from fgn_torch.train.checkpoints import CheckpointManager
from fgn_torch.train.evaluator import Evaluator
from fgn_torch.train.loop import Runner
from fgn_torch.train.optim import FGNOptimizer, build_optimizer, make_lr_schedule
from fgn_torch.train.train_step import make_eval_step, make_train_step


def model_config_from_cfg(cfg: Config) -> FGNConfig:
    fields = {f.name for f in dataclasses.fields(FGNConfig)}
    kwargs = {k: v for k, v in dict(cfg.model).items() if k in fields}
    for k in ("anchor_scales", "anchor_ratios", "rcnn_bbox_stds"):
        if k in kwargs:
            kwargs[k] = tuple(kwargs[k])
    return FGNConfig(**kwargs)


def batch_heuristic(n_ways: int, k_shots: int) -> int:
    """Reference batch-size heuristic by (N, K)
    (main.py:487-501): N1K1 → 12, N3K1 → 10, N3K3 → 8.

    N3K1 is capped at 8 here for QUALITY: b10 under-trains
    way-classification on this data (0.235 vs 0.951 fresh bbox mAP,
    RESULTS.md "N3K1 batch-10")."""
    if n_ways == 1 and k_shots == 1:
        return 12
    return 8


def lr_schedule_from_cfg(cfg: Config, steps_per_epoch: int
                         ) -> Tuple[Callable[[int], float], int]:
    """→ (the schedule in OPTIMIZER steps, ``cumulative_iters``).

    Under gradient accumulation the optimizer's update counter advances
    once per ``cumulative_iters`` micro-batches, so schedule
    boundaries/warmup are expressed in optimizer steps to keep the
    reference's per-epoch decay timing."""
    cum_iters = max(int(cfg.optimizer.get("cumulative_iters", 1)), 1)
    lr_kwargs = {k: v for k, v in dict(cfg.lr_schedule).items()}
    if lr_kwargs.get("type") == "cosine":
        lr_kwargs.setdefault("total_epochs", int(cfg.max_epochs))
    if cum_iters > 1:
        lr_kwargs["warmup_iters"] = max(
            int(lr_kwargs.get("warmup_iters", 100)) // cum_iters, 1
        )
    schedule = make_lr_schedule(
        base_lr=float(cfg.optimizer.lr),
        steps_per_epoch=max(steps_per_epoch // cum_iters, 1),
        **lr_kwargs,
    )
    return schedule, cum_iters


def optimizer_from_cfg(cfg: Config, model: torch.nn.Module,
                       steps_per_epoch: int) -> FGNOptimizer:
    """The config's optimizer over ``model`` with its schedule
    (``lr_schedule_from_cfg``); a frozen-pretrained backbone (the config's
    ``model.backbone_frozen``, reference main.py:402-405 + fgn.py:52-53) is
    excluded from updates entirely."""
    schedule, cum_iters = lr_schedule_from_cfg(cfg, steps_per_epoch)
    return build_optimizer(
        model,
        base_lr=float(cfg.optimizer.lr),
        weight_decay=float(cfg.optimizer.weight_decay),
        optimizer=cfg.optimizer.type,
        roi_head_lr_mult=float(cfg.optimizer.get("roi_head_lr_mult", 0.1)),
        schedule=schedule,
        cumulative_iters=cum_iters,
        frozen_modules=(
            ("backbone",) if model_config_from_cfg(cfg).backbone_frozen else ()
        ),
    )


def init_from_checkpoint(model: torch.nn.Module, work_dir: str,
                         verbose: bool = True) -> int:
    """Load the weights of the latest checkpoint of the run in ``work_dir``
    into ``model`` (on its device); → that checkpoint's step. Only the
    weights are read: the stage-1 run's optimizer and dataset state belong
    to another dataset."""
    device = next(model.parameters()).device
    loaded = CheckpointManager(work_dir).load_model(map_location=device)
    if loaded is None:
        # Hard error: silently finetuning from scratch would produce a
        # plausible-looking but protocol-invalid FT cell.
        raise FileNotFoundError(
            f"no stage-1 checkpoint in {work_dir} — run the matching "
            "stage-1 config first"
        )
    step, state = loaded
    model.load_state_dict(state)
    if verbose:
        print(f"Initialized from stage-1 checkpoint at step {step}")
    return step


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "fgn_torch.main: no CUDA device; pass device='cpu' "
            "(--device cpu) to run on the CPU"
        )
    return device


def main(cfg: Config, device="cuda", mesh: Optional[Mesh] = None,
         backend: Optional[str] = None):
    """Train (or finetune) from ``cfg``. ``mesh`` is this rank's place in a
    data-parallel run; without one, ``make_mesh(backend, device)`` makes it
    (one rank without ``torchrun``)."""
    if mesh is None:
        _device(device)
        mesh = make_mesh(backend=backend, device=device)
    device = mesh.device
    mcfg = model_config_from_cfg(cfg)

    # --- datasets -------------------------------------------------------
    is_ft = "ft_ds_cfg0" in cfg

    def datasets():
        if is_ft:
            ds0 = init_ds_class_by_config(cfg.ft_ds_cfg0)
            ds1 = init_ds_class_by_config(cfg.ft_ds_cfg1)
            ds0.merge_ds(ds1)
            train_ds = ds0
        else:
            train_ds = init_ds_class_by_config(cfg.train_ds_cfg)
        eval_dss = [init_ds_class_by_config(cfg[key]) for key in sorted(cfg)
                    if re.fullmatch(r"eval_ds_cfg\d+", key)]
        return train_ds, eval_dss

    # rank 0 builds the datasets' disk caches, the other ranks read them
    train_ds, eval_dss = rank0_first(datasets, mesh)

    # N/K consistency (reference main.py:396-400)
    assert train_ds.n_ways == mcfg.n_ways
    assert train_ds.k_shots == mcfg.k_shots

    batch_size = int(cfg.get("batch_size") or batch_heuristic(mcfg.n_ways, mcfg.k_shots))
    max_gt = int(cfg.get("max_gt", 30))
    # Run seed (config key `seed`, default 0): drives the weights' init and
    # the Runner's train-forward sampling generator — distinct seeds give
    # independent training trajectories (dataset order stays the
    # reference's epoch-seeded reshuffle).
    run_seed = int(cfg.get("seed", 0))

    # --- model / optimizer ----------------------------------------------
    model = build_model(mcfg, device, seed=run_seed)

    maybe_ckpt = cfg.get("checkpoint_fp") or ""
    if maybe_ckpt:
        from fgn_torch.models.convert import load_torch_backbone

        load_torch_backbone(model, maybe_ckpt)

    steps_per_epoch = max(len(train_ds) // batch_size, 1)
    optimizer = optimizer_from_cfg(cfg, model, steps_per_epoch)
    schedule, cum_iters = optimizer.schedule, optimizer.cumulative_iters
    train_step = make_train_step(model, optimizer, mesh)
    eval_step = make_eval_step(model, mesh)

    # --- eval hooks (key scan like reference main.py:453-475) ------------
    evaluators: List[Evaluator] = [
        Evaluator(
            model, eval_ds,
            batch_size=int(cfg.get("eval_batch_size", 4)),
            eval_step=eval_step,
            work_dir=str(cfg.work_dir),
            max_gt=max_gt,
            mask_thr=mcfg.mask_thr,
            cache_episodes=bool(cfg.get("eval_cache_episodes", True)),
            mesh=mesh,
        )
        for eval_ds in eval_dss
    ]

    # --- stage-1 checkpoint for FT (reference main_ft.py:104-109) --------
    if is_ft and cfg.get("init_from"):
        init_from_checkpoint(model, str(cfg.init_from), verbose=mesh.is_main)
    # every rank's weights are rank 0's (each built them from the same
    # seed and files; the broadcast makes it so whatever the init did)
    replicate(model, mesh)

    runner = Runner(
        model, optimizer, train_step, train_ds,
        batch_size=batch_size,
        work_dir=str(cfg.work_dir),
        max_epochs=int(cfg.get("max_epochs", 3)),
        eval_interval_iters=(
            int(cfg["eval_interval_iters"])
            if cfg.get("eval_interval_iters") else None
        ),
        evaluators=evaluators,
        max_gt=max_gt,
        max_keep_ckpts=int(cfg.get("max_keep_ckpts", 3)),
        log_interval=int(cfg.get("log_interval", 50)),
        seed=run_seed,
        # TB logs LR in micro-step domain (the Runner's step counter).
        lr_schedule=(
            schedule if cum_iters == 1
            else (lambda s: schedule(s // cum_iters))
        ),
        hparams={
            "optimizer": dict(cfg.optimizer),
            "lr_schedule": dict(cfg.lr_schedule),
            "model": dict(cfg.model),
            "batch_size": batch_size,
        },
        mesh=mesh,
    )
    runner.resume()
    return runner.run()


def _parse_cli(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(description="Train or finetune FGN from a "
                                             "config file.")
    ap.add_argument("config", help="config file (fgn_torch/configs/*.py)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu to run on the CPU)")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="process-group backend under torchrun (default: "
                         "nccl with a card for each rank, gloo on the CPU; "
                         "gloo to run ranks on a shared card)")
    return ap.parse_args(argv)


if __name__ == "__main__":
    args = _parse_cli()
    _device(args.device)
    mesh = make_mesh(backend=args.backend, device=args.device)
    try:
        main(Config.from_file(args.config), mesh=mesh)
    finally:
        close()
