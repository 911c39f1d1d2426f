"""Finetune grid driver.

Port of the JAX package's ``main_ft.py``, the reference's main_ft.py:54-137:
grid over step-γ ∈ {.01, .05, .1} × (N, K) ∈ {(1,1), (3,1), (3,3)},
mutating the base finetune config per cell (N/K into model + dataset
configs, per-N-K stage-1 checkpoint, per-cell work_dir), skipping cells
whose work_dir holds an FT_DONE completion marker (crash resumability).

Under ``torchrun`` every rank runs the grid (``main`` reuses the process
group); rank 0 decides whether a cell is done and broadcasts it, and writes
the marker.

Usage:
    python -m fgn_torch.main_ft fgn_torch/configs/fgn_ft_coco2voc.py \
        [--gammas 0.01,0.1] [--nks 3x3,3x1] [--device cpu]
    torchrun --nproc_per_node W -m fgn_torch.main_ft <config> ... \
        [--backend gloo]
"""

from __future__ import annotations

import os
import sys
import time

from fgn_torch.config import Config
from fgn_torch.main import main
from fgn_torch.parallel.mesh import barrier, broadcast_object, close, make_mesh

GAMMAS = (0.01, 0.05, 0.1)
NK_GRID = ((1, 1), (3, 1), (3, 3))


def run_grid(base_cfg_fp: str, cooldown_s: int = 0, gammas=None, nks=None,
             device="cuda", backend=None):
    mesh = make_mesh(backend=backend, device=device)
    for gamma in (gammas or GAMMAS):
        for n, k in (nks or NK_GRID):
            cfg = Config.from_file(base_cfg_fp)
            cfg.model.n_ways = n
            cfg.model.k_shots = k
            for key in list(cfg):
                if key.startswith(("ft_ds_cfg", "eval_ds_cfg", "train_ds_cfg")):
                    cfg[key]["n_ways"] = n
                    cfg[key]["k_shots"] = k
            cfg.lr_schedule.gamma = gamma
            # The reference grid keeps the FT configs' batch (its FT
            # work_dirs are literally named "N{n}-K{k}-B4 DCL-FT …",
            # main_ft.py:126) — the stage-1 batch heuristic never
            # applies to finetuning.
            cell = f"N{n}K{k}_G{gamma}"
            cfg.work_dir = os.path.join(str(cfg.work_dir), cell)
            if cfg.get("init_from"):
                cand = f"{cfg.init_from}_N{n}K{k}"
                if os.path.isdir(cand):
                    cfg.init_from = cand
            # Crash resumability: only a COMPLETED cell is skipped. The
            # reference skips on bare dir existence (main_ft.py:122-124),
            # but under a crash-restarting supervisor that turns a cell
            # that died mid-run into a silent no-op.
            done_marker = os.path.join(str(cfg.work_dir), "FT_DONE")
            if broadcast_object(os.path.exists(done_marker), mesh):
                if mesh.is_main:
                    print(f"Skipping completed {cfg.work_dir}")
                continue
            if mesh.is_main:
                print(f"=== FT grid cell {cell} ===")
            main(cfg, device=device)
            if mesh.is_main:
                os.makedirs(str(cfg.work_dir), exist_ok=True)
                with open(done_marker, "w") as f:
                    f.write(time.strftime("%Y-%m-%d %H:%M:%S\n"))
            barrier(mesh)
            if cooldown_s:
                time.sleep(cooldown_s)


def _parse_args(argv):
    cfg_fp = argv[0]
    gammas = nks = None
    i = 1
    while i < len(argv):
        if argv[i] == "--gammas":
            gammas = tuple(float(v) for v in argv[i + 1].split(","))
            i += 2
        elif argv[i] == "--nks":
            nks = tuple(
                tuple(int(x) for x in v.split("x"))
                for v in argv[i + 1].split(",")
            )
            i += 2
        else:
            raise SystemExit(f"unknown arg {argv[i]}")
    return cfg_fp, gammas, nks


def _device_arg(argv, flag="--device", default="cuda"):
    """→ (the value of ``flag``, ``default`` without it; argv without
    it)."""
    if flag not in argv:
        return default, list(argv)
    i = argv.index(flag)
    return argv[i + 1], list(argv[:i]) + list(argv[i + 2:])


if __name__ == "__main__":
    device, argv = _device_arg(sys.argv[1:])
    backend, argv = _device_arg(argv, "--backend", None)
    cfg_fp, gammas, nks = _parse_args(argv)
    try:
        run_grid(cfg_fp, gammas=gammas, nks=nks, device=device,
                 backend=backend)
    finally:
        close()
