"""Data-parallel dry run, and the ranks it spawns.

The port's twin of the JAX package's ``__graft_entry__.dryrun_multichip``:
W ranks, each a process, step the toy configuration's full train step (its
gradients summed over the ranks) twice, run one eval step gathered into
the global batch, save a checkpoint from rank 0, restore it on every rank
equal bit for bit, and step once more from it::

    python -m fgn_torch.parallel.dryrun --ranks 2 [--backend gloo] \\
        [--device cpu]

It prints ``dryrun_multichip(W): ... OK`` and exits 0, or exits 1. Ranks on
one card need ``--backend gloo`` (``parallel/mesh.py``).

``spawn_ranks`` starts the ranks (``spawn``, a ``file://`` rendezvous in a
temporary directory, a timeout after which every rank is killed); the rank
bodies below take numpy inputs and return numpy results, so a caller that
holds the port to another implementation (the CPU tests) keeps that
implementation in its own process: a rank imports torch and fgn_torch only.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import queue
import shutil
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from fgn_torch.parallel.mesh import Mesh, make_mesh

# The JAX dry run's configuration (__graft_entry__.py:98-103).
DRYRUN_CFG = dict(
    n_ways=3, k_shots=1, backbone_norm="gn", backbone_frozen=False,
    rpn_train_nms_pre=256, rpn_train_max_per_img=64,
    rpn_test_nms_pre=256, rpn_test_max_per_img=32,
    rpn_num_samples=16, rcnn_num_samples=16, rcnn_max_per_img=8,
)


class RankFailure(RuntimeError):
    """A rank raised, exited with a code other than 0, or outlived the
    timeout."""


def _rank_entry(rank: int, world: int, init: str, backend: Optional[str],
                device: str, threads: int, body: Callable, args: Sequence,
                results):
    torch.set_num_threads(threads)
    try:
        mesh = make_mesh(backend=backend, device=device, init_method=init,
                         rank=rank, world_size=world)
        out = body(mesh, *args)
        results.put((rank, "ok", out))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        raise


def spawn_ranks(body: Callable, world: int, args: Sequence = (),
                backend: Optional[str] = None, device: str = "cpu",
                timeout: float = 120.0, threads: int = 2,
                exit_codes: Optional[Dict[int, int]] = None) -> List[Any]:
    """Run ``body(mesh, *args)`` in ``world`` spawned ranks (a module-level
    function: the ranks import it) and → each rank's result, in rank order.
    ``exit_codes`` maps a rank to the exit code it must end with when it is
    not 0 (a rank that exits on purpose returns no result: None). Raises
    ``RankFailure`` when a rank raises, ends otherwise, or is still running
    after ``timeout`` seconds; every rank is killed then."""
    import multiprocessing as mp

    want = {r: (exit_codes or {}).get(r, 0) for r in range(world)}
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    rdv = tempfile.mkdtemp(prefix="fgn_ranks_")
    procs = [ctx.Process(
        target=_rank_entry,
        args=(r, world, f"file://{os.path.join(rdv, 'rendezvous')}", backend,
              device, threads, body, tuple(args), results))
        for r in range(world)]
    out: Dict[int, Any] = {}
    errors: List[str] = []
    try:
        for p in procs:
            p.start()
        # drain the queue before joining: a rank blocks on a full pipe
        n_results = sum(1 for c in want.values() if c == 0)
        deadline = time.monotonic() + timeout
        while len(out) + len(errors) < n_results:
            if not any(p.is_alive() for p in procs) and results.empty():
                break
            try:
                rank, status, value = results.get(
                    timeout=max(min(deadline - time.monotonic(), 1.0), 0.01))
            except queue.Empty:
                if time.monotonic() > deadline:
                    raise RankFailure(f"ranks still running after {timeout} s")
                continue
            if status == "ok":
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
        late = [r for r, p in enumerate(procs) if p.is_alive()]
        if late:
            raise RankFailure(f"ranks {late} still running after {timeout} s")
        codes = {r: p.exitcode for r, p in enumerate(procs)}
        if errors or codes != want:
            raise RankFailure(f"exit codes {codes}, want {want}\n"
                              + "\n".join(errors))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
        results.close()
        shutil.rmtree(rdv, ignore_errors=True)
    return [out.get(r) for r in range(world)]


# -- rank bodies ------------------------------------------------------------------


def _model(mesh: Mesh, spec: Dict):
    """The model of ``spec``: ``cfg`` (FGNConfig fields), ``state`` (its
    state_dict as numpy; None: ``build_model``'s seeded init) and
    ``param_dtype`` (the parameters' dtype, default float32)."""
    from fgn_torch.config import FGNConfig
    from fgn_torch.models.fgn import build_model

    model = build_model(FGNConfig(**spec["cfg"]), mesh.device, seed=0)
    if spec.get("state") is not None:
        model.load_state_dict({k: torch.from_numpy(np.array(v))
                               for k, v in spec["state"].items()})
    return model.to(getattr(torch, spec.get("param_dtype", "float32")))


def run_bodies(mesh: Mesh, calls: Sequence) -> List[Any]:
    """``[body(mesh, arg) for body, arg in calls]``: several rank bodies in
    one start of the ranks."""
    return [body(mesh, arg) for body, arg in calls]


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def train_rank(mesh: Mesh, spec: Dict) -> Dict:
    """Steps of the data-parallel train step on given inputs. ``spec``:
    the model (``_model``), ``optimizer`` (``build_optimizer``
    keywords; ``schedule`` as ``make_lr_schedule`` keywords), and ``steps``:
    each a global numpy batch (``fields``) with either the global draws
    (``draws``: {"rpn", "rcnn"} numpy) or a generator seed (``seed``, the
    generator reseeded at that step); ``keep``: {"grads": step indices,
    "params": step indices} whose gradients and parameters to return (all
    when absent). → per step the metrics, a digest of the parameters
    after it (equal digests, equal bits), and the summed gradients and the
    parameters after it where kept, as numpy ({name: array})."""
    from fgn_torch.data.batching import EpisodeBatch
    from fgn_torch.parallel.mesh import rank_rows, shard_batch
    from fgn_torch.train.optim import build_optimizer, make_lr_schedule
    from fgn_torch.train.train_step import make_train_step

    model = _model(mesh, spec)
    kw = dict(spec.get("optimizer", {}))
    if "schedule" in kw:
        kw["schedule"] = make_lr_schedule(**kw["schedule"])
    opt = build_optimizer(model, **kw)
    step = make_train_step(model, opt, mesh)
    gen = torch.Generator(device=mesh.device)
    keep = spec.get("keep", {})
    out = []
    for i, s in enumerate(spec["steps"]):
        batch = shard_batch(EpisodeBatch(**s["fields"]), mesh)
        draws = None
        if s.get("draws") is not None:
            mine = {k: torch.from_numpy(np.array(
                v[rank_rows(v.shape[0], mesh)])).to(mesh.device)
                for k, v in s["draws"].items()}

            def draws(name, shape, mine=mine):
                assert tuple(mine[name].shape) == tuple(shape), (
                    name, tuple(mine[name].shape), shape)
                return mine[name]
        else:
            gen.manual_seed(int(s["seed"]))
        metrics = step(batch, generator=gen, draws=draws)
        digest = hashlib.sha1()
        for p in model.parameters():
            digest.update(_numpy(p).tobytes())
        rec = {"metrics": {k: float(v) for k, v in metrics.items()},
               "digest": digest.hexdigest()}
        if i in keep.get("grads", [i]):
            rec["grads"] = {n: _numpy(p.grad)
                            for n, p in model.named_parameters()
                            if p.grad is not None}
        if i in keep.get("params", [i]):
            rec["params"] = {n: _numpy(p) for n, p in model.named_parameters()}
        out.append(rec)
    return out


def eval_rank(mesh: Mesh, spec: Dict) -> Dict[str, np.ndarray]:
    """The data-parallel eval step on a global numpy batch (``fields``):
    the model as ``_model`` reads ``spec``. → the gathered detections,
    unpacked, as numpy."""
    from fgn_torch.data.batching import EpisodeBatch
    from fgn_torch.parallel.mesh import shard_batch
    from fgn_torch.train.train_step import make_eval_step, unpack_eval_out_np

    model = _model(mesh, spec)
    out = make_eval_step(model, mesh)(
        shard_batch(EpisodeBatch(**spec["fields"]), mesh))
    return unpack_eval_out_np({k: _numpy(v) for k, v in out.items()})


def dryrun_rank(mesh: Mesh, work: str) -> Optional[str]:
    """The dry run on one rank (module docstring). → rank 0's report line
    (None on the others); raises on any failed check."""
    from fgn_torch.data.batching import toy_batch
    from fgn_torch.parallel.mesh import (
        all_gather_rows, replicate, shard_batch,
    )
    from fgn_torch.train.checkpoints import CheckpointManager
    from fgn_torch.train.optim import build_optimizer, make_lr_schedule
    from fgn_torch.train.train_step import make_eval_step, make_train_step

    W = mesh.world_size
    model = replicate(_model(mesh, {"cfg": DRYRUN_CFG}), mesh)
    opt = build_optimizer(model, schedule=make_lr_schedule(
        5e-3, steps_per_epoch=100))
    step = make_train_step(model, opt, mesh)
    batch = shard_batch(toy_batch(B=W, H=64, W=64, N=3, K=1, S=32), mesh)
    gen = torch.Generator(device=mesh.device).manual_seed(2)
    totals = []
    for _ in range(2):
        total = float(step(batch, generator=gen)["loss_total"])
        if not np.isfinite(total):
            raise RuntimeError("dryrun: a data-parallel step gave a "
                               "non-finite loss")
        totals.append(total)
    # every rank holds the same parameters
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    ranks = all_gather_rows(flat[None], mesh)
    if not all(torch.equal(ranks[0], r) for r in ranks):
        raise RuntimeError("dryrun: the ranks' parameters differ")

    det = make_eval_step(model, mesh)(batch)
    if det["dt_pack"].shape[0] != W or not bool(
            torch.isfinite(det["dt_pack"]).all()):
        raise RuntimeError(f"dryrun: eval gave {tuple(det['dt_pack'].shape)}"
                           " or non-finite detections")

    ckpt = CheckpointManager(work, max_keep=1, mesh=mesh)
    ckpt.save(1, model.state_dict(), opt.state_dict(), extra={"epoch": 0})
    step_r, state = ckpt.restore(map_location=mesh.device)
    if step_r != 1:
        raise RuntimeError(f"dryrun: restored step {step_r}, want 1")
    for k, v in model.state_dict().items():
        if not torch.equal(v, state["model"][k]):
            raise RuntimeError(f"dryrun: restored {k} differs")
    model.load_state_dict(state["model"])
    opt.load_state_dict(state["optimizer"])
    if not np.isfinite(float(step(batch, generator=gen)["loss_total"])):
        raise RuntimeError("dryrun: the step after the restore gave a "
                           "non-finite loss")
    if not mesh.is_main:
        return None
    return (f"dryrun_multichip({W}): steps=2 losses={totals[0]:.4f},"
            f"{totals[1]:.4f} eval_ok=True ckpt_restore_ok=True OK")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds before every rank is killed")
    args = ap.parse_args(argv)
    work = tempfile.mkdtemp(prefix="fgn_dryrun_ckpt_")
    try:
        lines = spawn_ranks(dryrun_rank, args.ranks, (work,),
                            backend=args.backend, device=args.device,
                            timeout=args.timeout)
    except RankFailure as e:
        print(f"dryrun_multichip({args.ranks}): FAILED\n{e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(lines[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
