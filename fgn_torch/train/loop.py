"""Training runner: epochs over episode loaders, TB metrics, mid-epoch
checkpoint + eval, resume.

Port of the JAX package's ``train/loop.py``, the reference's
OptEpochBasedRunner / main(cfg)
(subprojects/sp02_omniiseg_fgn_mmdet/main.py:79-257,364-484):

  * per-iter wall time → ``Time/TrainStep``; per-epoch → ``Time/TrainEpoch``;
    per-eval → ``Time/Evaluation`` (reference tag names kept);
  * LR logged per step; loss scalars under ``Train/``;
  * mid-epoch checkpoint + eval every ``max(2000, len/8)`` iters,
    soft-failing (warn and continue) like the reference's try/except
    (main.py:157-177);
  * per-epoch dataset reshuffle(epoch);
  * resume restores model/optimizer/step/epoch + dataset state AND the
    in-epoch batch cursor: an end-of-epoch checkpoint records the NEXT
    epoch (so completed epochs never replay — the mmcv runner saves
    epoch+1 the same way), a mid-epoch checkpoint records how many
    batches were consumed and the resumed epoch skips exactly that many.
    When a mid-epoch check falls on an epoch's last step, its checkpoint
    stands and the end-of-epoch save at that step is skipped (orbax's rule
    in the JAX package): a resume from it runs the rest of that epoch,
    which is empty, and its end-of-epoch check.

The model and the optimizer are updated in place by ``train_step(batch,
generator=...)`` (``make_train_step``). Its random draws come from one
``torch.Generator`` on the model's device, seeded with the run seed; a
resume reseeds it from ``(seed, step)``, so a restart neither replays the
draws of step 0 nor differs from another restart at the same step. On CUDA
each batch goes to the device through pinned buffers with asynchronous
copies (the evaluator's ``Staging``), uploaded while the previous step
runs.

Data-parallel (a ``mesh`` with a process group, ``train_step`` made with the
same mesh): ``batch_size`` is the global batch. Every rank builds every
episode of each global batch in the one-rank loader's order
(``FewShotISEG.__getitem__`` draws from Python's global ``random`` in
sequence, so a rank that built only its rows would draw other episodes)
and uploads only its rows (``shard_batch``); every rank's generator is
seeded as the one-rank run's and draws at the global batch's shapes
(``parallel/mesh.py::rank_draws``). ``start_batch`` and the cursor count
global batches. Rank 0 alone logs, writes tensorboardX events and
checkpoints; the RSS limit is decided over all ranks at once (the largest
rank's RSS), and then every rank exits.
"""

from __future__ import annotations

import os
import time
import traceback
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from fgn_torch.data.batching import EpisodeLoader
from fgn_torch.parallel.mesh import Mesh, global_max, rank_rows, shard_batch
from fgn_torch.train.checkpoints import CheckpointManager
from fgn_torch.train.evaluator import Staging
from fgn_torch.utils.timers import datetime_log_fancy


def _rss_gb() -> float:
    """Resident set size in GB (no psutil in the image)."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 1e9
    except Exception:
        return float("nan")


def resume_seed(seed: int, step: int) -> int:
    """The generator's seed after a resume at ``step``: a function of
    ``(seed, step)`` alone, different from ``seed``'s stream."""
    return int(np.random.SeedSequence([int(seed), int(step)])
               .generate_state(1, np.uint64)[0])


class Runner:
    # one rank unless ``__init__`` is given a mesh
    mesh: Optional[Mesh] = None
    is_main = True

    def __init__(
        self,
        model: torch.nn.Module,
        optimizer: torch.optim.Optimizer,
        train_step,
        train_ds,
        batch_size: int,
        work_dir: str,
        max_epochs: int = 3,
        evaluators: Optional[List] = None,
        eval_interval_iters: Optional[int] = None,
        max_gt: int = 30,
        pad_hw=None,
        max_keep_ckpts: int = 3,
        log_interval: int = 50,
        seed: int = 0,
        lr_schedule=None,
        hparams: Optional[Dict] = None,
        mesh: Optional[Mesh] = None,
    ):
        rank_rows(batch_size, mesh)  # raises unless the ranks divide it
        self.mesh = mesh
        self.is_main = mesh is None or mesh.is_main
        self.model = model
        self.optimizer = optimizer
        self.train_step = train_step
        self.train_ds = train_ds
        self.batch_size = batch_size
        self.work_dir = work_dir
        self.max_epochs = max_epochs
        self.evaluators = evaluators or []
        self.max_gt = max_gt
        self.pad_hw = pad_hw
        self.log_interval = log_interval
        self.lr_schedule = lr_schedule
        self.hparams = hparams or {}
        self.device = next(model.parameters()).device
        self.seed = int(seed)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed)
        self.step = 0
        self.epoch = 0

        os.makedirs(work_dir, exist_ok=True)
        self.ckpt = CheckpointManager(work_dir, max_keep=max_keep_ckpts,
                                      mesh=mesh)
        self.tb = None
        if self.is_main:
            try:
                from tensorboardX import SummaryWriter

                self.tb = SummaryWriter(os.path.join(work_dir, "tb"))
            except Exception:
                pass
            print("tensorboard: " + (
                f"tensorboardX live, events in {os.path.join(work_dir, 'tb')}"
                if self.tb is not None else "tensorboardX absent, no events"))

        steps_per_epoch = max(len(train_ds) // batch_size, 1)
        # Mid-epoch cadence (reference: main.py:153-177,230-238).
        self.part = eval_interval_iters or max(2000, steps_per_epoch // 8)
        self._ckpt_every = int(os.environ.get("FGN_CKPT_EVERY", "0"))

    # -- logging ---------------------------------------------------------

    def _tracemalloc_tick(self):
        """Opt-in Python-allocation leak probe (FGN_TRACEMALLOC=1): every
        log interval, print the top allocation-site growth since the last
        tick. Python/numpy leaks name their line; RSS growth WITHOUT
        tracemalloc growth means a native leak."""
        if os.environ.get("FGN_GC_TICK") == "1":
            # Leak-probe companion: tensors are small Python objects holding
            # big native buffers, so cyclic garbage that the
            # allocation-count-driven collector is slow to reach shows up
            # as native growth with a flat tracemalloc trace.
            import gc

            n = gc.collect()
            dev = ""
            if self.device.type == "cuda":
                dev = (f"; CUDA allocated "
                       f"{torch.cuda.memory_allocated(self.device) / 1e9:.2f} GB")
            trimmed = ""
            try:
                import ctypes

                before = _rss_gb()
                ctypes.CDLL("libc.so.6").malloc_trim(0)
                trimmed = f"; malloc_trim {before - _rss_gb():+.2f} GB"
            except Exception:
                pass
            print(f"[gc] collected {n}{dev}{trimmed}")
        if os.environ.get("FGN_TRACEMALLOC") != "1":
            return
        import tracemalloc

        if not tracemalloc.is_tracing():
            tracemalloc.start(10)
            self._tm_last = None
            return
        snap = tracemalloc.take_snapshot().filter_traces(
            [tracemalloc.Filter(False, tracemalloc.__file__)]
        )
        traced_mb = tracemalloc.get_traced_memory()[0] / 1e6
        if getattr(self, "_tm_last", None) is not None:
            top = snap.compare_to(self._tm_last, "lineno")[:5]
            print(f"[tracemalloc] traced total {traced_mb:.0f} MB; top growth:")
            for stat in top:
                print(f"  {stat}")
        self._tm_last = snap

    def _scalar(self, tag: str, value: float):
        if self.tb is not None:
            self.tb.add_scalar(tag, float(value), self.step)

    def _log_hyperparams(self):
        """LR per step + one-time hparam text card (reference
        OptEpochBasedRunner.log_hyperparams: main.py:99-151)."""
        if self.lr_schedule is not None:
            self._scalar("Hyperparams/LR", float(self.lr_schedule(self.step)))
        if self.step == 0 and self.tb is not None and self.hparams:
            text = "\n".join(f"{k}: {v}" for k, v in sorted(self.hparams.items()))
            self.tb.add_text("Hyperparams/config", text, 0)

    # -- checkpoint + eval -----------------------------------------------

    def save_ckpt(self, epoch: Optional[int] = None, cursor: int = 0):
        """Checkpoint only (no evals); soft-fail like the reference.

        ``epoch``/``cursor`` describe where a resume should CONTINUE:
        end-of-epoch saves (epoch + 1, 0), mid-epoch saves the batch
        count consumed so far. Prints a liveness line — the watchdog
        and stall nudger supervise by log mtime."""
        try:
            self.ckpt.save(
                self.step, self.model.state_dict(),
                self.optimizer.state_dict(),
                extra={
                    "epoch": self.epoch if epoch is None else int(epoch),
                    "cursor": int(cursor),
                    "ds_state": self.train_ds.state_dict(),
                },
            )
            if self.is_main:
                print(f"[{datetime_log_fancy()}] ckpt scheduled at step "
                      f"{self.step}")
        except Exception:
            print("WARNING: checkpoint save failed")
            traceback.print_exc()

    def check(self, epoch: Optional[int] = None, cursor: int = 0):
        """Checkpoint then run all eval hooks (reference main.py:157-177)."""
        self.save_ckpt(epoch=epoch, cursor=cursor)
        for ev in self.evaluators:
            try:
                # Phase marker: the stall nudger reads this line and
                # switches to its slow threshold (tools/stall_nudge.py).
                if self.is_main:
                    print(f"[{datetime_log_fancy()}] eval pass starting")
                t0 = time.monotonic()
                metrics = ev.run()
                self._scalar("Time/Evaluation", (time.monotonic() - t0) * 1000)
                for k, v in metrics.items():
                    self._scalar(k, v)
                if self.is_main:
                    print(f"[{datetime_log_fancy()}] step {self.step} eval:",
                          metrics)
            except Exception:
                print("WARNING: evaluation failed")
                traceback.print_exc()
        self._rss_relief()

    # Convert an eventual host OOM kill into a PLANNED restart at a
    # checkpoint boundary: exit with a dedicated code the watchdog
    # (tools/watchdog.py) always restarts, and the exact checkpoint+cursor
    # resume continues the run.
    RSS_RELIEF_EXIT_CODE = 42

    def _rss_relief(self):
        limit = float(os.environ.get("FGN_MAX_RSS_GB", "100"))
        if limit <= 0:
            return
        rss = _rss_gb()
        if self.mesh is not None and self.mesh.group is not None:
            # decided together: a rank that left alone would leave the
            # others waiting in their next collective
            rss = float(global_max(torch.tensor([rss], dtype=torch.float64,
                                                device=self.mesh.device),
                                   self.mesh).item())
        if rss <= limit:
            return
        if self.is_main:
            print(
                f"[{datetime_log_fancy()}] host RSS {rss:.1f} GB > "
                f"{limit:.0f} GB — planned restart at step {self.step}",
                flush=True,
            )
        self.ckpt.wait()
        if self.tb is not None:
            try:
                self.tb.flush()
            except Exception:
                pass
        os._exit(self.RSS_RELIEF_EXIT_CODE)

    def resume(self) -> bool:
        restored = self.ckpt.restore(map_location=self.device)
        if restored is None:
            return False
        step, state = restored
        self.step = step
        # Fresh-but-deterministic sampling stream after a restart: the
        # run seed's stream would REPLAY the draws of steps 0.. from the
        # middle of training.
        self.generator.manual_seed(resume_seed(self.seed, step))
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.epoch = int(state["extra"]["epoch"])
        self._start_cursor = int(state["extra"].get("cursor", 0))
        ds_state = state["extra"].get("ds_state")
        if ds_state is not None:
            try:
                self.train_ds.load_state_dict(ds_state)
            except Exception:
                # Safe: run() re-derives order/group_hw via the
                # epoch-seeded deterministic reshuffle(epoch) anyway.
                pass
        if self.is_main:
            print(
                f"Resumed from step {self.step} "
                f"(epoch {self.epoch}, cursor {self._start_cursor})"
            )
        return True

    # -- main loop ---------------------------------------------------------

    def _device_feed(self, loader) -> Iterator:
        """The loader's batches (this rank's rows of them under a mesh) as
        tensors on the model's device. On CUDA each batch is staged in
        pinned memory and copied asynchronously while the step of the batch
        before it runs."""
        if self.device.type != "cuda":
            for batch, meta in loader:
                yield shard_batch(batch, self.mesh, self.device), meta
            return
        staging = Staging()
        cur = None
        for batch, meta in loader:
            nxt = (shard_batch(batch, self.mesh, self.device, staging), meta)
            if cur is not None:
                yield cur
            cur = nxt
        if cur is not None:
            yield cur

    def run(self):
        # A zero-step epoch (batch_size > len(ds) with drop_last) would
        # save every epoch checkpoint under the SAME step id, so resume
        # would lose epoch progress. Fail loudly instead.
        assert len(self.train_ds) >= self.batch_size, (
            f"batch_size {self.batch_size} > dataset {len(self.train_ds)}"
            " — every epoch would run zero steps"
        )
        for epoch in range(self.epoch, self.max_epochs):
            self.epoch = epoch
            self.train_ds.reshuffle(epoch)
            start_batch = getattr(self, "_start_cursor", 0)
            self._start_cursor = 0  # only the resumed epoch skips
            loader = EpisodeLoader(
                self.train_ds, self.batch_size, max_gt=self.max_gt,
                pad_hw=self.pad_hw, start_batch=start_batch,
            )
            cursor = start_batch
            t_epoch = time.monotonic()
            t_last_log = time.monotonic()
            steps_since_log = 0
            for batch, _meta in self._device_feed(loader):
                t0 = time.monotonic()
                metrics = self.train_step(batch, generator=self.generator)
                steps_since_log += 1
                if self.is_main and self.step % self.log_interval == 0:
                    metrics = {k: float(v) for k, v in metrics.items()}
                    # TrainStep: the sync window of THIS step (includes
                    # draining any queued launches — an upper bound).
                    # TrainStepAvg: steady-state wall-clock per step since
                    # the last log.
                    dt_ms = (time.monotonic() - t0) * 1000
                    avg_ms = (
                        (time.monotonic() - t_last_log) * 1000
                        / max(steps_since_log, 1)
                    )
                    t_last_log = time.monotonic()
                    steps_since_log = 0
                    self._scalar("Time/TrainStep", dt_ms)
                    self._scalar("Time/TrainStepAvg", avg_ms)
                    self._log_hyperparams()
                    for k, v in metrics.items():
                        self._scalar(f"Train/{k}", v)
                    self._scalar("Time/HostRSS_GB", _rss_gb())
                    print(
                        f"[{datetime_log_fancy()}] e{epoch} it{self.step} "
                        f"loss={metrics.get('loss_total', float('nan')):.4f} "
                        f"({dt_ms:.0f} ms, rss {_rss_gb():.1f}G)",
                        flush=True,
                    )
                    self._tracemalloc_tick()
                self.step += 1
                cursor += 1
                if self.step % self.part == 0:
                    self.check(epoch=epoch, cursor=cursor)
                elif self._ckpt_every and self.step % self._ckpt_every == 0:
                    # Cheap durability: frequent checkpoint-only saves bound
                    # the work a kill loses to FGN_CKPT_EVERY steps (evals
                    # keep their own cadence).
                    self.save_ckpt(epoch=epoch, cursor=cursor)
            self._scalar("Time/TrainEpoch", (time.monotonic() - t_epoch) * 1000)
            # End of epoch: a resume must CONTINUE at the next epoch.
            self.check(epoch=epoch + 1, cursor=0)
        # Final fresh-support pass: cached-episode epoch curves measure
        # one fixed support draw; the reference re-samples supports per
        # pass, so the reported final numbers come from a fresh draw
        # (tagged `…_fresh`).
        for ev in self.evaluators:
            try:
                metrics = ev.run_fresh()
                for k, v in metrics.items():
                    self._scalar(k + "_fresh", v)
                if self.is_main:
                    print(
                        f"[{datetime_log_fancy()}] final fresh-support eval:",
                        metrics,
                    )
            except Exception:
                print("WARNING: fresh-support eval failed")
                traceback.print_exc()
        self.ckpt.wait()
        if self.tb is not None:
            self.tb.flush()
        return self.model
