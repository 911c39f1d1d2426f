"""Episodic evaluation: detections, result pickles and metrics.

Port of the JAX package's ``train/evaluator.py`` (the reference's
OptEvalHook + FGN.simple_test result plumbing,
subprojects/sp02_omniiseg_fgn_mmdet/main.py:259-345, fgn.py:188-303):

  * the eval step (``make_eval_step``: ``test_forward`` with its outputs
    packed into two tensors) runs on the model's device, producing
    fixed-size detections;
  * full-image masks are pasted on the HOST from the fetched mask logits
    (the logits are ~40× smaller than the pasted masks, and only valid
    detections need pasting); ``_paste_batch`` and ``_paste_batch_packed``
    below paste on the device, for callers that want the masks there;
  * per-episode result dicts (the reference's keys) are flushed to pickle
    chunks of ``chunk_size``;
  * FSISEGEval runs over both bbox and segm, with the reference's metric
    tags ``{ds}_{subset}_FT_{mode}/{metric}_{cats}_{scenario}``.

Device traffic on CUDA: each batch is filled from numpy into pinned host
tensors and sent with ``non_blocking=True``; the two packed outputs come
back the same way, into pinned host tensors behind a CUDA event that
``process`` waits on before it reads them. A pinned buffer read before its
event completes, or refilled while its copy is in flight, gives wrong
numbers silently, so each is one of two and is reused only after the event
of its last copy. On the CPU nothing is pinned: the batch tensors share the
numpy arrays' memory.
"""

from __future__ import annotations

import os
import time
import traceback
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from fgn_torch.data import rle as RLE
from fgn_torch.data.batching import EpisodeBatch, EpisodeLoader, from_numpy
from fgn_torch.data.fsisegeval import FSISEGEval
from fgn_torch.ops.boxes import xyxy_to_yxyx
from fgn_torch.ops.mask_paste import paste_masks, paste_masks_np
from fgn_torch.train.train_step import unpack_eval_out_np
from fgn_torch.utils.io import create_empty_dir_unsafe, read_pkl, write_pkl_unsafe


def _sigmoid_np(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


def _paste_batch(mask_logits: torch.Tensor, boxes: torch.Tensor, H: int,
                 W: int, thr: float) -> torch.Tensor:
    """(B, D, m, m) logits + (B, D, 4) XYXY → (B, D, H, W) bool, on their
    device."""
    B, D = mask_logits.shape[:2]
    probs = torch.sigmoid(
        mask_logits.reshape(B * D, *mask_logits.shape[2:]).to(torch.float32))
    out = paste_masks(probs, boxes.reshape(B * D, 4), H, W, threshold=thr)
    return out.reshape(B, D, H, W)


_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def _paste_batch_packed(mask_logits: torch.Tensor, boxes: torch.Tensor,
                        H: int, W: int, thr: float) -> torch.Tensor:
    """Like _paste_batch but bit-packed along W as ``np.packbits`` packs
    (first pixel in the high bit; W padded to a multiple of 8): 8× less
    device→host traffic. Unpack with np.unpackbits(…, count=W)."""
    out = _paste_batch(mask_logits, boxes, H, W, thr)
    B, D = out.shape[:2]
    bits = F.pad(out.to(torch.uint8), (0, (-W) % 8)).reshape(B, D, H, -1, 8)
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=out.device)
    return (bits * weights).sum(-1, dtype=torch.uint8)


class Staging:
    """Two sets of pinned host buffers for the copies of two batches in
    flight. ``take`` hands them out in turns and waits on the CUDA event of
    a set's last copy before handing it out again."""

    def __init__(self):
        self._slots: List = [None, None]  # (buffers, event) each
        self._turn = 0

    def take(self, like: Sequence[torch.Tensor]):
        """→ (pinned tensors shaped and typed as ``like``, the event to
        record after the copies that use them)."""
        i, self._turn = self._turn, self._turn ^ 1
        slot = self._slots[i]
        if slot is not None:
            slot[1].synchronize()  # its last copy is complete
            bufs = slot[0]
            if len(bufs) == len(like) and all(
                    b.shape == t.shape and b.dtype == t.dtype
                    for b, t in zip(bufs, like)):
                return slot
        bufs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in like]
        self._slots[i] = (bufs, torch.cuda.Event())
        return self._slots[i]


def upload_batch(batch: EpisodeBatch, device: torch.device,
                 staging: Optional[Staging]) -> EpisodeBatch:
    """The numpy batch as tensors on ``device``: on CUDA through the pinned
    buffers of ``staging`` with asynchronous copies; on the CPU (``staging``
    None) tensors that share the numpy arrays' memory."""
    src = from_numpy(**batch._asdict())
    if staging is None:
        return src
    bufs, event = staging.take(src)
    for buf, t in zip(bufs, src):
        buf.copy_(t)
    out = EpisodeBatch(*(b.to(device, non_blocking=True) for b in bufs))
    event.record()
    return out


class Evaluator:
    """Runs ``eval_step`` over every episode of ``ds`` and scores the
    detections. ``eval_step(batch) → outputs`` closes over the model (as
    ``make_eval_step(model)`` does), so ``run`` and ``run_fresh`` evaluate
    the model as it stands and take no parameters, unlike the JAX
    package's ``run(params)``."""

    def __init__(
        self,
        model: torch.nn.Module,
        ds,
        batch_size: int,
        eval_step,
        work_dir: str,
        max_gt: int = 30,
        mask_thr: float = 0.5,
        chunk_size: int = 1000,
        pad_hw=None,
        tag: Optional[str] = None,
        n_plots: int = 5,
        cache_episodes: bool = True,
    ):
        self.model = model
        self.ds = ds
        self.batch_size = batch_size
        self.eval_step = eval_step
        self.work_dir = work_dir
        self.max_gt = max_gt
        self.mask_thr = mask_thr
        self.chunk_size = chunk_size
        self.pad_hw = pad_hw
        self.n_plots = n_plots
        # Collated eval batches are reused across eval passes (episode
        # construction is host work repeated identically). Deviation from
        # the reference (which re-samples supports every pass): supports
        # are FIXED after the first pass, which also removes
        # support-sampling variance from the epoch curves.
        self.cache_episodes = cache_episodes
        self._episode_cache = None
        # gt-mask RLE per cached (meta, sample): the gt encode is pure
        # per-episode host work repeated identically on every cached
        # eval pass. Keyed by id(meta) — only safe while the metas are
        # kept alive by _episode_cache, so guarded by _reuse_gt_rle.
        self._gt_rle: Dict = {}
        self._reuse_gt_rle = False
        # Reference tag scheme (main.py:323-333).
        self.tag = tag or (
            f"{ds.sampling_origin_ds}_{ds.sampling_origin_ds_subset}"
            f"_FT_{ds.finetune}"
        )
        self.cats_suffix = (
            f"{ds.sampling_cats.rstrip('_')}_{ds.sampling_scenario}"
        )
        # The last pass: its batches, and seconds of the loop, the whole
        # pass (wall), fetch (waiting for the device's results), host
        # (paste + RLE), eval (FSISEGEval), and the synchronized step and
        # fetch of batches 1-3.
        self.last_times: Dict[str, float] = {}

    def run_fresh(self) -> Dict[str, float]:
        """One pass with freshly sampled episodes/supports, leaving the
        cache untouched. The reference protocol re-samples supports on
        EVERY eval pass; with ``cache_episodes`` the epoch curves use a
        single fixed draw (a documented speed tradeoff), so the final
        reported number comes from this fresh-draw pass instead."""
        cache, self._episode_cache = self._episode_cache, None
        keep, self.cache_episodes = self.cache_episodes, False
        try:
            return self.run()
        finally:
            self.cache_episodes, self._episode_cache = keep, cache

    def results_dir(self) -> str:
        """Where ``run`` writes its pickle chunks (one dir per evaluator:
        several eval hooks in one run must not clobber each other's chunks
        between metric passes)."""
        return os.path.join(
            self.work_dir, "results_pkl",
            f"{self.tag.replace('/', '_')}_{self.cats_suffix}",
        )

    def run(self) -> Dict[str, float]:
        """One eval pass → {tag: metric} (bbox and segm mAP and mAR)."""
        device = next(self.model.parameters()).device
        cuda = device.type == "cuda"
        in_staging = Staging() if cuda else None
        out_staging = Staging() if cuda else None

        caching = False
        if self._episode_cache is not None:
            loader = self._episode_cache
        else:
            loader = EpisodeLoader(
                self.ds, self.batch_size, max_gt=self.max_gt,
                pad_hw=self.pad_hw, drop_last=False, keep_gt_masks=True,
            )
            # Stream-and-cache: batches accumulate as the loop consumes the
            # loader's prefetch thread, so episode construction overlaps
            # the device work and the waits for its results.
            caching = self.cache_episodes
            if caching:
                accum: List = []
                self._gt_rle = {}
        # First (caching) pass may already populate the gt-RLE cache:
        # the metas it keys on are kept alive by the accumulated cache.
        self._reuse_gt_rle = caching or loader is self._episode_cache
        results_dir = self.results_dir()
        create_empty_dir_unsafe(results_dir)

        results: List[dict] = []
        n_flushed = 0

        def flush():
            nonlocal results, n_flushed
            if results:
                write_pkl_unsafe(
                    os.path.join(results_dir, f"chunk_{n_flushed:05}.pkl"),
                    results,
                )
                n_flushed += 1
                results = []

        t_host = t_fetch = 0.0
        t_wall = time.monotonic()

        def process(pending):
            """Host side of one batch (runs while the device computes the
            NEXT batch). Full-image masks are pasted HERE, on the host, from
            the mask logits: only the few valid detections need pasting."""
            nonlocal t_host, t_fetch
            host, event, batch, meta = pending
            t0 = time.monotonic()
            if event is not None:
                event.synchronize()  # the copies into `host` are complete
            # copies: the pinned buffers are refilled two batches on
            out = unpack_eval_out_np({k: v.numpy().copy() for k, v in host.items()})
            t_fetch += time.monotonic() - t0
            t0 = time.monotonic()
            H, W = batch.qry_img.shape[1:3]
            B = meta.n_real if meta.n_real > 0 else batch.qry_img.shape[0]
            for b in range(B):
                valid = out["dt_valid"][b]
                dt_boxes = out["dt_boxes"][b][valid]
                h, w = batch.img_hw[b]
                probs = _sigmoid_np(
                    out["dt_mask_logits"][b][valid].astype(np.float32)
                )
                # Fused native paste+threshold+RLE at the REAL image
                # size (identical to padded-canvas paste + crop: boxes
                # only ever cover image pixels); the two-step numpy paste
                # where the native library is absent.
                dt_rle = RLE.paste_encode_results(
                    probs, dt_boxes, int(h), int(w), self.mask_thr
                )
                if dt_rle is None:
                    masks_b = paste_masks_np(
                        probs, dt_boxes, int(H), int(W), self.mask_thr
                    )
                    dt_rle = RLE.encode_mask_results(
                        masks_b[:, : int(h), : int(w)]
                    )
                gt_key = (id(meta), b)
                gt_rle = (
                    self._gt_rle.get(gt_key) if self._reuse_gt_rle else None
                )
                if gt_rle is None:
                    gt_rle = RLE.encode_mask_results(meta.qry_isegmaps[b])
                    if self._reuse_gt_rle:
                        self._gt_rle[gt_key] = gt_rle
                res = {
                    "idx": int(meta.idx[b]),
                    "qry_child_idx": int(meta.qry_child_idx[b]),
                    "cats_ids_to_sample_real": meta.cats_ids_to_sample_real[b],
                    "spp_insts_ids": meta.spp_insts_ids[b],
                    "qry_img_shape": np.array([h, w, 3], np.int32),
                    "qry_bboxes": meta.qry_bboxes_yxyx[b],
                    "qry_cat_ids": meta.qry_cat_ids[b],
                    "qry_cat_ids_real": meta.qry_cat_ids_real[b],
                    "qry_isegmaps_rle": gt_rle,
                    "dt_scores": out["dt_scores"][b][valid],
                    "dt_bboxes": xyxy_to_yxyx(dt_boxes),
                    "dt_cat_ids": out["dt_cats"][b][valid],
                    "dt_isegmaps_rle": dt_rle,
                }
                results.append(res)
                if len(results) >= self.chunk_size:
                    flush()
            t_host += time.monotonic() - t0

        # Double-buffered loop: batch i's host work overlaps batch i+1's
        # device work (the step's launches return before the card is done).
        pending = None
        n_batches = 0
        dbg = {"step": 0.0, "fetch": 0.0}
        for batch, meta in loader:
            if caching:
                accum.append((batch, meta))
            sync = 1 <= n_batches <= 3  # skip batch 0 (warm-up)
            t0 = time.monotonic()
            out = self.eval_step(upload_batch(batch, device, in_staging))
            if sync:
                if cuda:
                    torch.cuda.synchronize(device)
                dbg["step"] += time.monotonic() - t0
                t0 = time.monotonic()
            # Start the device→host copies NOW: they run behind this
            # batch's device work, and process() finds the data on the
            # host.
            host, event = self._fetch(out, out_staging)
            if sync:
                if event is not None:
                    event.synchronize()
                dbg["fetch"] += time.monotonic() - t0
            del out
            n_batches += 1
            if pending is not None:
                process(pending)
            pending = (host, event, batch, meta)
        if pending is not None:
            process(pending)
        flush()
        if caching:
            self._episode_cache = accum
        t_loop = time.monotonic() - t_wall

        # Render a few episodes (gt | detections), like the reference's
        # 5-episode replot during evaluate (base_fst.py:1547-1577).
        if self.n_plots:
            try:
                first_chunk = sorted(os.listdir(results_dir))[0]
                sample_results = read_pkl(
                    os.path.join(results_dir, first_chunk)
                )[: self.n_plots]
                vis_dir = os.path.join(self.work_dir, "eval_vis")
                for i, res in enumerate(sample_results):
                    self.ds.visualize_result(res, vis_dir, f"Result {i:03}.png")
            except Exception:  # rendering is best-effort: report, go on
                print(f"eval [{self.tag}]: rendering failed:\n"
                      f"{traceback.format_exc()}", flush=True)

        t0 = time.monotonic()
        metrics: Dict[str, float] = {}
        for iou_type, short in (("bbox", "bbox"), ("segm", "isegm")):
            ev = FSISEGEval(
                results_pkl_dir_fp=results_dir,
                n_ways=self.ds.n_ways,
                iou_type=iou_type,
            )
            out_m = ev.run()
            metrics[f"{self.tag}/{short}_mAP_{self.cats_suffix}"] = out_m["mAP"]
            metrics[f"{self.tag}/{short}_mAR_{self.cats_suffix}"] = out_m["mAR"]
        t_eval = time.monotonic() - t0
        self.last_times = {
            "batches": n_batches, "loop": t_loop, "fetch": t_fetch,
            "host": t_host, "eval": t_eval,
            "wall": time.monotonic() - t_wall,
            "sync_step": dbg["step"], "sync_fetch": dbg["fetch"],
        }
        print(
            f"eval [{self.tag}]: {n_batches} batches in {t_loop:.1f}s "
            f"(device-fetch {t_fetch:.1f}s, host {t_host:.1f}s; "
            f"sync x3: step {dbg['step']:.2f}s fetch {dbg['fetch']:.2f}s), "
            f"FSISEGEval {t_eval:.1f}s", flush=True,
        )
        return metrics

    @staticmethod
    def _fetch(out: Dict[str, torch.Tensor], staging: Optional[Staging]):
        """→ (the outputs on the host, the event to wait on before reading
        them; None on the CPU)."""
        if staging is None:
            return out, None
        keys = list(out)
        bufs, event = staging.take([out[k] for k in keys])
        for buf, k in zip(bufs, keys):
            buf.copy_(out[k], non_blocking=True)
        event.record()
        return dict(zip(keys, bufs)), event
