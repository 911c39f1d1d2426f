"""Fixed-shape episode batches, their collation and the episode loader.

``EpisodeBatch`` is the twin of the JAX package's batch (``data/batching.py``
there): the same fields, the same layout (NHWC images, XYXY boxes, uint8 or
float masks). The model takes it as torch tensors; ``collate_episodes``
builds it on the host as numpy arrays, byte for byte the JAX package's, and
``from_numpy(**batch._asdict())`` turns those into tensors.

``EpisodeMeta`` carries the host-only ragged leftovers the evaluator needs
(original YXYX boxes, real cat ids, full-resolution gt masks, replay ids).
``EpisodeLoader`` iterates a FewShotISEG-like dataset in order, building
episodes on a prefetch thread. Only the area resample of gt masks whose size
is not a multiple of the mask grid needs cv2, and imports it where it runs.
"""

from __future__ import annotations

import queue
import threading
import traceback
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


class EpisodeBatch(NamedTuple):
    """Tensors for the model; numpy arrays as ``collate_episodes`` builds
    them."""

    qry_img: torch.Tensor  # (B, H, W, 3) uint8 (or float, pre-normalized)
    qry_boxes: torch.Tensor  # (B, G, 4) XYXY float32
    qry_cats: torch.Tensor  # (B, G) int32 episode cat ids
    qry_valid: torch.Tensor  # (B, G) bool
    qry_masks: torch.Tensor  # (B, G, H/4, W/4) uint8 (0..255 = soft 0..1)
    spp_imgs: torch.Tensor  # (B, N*K, S, S, 3)
    spp_boxes: torch.Tensor  # (B, N*K, 4) XYXY in crop coords
    spp_masks: torch.Tensor  # (B, N*K, S, S) uint8 (0 or 255)
    img_hw: torch.Tensor  # (B, 2) int32 true (unpadded) image size
    norm_mean: torch.Tensor = torch.zeros(3)
    norm_std: torch.Tensor = torch.ones(3)


def from_numpy(**fields) -> EpisodeBatch:
    """EpisodeBatch from numpy arrays (field names as in EpisodeBatch)."""
    return EpisodeBatch(
        **{k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in fields.items()}
    )


def to_device(batch: EpisodeBatch, device) -> EpisodeBatch:
    return EpisodeBatch(*(t.to(device) for t in batch))


def mask_to_float(m: torch.Tensor) -> torch.Tensor:
    """uint8 masks (0..255, the compact wire format) → float 0..1; float
    masks pass through as float32."""
    f = m.to(torch.float32)
    return f / 255.0 if m.dtype == torch.uint8 else f


def toy_batch(B, H, W, N, K, S, G=8, seed=0) -> EpisodeBatch:
    """The synthetic N-way K-shot episode of the JAX package's
    ``__graft_entry__._toy_batch``, on the CPU: same RandomState draws in
    the same order, so the same seed gives the same arrays."""
    rng = np.random.RandomState(seed)
    qry_boxes = np.zeros((B, G, 4), np.float32)
    qry_cats = np.zeros((B, G), np.int32)
    qry_valid = np.zeros((B, G), bool)
    mh, mw = H // 4, W // 4
    qry_masks = np.zeros((B, G, mh, mw), np.float32)
    for b in range(B):
        for g in range(min(3, G)):
            x1 = rng.randint(0, W // 2)
            y1 = rng.randint(0, H // 2)
            bw = rng.randint(W // 8, W // 3)
            bh = rng.randint(H // 8, H // 3)
            qry_boxes[b, g] = [x1, y1, min(x1 + bw, W - 1), min(y1 + bh, H - 1)]
            qry_cats[b, g] = g % N
            qry_valid[b, g] = True
            bx = (qry_boxes[b, g] / 4).astype(int)
            qry_masks[b, g, bx[1] : bx[3], bx[0] : bx[2]] = 1.0
    spp_masks = np.zeros((B, N * K, S, S), np.float32)
    spp_masks[:, :, S // 4 : -S // 4, S // 4 : -S // 4] = 1.0
    qry_img = rng.randn(B, H, W, 3).astype(np.float32) * 0.1
    spp_imgs = rng.randn(B, N * K, S, S, 3).astype(np.float32) * 0.1
    return from_numpy(
        qry_img=qry_img,
        qry_boxes=qry_boxes,
        qry_cats=qry_cats,
        qry_valid=qry_valid,
        qry_masks=qry_masks,
        spp_imgs=spp_imgs,
        spp_boxes=np.tile(
            np.array([S // 4, S // 4, 3 * S // 4, 3 * S // 4], np.float32),
            (B, N * K, 1),
        ),
        spp_masks=spp_masks,
        img_hw=np.tile(np.array([H, W], np.int32), (B, 1)),
    )


class EpisodeMeta(NamedTuple):
    idx: np.ndarray  # (B,) dataset indices
    qry_child_idx: np.ndarray  # (B,)
    cats_ids_to_sample_real: np.ndarray  # (B, N)
    spp_insts_ids: np.ndarray  # (B, N*K)
    qry_bboxes_yxyx: List[np.ndarray]  # per image (g, 4)
    qry_cat_ids: List[np.ndarray]  # per image (g,) episode ids
    qry_cat_ids_real: List[np.ndarray]
    qry_isegmaps: List[Optional[np.ndarray]]  # per image (g, h, w) or None
    n_real: int  # real (non-repeated) samples in a padded batch


_MASK_DOWNSCALE = 4


def _downsample_mask(masks: np.ndarray, mh: int, mw: int) -> np.ndarray:
    """(g, h, w) binary → (g, mh, mw) float32 via area resampling.

    When (h, w) is an exact (mh, mw) multiple — always true for the
    stride-16-snapped episode sizes — the area resample is a block mean,
    computed over the whole stack in one numpy reduction. Otherwise
    ``cv2.resize(..., INTER_AREA)`` resamples mask by mask, as the JAX
    package does; cv2 is imported there only, so the evaluation path
    imports without it."""
    if len(masks) == 0:
        return np.zeros((0, mh, mw), np.float32)
    g, h, w = masks.shape
    if (h, w) == (mh, mw):  # already downsampled by the episode engine
        return np.asarray(masks, np.float32)
    if h % mh == 0 and w % mw == 0:
        fy, fx = h // mh, w // mw
        return (
            masks.reshape(g, mh, fy, mw, fx)
            .astype(np.float32)
            .mean(axis=(2, 4))
        )
    import cv2

    out = np.empty((g, mh, mw), np.float32)
    for i, m in enumerate(masks):
        out[i] = cv2.resize(
            np.asarray(m, np.float32), (mw, mh), interpolation=cv2.INTER_AREA
        )
    return out


def collate_episodes(
    samples: Sequence[Dict],
    mean,
    std,
    max_gt: int,
    pad_hw: Optional[Tuple[int, int]] = None,
    keep_gt_masks: bool = False,
    n_real: Optional[int] = None,
    pad_to_batch: Optional[int] = None,
) -> Tuple[EpisodeBatch, EpisodeMeta]:
    if pad_to_batch and len(samples) < pad_to_batch:
        if n_real is None:
            n_real = len(samples)
        samples = list(samples)
        while len(samples) < pad_to_batch:
            samples.append(samples[-1])
    B = len(samples)
    hws = np.array([s["qry_img"].shape[:2] for s in samples], np.int32)
    H, W = (pad_hw if pad_hw is not None else hws.max(axis=0))
    # Canvas padded to a multiple of 32 (mmdet Pad(size_divisor=32)
    # equivalent): stride-2 conv chains and avg_down shortcuts disagree
    # on odd intermediate sizes (800x1066 -> 134 vs 133 at /8), and the
    # C4 stride-16 feature map must divide evenly for the anchor grid.
    H = -(-int(H) // 32) * 32
    W = -(-int(W) // 32) * 32
    mh, mw = H // _MASK_DOWNSCALE, W // _MASK_DOWNSCALE

    NK = samples[0]["spp_imgs"].shape[0]
    S = samples[0]["spp_imgs"].shape[1]
    img_dtype = samples[0]["qry_img"].dtype

    qry_img = np.zeros((B, H, W, 3), img_dtype)
    qry_boxes = np.zeros((B, max_gt, 4), np.float32)
    qry_cats = np.zeros((B, max_gt), np.int32)
    qry_valid = np.zeros((B, max_gt), bool)
    # Masks ship uint8 (0..255): 4× less host→device traffic than float32;
    # the model dequantizes on device (mask_to_float).
    qry_masks = np.zeros((B, max_gt, mh, mw), np.uint8)
    spp_imgs = np.zeros((B, NK, S, S, 3), img_dtype)
    spp_boxes = np.zeros((B, NK, 4), np.float32)
    spp_masks = np.zeros((B, NK, S, S), np.uint8)

    meta_boxes, meta_cats, meta_cats_real, meta_masks = [], [], [], []
    idxs, child_idxs, cats_sample, spp_ids = [], [], [], []

    for b, s in enumerate(samples):
        h, w = s["qry_img"].shape[:2]
        qry_img[b, :h, :w] = s["qry_img"]
        boxes = np.asarray(s["qry_bboxes"], np.float32).reshape(-1, 4)
        g = min(len(boxes), max_gt)
        if g:
            # YXYX → XYXY at the model boundary
            qry_boxes[b, :g] = boxes[:g][:, (1, 0, 3, 2)]
            qry_cats[b, :g] = np.asarray(s["qry_cat_ids"])[:g]
            qry_valid[b, :g] = True
            masks = np.asarray(s["qry_isegmaps"])[:g]
            dm = _downsample_mask(masks, h // _MASK_DOWNSCALE, w // _MASK_DOWNSCALE)
            qry_masks[b, :g, : dm.shape[1], : dm.shape[2]] = (
                dm * 255.0 + 0.5
            ).astype(np.uint8)
        spp_imgs[b] = s["spp_imgs"]
        spp_boxes[b] = np.asarray(s["spp_bboxes"], np.float32)[:, (1, 0, 3, 2)]
        spp_masks[b] = (
            np.asarray(s["spp_isegmaps"], np.float32) * 255.0 + 0.5
        ).astype(np.uint8)

        meta_boxes.append(boxes)
        meta_cats.append(np.asarray(s["qry_cat_ids"], np.int64))
        meta_cats_real.append(np.asarray(s["qry_cat_ids_real"], np.int64))
        meta_masks.append(
            np.asarray(s["qry_isegmaps"]) if keep_gt_masks else None
        )
        idxs.append(s.get("idx", b))
        child_idxs.append(s.get("qry_child_idx", -1))
        cats_sample.append(np.asarray(s["cats_ids_to_sample_real"], np.int64))
        spp_ids.append(np.asarray(s["spp_insts_ids"], np.int64))

    batch = EpisodeBatch(
        qry_img=qry_img,
        qry_boxes=qry_boxes,
        qry_cats=qry_cats,
        qry_valid=qry_valid,
        qry_masks=qry_masks,
        spp_imgs=spp_imgs,
        spp_boxes=spp_boxes,
        spp_masks=spp_masks,
        img_hw=hws,
        norm_mean=np.asarray(mean, np.float32),
        norm_std=np.asarray(std, np.float32),
    )
    meta = EpisodeMeta(
        idx=np.asarray(idxs),
        qry_child_idx=np.asarray(child_idxs),
        cats_ids_to_sample_real=np.stack(cats_sample),
        spp_insts_ids=np.stack(spp_ids),
        qry_bboxes_yxyx=meta_boxes,
        qry_cat_ids=meta_cats,
        qry_cat_ids_real=meta_cats_real,
        qry_isegmaps=meta_masks,
        n_real=n_real if n_real is not None else B,
    )
    return batch, meta


class EpisodeLoader:
    """Iterate (EpisodeBatch, EpisodeMeta) over ``ds`` in order, building
    episodes on a prefetch thread so the device never waits on episode
    construction mid-step.

    ``drop_last=False`` pads the final short batch by repeating its last
    sample (static shapes!) and reports the real count in meta.n_real.
    """

    def __init__(
        self,
        ds,
        batch_size: int,
        max_gt: int = 30,
        pad_hw=None,
        drop_last: bool = True,
        keep_gt_masks: bool = False,
        prefetch: int = 4,
        start_batch: int = 0,
    ):
        self.ds = ds
        self.batch_size = batch_size
        self.max_gt = max_gt
        self.pad_hw = pad_hw
        self.drop_last = drop_last
        self.keep_gt_masks = keep_gt_masks
        self.prefetch = prefetch
        # mid-epoch resume: skip the first `start_batch` batches cheaply
        self.start_batch = start_batch

    def __len__(self):
        n = len(self.ds)
        total = (
            n // self.batch_size if self.drop_last
            else (n + self.batch_size - 1) // self.batch_size
        )
        return max(total - self.start_batch, 0)

    def _index_batches(self):
        n = len(self.ds)
        bs = self.batch_size
        stop = (n // bs) * bs if self.drop_last else n
        for start in range(self.start_batch * bs, stop, bs):
            yield list(range(start, min(start + bs, n)))

    def _build(self, indices: List[int]):
        samples = [self.ds[i] for i in indices]
        n_real = len(samples)
        while len(samples) < self.batch_size:
            samples.append(samples[-1])
        return collate_episodes(
            samples, self.ds.mean, self.ds.std, max_gt=self.max_gt,
            pad_hw=self.pad_hw, keep_gt_masks=self.keep_gt_masks,
            n_real=n_real,
        )

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = object()
        err: List[BaseException] = []

        cancel = threading.Event()

        def worker():
            try:
                for indices in self._index_batches():
                    if cancel.is_set():
                        return
                    item = self._build(indices)
                    # bounded put that a cancelled consumer can unblock
                    while not cancel.is_set():
                        try:
                            q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
            except BaseException as e:  # surface in the consumer thread
                err.append(e)
                traceback.print_exc()  # immediate forensics (log/watchdog)
            finally:
                # The sentinel MUST reach the consumer: a put_nowait here
                # can hit a full queue (device step slower than episode
                # construction), silently dropping it — the consumer then
                # blocks in q.get() forever after draining (observed as a
                # production deadlock in a fresh-support eval pass). Use
                # the same bounded-put loop as the item path; the consumer
                # drains the queue on cancel, so this always terminates.
                while not cancel.is_set():
                    try:
                        q.put(stop, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                # Belt-and-braces against any future lost-sentinel bug:
                # if the worker is dead and the queue is drained, there
                # is nothing left to wait for.
                try:
                    item = q.get(timeout=5.0)
                except queue.Empty:
                    if not t.is_alive():
                        break
                    continue
                if item is stop:
                    break
                yield item
        finally:
            # Early generator close (consumer breaks / is GC'd): without
            # this the worker stays blocked in q.put and interpreter
            # teardown can abort with "terminate called without an active
            # exception".
            cancel.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=10)
        if err:
            raise err[0]
