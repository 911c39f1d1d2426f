"""Fixed-shape episode batches as torch tensors.

``EpisodeBatch`` is the tensor twin of the JAX package's batch
(``data/batching.py`` there): the same fields, the same layout (NHWC
images, XYXY boxes, uint8 or float masks), so one numpy batch feeds both
packages in the parity tests.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class EpisodeBatch(NamedTuple):
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

