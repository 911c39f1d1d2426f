"""Episode batches made from the seed on the device, and the pool of them
that a run's requests or steps take in turn from pinned host memory.

A batch holds what ``FGN.test_forward`` and ``FGN.train_forward`` read:
query canvases (uint8, NHWC) with their true sizes, N·K support crops
(uint8) with a box and a 0/255 mask each, and, for training, up to
``max_gt`` ground-truth boxes, ways and quarter-resolution masks a query.
Images are smooth noise (a coarse random field upsampled, plus fine noise),
so neighbouring pixels correlate as in photographs. Every size is fixed by
the configuration and the traffic; the seed changes only the contents.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, NamedTuple

import torch
import torch.nn.functional as F


class Batch(NamedTuple):
    """The port's ``EpisodeBatch`` fields, in its order."""

    qry_img: torch.Tensor  # (B, H, W, 3) uint8
    qry_boxes: torch.Tensor  # (B, G, 4) float32 XYXY
    qry_cats: torch.Tensor  # (B, G) int32
    qry_valid: torch.Tensor  # (B, G) bool
    qry_masks: torch.Tensor  # (B, G, H/4, W/4) uint8 0/255
    spp_imgs: torch.Tensor  # (B, N·K, S, S, 3) uint8
    spp_boxes: torch.Tensor  # (B, N·K, 4) float32 XYXY in crop px
    spp_masks: torch.Tensor  # (B, N·K, S, S) uint8 0/255
    img_hw: torch.Tensor  # (B, 2) int32
    norm_mean: torch.Tensor  # (3,) float32
    norm_std: torch.Tensor  # (3,) float32


def mix(*parts) -> int:
    """A 63-bit seed from any parts (the run's seed, a tag, an index)."""
    h = hashlib.blake2b(repr(parts).encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") >> 1


def _images(n: int, h: int, w: int, g: torch.Generator, dev) -> torch.Tensor:
    coarse = torch.rand((n, 3, max(h // 16, 1), max(w // 16, 1)),
                        generator=g, device=dev) * 255.0
    img = F.interpolate(coarse, size=(h, w), mode="bilinear",
                        align_corners=False)
    img = img + (torch.rand((n, 3, h, w), generator=g, device=dev) - 0.5) * 48.0
    return img.clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def _ellipses(boxes: torch.Tensor, h: int, w: int, scale: float) -> torch.Tensor:
    """0/255 uint8 masks (..., h, w) of the ellipse inscribed in each box
    (given in pixels of a canvas ``scale`` times larger)."""
    b = boxes / scale
    ys = torch.arange(h, device=b.device, dtype=torch.float32) + 0.5
    xs = torch.arange(w, device=b.device, dtype=torch.float32) + 0.5
    cx = (b[..., 0] + b[..., 2])[..., None, None] / 2
    cy = (b[..., 1] + b[..., 3])[..., None, None] / 2
    rx = ((b[..., 2] - b[..., 0]) / 2).clamp(min=0.5)[..., None, None]
    ry = ((b[..., 3] - b[..., 1]) / 2).clamp(min=0.5)[..., None, None]
    inside = ((xs[None, :] - cx) / rx) ** 2 + ((ys[:, None] - cy) / ry) ** 2 <= 1.0
    return inside.to(torch.uint8) * 255


def make_batch(cfg: Dict, nb: int, seed: int, index: int, dev,
               with_gt: bool) -> Batch:
    """Batch ``index`` of a run with ``seed``: ``nb`` queries at the
    configuration's geometry, on ``dev``."""
    geo = cfg["geometry"]
    m = cfg["model"]
    H, W, S = geo["H"], geo["W"], geo["S"]
    ih, iw = geo["img_h"], geo["img_w"]
    NK = m["n_ways"] * m["k_shots"]
    g = torch.Generator(device=dev).manual_seed(mix(seed, "batch", index))

    def u(*shape):
        return torch.rand(shape, generator=g, device=dev)

    qry = _images(nb, H, W, g, dev)
    qry[:, ih:] = 0
    qry[:, :, iw:] = 0
    spp = _images(nb * NK, S, S, g, dev).reshape(nb, NK, S, S, 3)
    # support boxes centred in their crops, as episodes crop around the
    # instance, filling 40-80 % of each side
    side = (0.4 + 0.4 * u(nb, NK, 2)) * S
    lo = (S - side) / 2
    spp_boxes = torch.cat([lo, lo + side], dim=-1)
    spp_masks = _ellipses(spp_boxes, S, S, 1.0)
    img_hw = torch.tensor([ih, iw], dtype=torch.int32, device=dev).expand(nb, 2).contiguous()
    if with_gt:
        G = geo["max_gt"]
        short = min(ih, iw)
        wh = (0.1 + 0.3 * u(nb, G, 2)) * short
        ctr = u(nb, G, 2) * torch.tensor([iw, ih], device=dev, dtype=torch.float32)
        x1y1 = (ctr - wh / 2).clamp(min=0)
        x2y2 = torch.minimum(ctr + wh / 2, torch.tensor([iw - 1.0, ih - 1.0], device=dev))
        qry_boxes = torch.cat([x1y1, x2y2], dim=-1)
        n_valid = 1 + (u(nb, 1) * (G // 2)).long()
        qry_valid = torch.arange(G, device=dev)[None] < n_valid
        qry_cats = (u(nb, G) * m["n_ways"]).long().clamp(max=m["n_ways"] - 1).to(torch.int32)
        qry_boxes = torch.where(qry_valid[..., None], qry_boxes, torch.zeros((), device=dev))
        qry_masks = _ellipses(qry_boxes, H // 4, W // 4, 4.0) * qry_valid[..., None, None]
    else:
        qry_boxes = torch.zeros((nb, 1, 4), device=dev)
        qry_cats = torch.zeros((nb, 1), dtype=torch.int32, device=dev)
        qry_valid = torch.zeros((nb, 1), dtype=torch.bool, device=dev)
        qry_masks = torch.zeros((nb, 1, 1, 1), dtype=torch.uint8, device=dev)
    norm = cfg["normalization"]
    return Batch(qry, qry_boxes, qry_cats, qry_valid, qry_masks.to(torch.uint8),
                 spp, spp_boxes, spp_masks, img_hw,
                 torch.tensor(norm["mean"], dtype=torch.float32, device=dev),
                 torch.tensor(norm["std"], dtype=torch.float32, device=dev))


def make_pool(cfg: Dict, nb: int, size: int, seed: int, dev,
              with_gt: bool) -> List[Batch]:
    """``size`` distinct batches made on ``dev`` and held in pinned host
    memory (plain host memory when ``dev`` is the CPU)."""
    pin = torch.device(dev).type == "cuda"
    pool = []
    for i in range(size):
        b = make_batch(cfg, nb, seed, i, dev, with_gt)
        pool.append(Batch(*(t.to("cpu").pin_memory() if pin else t.clone()
                            for t in b)))
    return pool


def upload(batch: Batch, dev) -> Batch:
    return Batch(*(t.to(dev, non_blocking=True) for t in batch))
