"""Debug visualizers for support/query feature maps and RPN score maps.

A copy of the JAX package's ``models/viz.py``: the reference's FGN debug
dump methods (fgn.py:305-477), channel-mean heatmap grids written as PNGs.
Each helper takes host arrays laid out as the model's NHWC feature maps and
returns the rendered 2-D uint8 canvas (and writes it when a path is given).
"""

from __future__ import annotations

from typing import Optional

import cv2
import numpy as np


def _norm01(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.float32)
    lo, hi = float(x.min()), float(x.max())
    return (x - lo) / (hi - lo + 1e-9)


def _grid(tiles, pad: int = 2) -> np.ndarray:
    """Stack equally-sized 2-D tiles into one row with padding."""
    h = max(t.shape[0] for t in tiles)
    w = max(t.shape[1] for t in tiles)
    canvas = np.zeros((h, (w + pad) * len(tiles) - pad), np.uint8)
    for i, t in enumerate(tiles):
        canvas[: t.shape[0], i * (w + pad): i * (w + pad) + t.shape[1]] = t
    return canvas


def visualize_spp_fmaps(spp_fmaps: np.ndarray, out_fp: Optional[str] = None,
                        scale: int = 16) -> np.ndarray:
    """(N, h, w, C) support feature maps → channel-mean heatmap row."""
    tiles = []
    for i in range(spp_fmaps.shape[0]):
        m = _norm01(spp_fmaps[i].mean(axis=-1))
        m = (m * 255).astype(np.uint8)
        tiles.append(cv2.resize(
            m, (m.shape[1] * scale, m.shape[0] * scale),
            interpolation=cv2.INTER_NEAREST,
        ))
    canvas = _grid(tiles)
    if out_fp:
        cv2.imwrite(out_fp, canvas)
    return canvas


def visualize_qry_fmaps(qry_fmap: np.ndarray, qry_fmap_mod: np.ndarray,
                        out_fp: Optional[str] = None,
                        scale: int = 16) -> np.ndarray:
    """Raw query map (h, w, C) next to its N attention-gated variants
    (N, h, w, C)."""
    tiles = [(_norm01(qry_fmap.mean(axis=-1)) * 255).astype(np.uint8)]
    for i in range(qry_fmap_mod.shape[0]):
        tiles.append(
            (_norm01(qry_fmap_mod[i].mean(axis=-1)) * 255).astype(np.uint8)
        )
    tiles = [
        cv2.resize(t, (t.shape[1] * scale, t.shape[0] * scale),
                   interpolation=cv2.INTER_NEAREST)
        for t in tiles
    ]
    canvas = _grid(tiles)
    if out_fp:
        cv2.imwrite(out_fp, canvas)
    return canvas


def visualize_cls_scores(cls_scores: np.ndarray, out_fp: Optional[str] = None,
                         scale: int = 16) -> np.ndarray:
    """(N, h, w, A) per-way RPN objectness → max-over-anchors heatmaps."""
    tiles = []
    for i in range(cls_scores.shape[0]):
        m = (_norm01(cls_scores[i].max(axis=-1)) * 255).astype(np.uint8)
        tiles.append(cv2.resize(
            m, (m.shape[1] * scale, m.shape[0] * scale),
            interpolation=cv2.INTER_NEAREST,
        ))
    canvas = _grid(tiles)
    if out_fp:
        cv2.imwrite(out_fp, canvas)
    return canvas
