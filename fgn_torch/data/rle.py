"""COCO-compatible run-length encoding for binary masks.

A copy of the JAX package's ``data/rle.py``: the same on-disk and
in-memory format (``{"size": [h, w], "counts": bytes}`` with the COCO
varint string compression), so the pickles of either package read in the
other. A native C++ path (``fgn_torch/native``, built on first use with
the host compiler) does the encode, decode and the fused paste+encode;
without a compiler the numpy path below does the same work.
``backend()`` says which path is live.

Format: column-major (Fortran) scan; counts alternate runs of 0s then 1s,
always starting with the count of 0s. The compressed string stores each
count as a base-32 varint of (count - count[i-2]) for i > 2 [sic — the
COCO spec applies the delta from index 2 on].
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from fgn_torch import native

RLE = Dict[str, object]


def _native():
    """The native library, or None on a host without a C++ compiler."""
    return native.load()


def backend() -> str:
    """The live path: "native" (the C++ library) or "numpy"."""
    return "native" if _native() is not None else "numpy"


def mask_to_counts(mask: np.ndarray) -> np.ndarray:
    """Binary (h, w) mask → uncompressed counts (uint32, starts with 0-run)."""
    flat = np.asfortranarray(mask).reshape(-1, order="F").astype(np.uint8)
    if flat.size == 0:
        return np.zeros(1, np.uint32)
    change = np.nonzero(np.diff(flat))[0]
    run_ends = np.concatenate([change + 1, [flat.size]])
    run_starts = np.concatenate([[0], change + 1])
    counts = (run_ends - run_starts).astype(np.uint32)
    if flat[0] == 1:  # must start with a zero-run
        counts = np.concatenate([[np.uint32(0)], counts])
    return counts


def counts_to_mask(counts: Sequence[int], h: int, w: int) -> np.ndarray:
    counts = np.asarray(counts, np.int64)
    total = int(counts.sum())
    assert total == h * w, f"RLE covers {total} px, expected {h * w}"
    vals = np.zeros(len(counts), np.uint8)
    vals[1::2] = 1
    flat = np.repeat(vals, counts)
    return flat.reshape((h, w), order="F")


def _compress_counts(counts: Sequence[int]) -> bytes:
    out: List[int] = []
    counts = list(int(c) for c in counts)
    for i, c in enumerate(counts):
        x = c if i <= 2 else c - counts[i - 2]
        more = True
        while more:
            chunk = x & 0x1F
            x >>= 5
            more = not (
                (x == 0 and not (chunk & 0x10)) or (x == -1 and (chunk & 0x10))
            )
            if more:
                chunk |= 0x20
            out.append(chunk + 48)
    return bytes(out)


def _decompress_counts(s: bytes) -> List[int]:
    counts: List[int] = []
    i = 0
    n = len(s)
    while i < n:
        x = 0
        k = 0
        more = True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def encode(mask: np.ndarray) -> RLE:
    """Binary (h, w) mask → compressed RLE dict."""
    h, w = mask.shape
    nat = _native()
    if nat is not None:
        return nat.encode(np.ascontiguousarray(mask, dtype=np.uint8))
    counts = mask_to_counts(mask)
    return {"size": [int(h), int(w)], "counts": _compress_counts(counts)}


def decode(rle: RLE) -> np.ndarray:
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        if isinstance(counts, str):
            counts = counts.encode("ascii")
        nat = _native()
        if nat is not None:
            return nat.decode(counts, int(h), int(w))
        counts = _decompress_counts(counts)
    return counts_to_mask(counts, int(h), int(w))


def area(rle: RLE) -> int:
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        if isinstance(counts, str):
            counts = counts.encode("ascii")
        counts = _decompress_counts(counts)
    return int(np.sum(np.asarray(counts, np.int64)[1::2]))


def to_bbox(rle: RLE) -> np.ndarray:
    """RLE → XYWH bbox (like pycocotools toBbox)."""
    m = decode(rle)
    ys, xs = np.nonzero(m)
    if len(ys) == 0:
        return np.zeros(4, np.float32)
    return np.array(
        [xs.min(), ys.min(), xs.max() - xs.min() + 1, ys.max() - ys.min() + 1],
        np.float32,
    )


def merge(rles: Sequence[RLE], intersect: bool = False) -> RLE:
    masks = [decode(r) for r in rles]
    acc = masks[0].astype(bool)
    for m in masks[1:]:
        acc = (acc & m.astype(bool)) if intersect else (acc | m.astype(bool))
    return encode(acc.astype(np.uint8))


def iou(
    dts: Sequence[RLE], gts: Sequence[RLE], iscrowd: Sequence[int]
) -> np.ndarray:
    """Mask IoU matrix (len(dts), len(gts)).

    For crowd gts the denominator is the dt area (IoF), matching
    pycocotools' COCOeval convention."""
    if len(dts) == 0 or len(gts) == 0:
        return np.zeros((len(dts), len(gts)), np.float64)
    dm = np.stack([decode(d).reshape(-1) for d in dts]).astype(np.float64)
    gm = np.stack([decode(g).reshape(-1) for g in gts]).astype(np.float64)
    inter = dm @ gm.T
    da = dm.sum(axis=1)[:, None]
    ga = gm.sum(axis=1)[None, :]
    crowd = np.asarray(iscrowd, bool)[None, :]
    union = np.where(crowd, da, da + ga - inter)
    return inter / np.maximum(union, 1e-9)


def encode_mask_results(masks: Union[np.ndarray, Sequence[np.ndarray]]) -> List[RLE]:
    """Encode a stack/list of binary masks (mmdet ``encode_mask_results``
    shape: the reference calls it per image on (n, h, w) arrays)."""
    return [encode(np.asarray(m).astype(np.uint8)) for m in masks]


def paste_encode_results(
    probs: np.ndarray, boxes: np.ndarray, img_h: int, img_w: int,
    thr: float = 0.5,
) -> Optional[List[RLE]]:
    """Fused native paste+threshold+encode of per-detection mask probs
    ((n, m, m) float, XYXY boxes) straight to RLE — the full-image
    canvases are never materialized (replaces
    ops/mask_paste.paste_masks_np + encode on the eval hot path).
    Returns None when the native library is unavailable (callers fall
    back to the two-step path)."""
    nat = _native()
    if nat is None:
        return None
    return [
        nat.paste_encode(p, b, int(img_h), int(img_w), thr)
        for p, b in zip(probs, boxes)
    ]
