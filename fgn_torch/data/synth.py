"""Synthetic instance-segmentation dataset compositor.

Rebuild of the reference generator (cp_utils/create_img_from_chars.py):
characters are cropped from white-background glyph images, randomly
resized per size-class, pasted onto a white canvas in a unique palette
color with an IoU-overlap limit, and recovered later by color-keying.
Per-image annotations (YXYX boxes, category ids, paste colors) are pickled
next to the images exactly like the reference
(``{subset}_{bboxes,cat_ids,colors}.pkl``).

Differences from the reference:
  * IoU check uses the in-repo NumPy ``box_iou_np`` instead of
    torchvision (SURVEY.md §2.9);
  * source glyphs: the reference composites yymnist digit crops / Omniglot
    Latin letters from downloaded archives; in this zero-egress build the
    default glyph source renders digits/letters with cv2 Hershey fonts
    (several fonts × thickness × italic for intra-class variation) —
    ``glyph_dirs`` can point at real archives when present.
"""

from __future__ import annotations

import os
import random
from itertools import product
from typing import Dict, List, Optional, Sequence

import cv2
import numpy as np

from fgn_torch.ops.boxes import box_iou_np
from fgn_torch.utils.io import create_empty_dir_unsafe, write_pkl_unsafe

_PALETTE_NP: Optional[np.ndarray] = None
_DILATE_ELEMENT = np.ones((3, 3), dtype=np.uint8)


def get_palette_np() -> np.ndarray:
    """26 distinct RGB colors: the {0, .5, 1}³ lattice minus white
    (reference: cp_utils/create_img_from_chars.py:42-54)."""
    global _PALETTE_NP
    if _PALETTE_NP is None:
        arr = np.array(list(product([0.0, 0.5, 1.0], repeat=3)), np.float32)
        arr = arr[:-1]  # drop (1, 1, 1) = white
        _PALETTE_NP = (arr * 255).astype(np.uint8)
    return _PALETTE_NP


def cut_char_img(img: np.ndarray, shift: int = 1) -> np.ndarray:
    """Tight crop of a dark glyph on a white background (+1 px margin)."""
    if img.ndim == 3:
        img = img[..., 0]
    ys = np.where(np.min(img, axis=1) != 255)[0]
    xs = np.where(np.min(img, axis=0) != 255)[0]
    ymin = max(0, ys[0] - shift)
    ymax = min(ys[-1] + shift, img.shape[0])
    xmin = max(0, xs[0] - shift)
    xmax = min(xs[-1] + shift, img.shape[1])
    return img[ymin:ymax, xmin:xmax]


def resize_char_img(img: np.ndarray, min_max_ratios) -> np.ndarray:
    h, w = img.shape[:2]
    ratio = random.uniform(min_max_ratios[0], min_max_ratios[1])
    return cv2.resize(img, (max(int(w * ratio), 2), max(int(h * ratio), 2)))


def paste_colored_char_img(
    img: np.ndarray,
    img_cut_char: np.ndarray,
    bboxes,
    colors,
    iou_max: float = 0.25,
    hw_max: int = 256,
):
    """Paste a grayscale glyph in a fresh palette color at a random spot
    whose box overlaps existing boxes by < iou_max. Returns False when no
    spot is found in 50 attempts, else (img, bboxes, colors)."""
    h_c, w_c = img_cut_char.shape[:2]
    if h_c >= hw_max or w_c >= hw_max:
        return False

    attempts = 0
    while True:
        ymin = np.random.randint(0, hw_max - h_c)
        xmin = np.random.randint(0, hw_max - w_c)
        bbox = np.array([ymin, xmin, ymin + h_c, xmin + w_c])
        if len(bboxes) == 0:
            break
        ious = box_iou_np(np.asarray(bboxes), bbox[None])
        if ious.max() < iou_max:
            break
        attempts += 1
        if attempts == 50:
            return False

    palette = get_palette_np()
    if len(colors) != 0:
        used = {tuple(c) for c in np.asarray(colors).tolist()}
        avail = [i for i in range(len(palette)) if tuple(palette[i]) not in used]
        if not avail:
            return False
        idx = int(np.random.choice(avail))
    else:
        idx = int(np.random.choice(len(palette)))
    color = palette[idx]

    # Colorize: glyph intensity modulates toward the palette color; the
    # near-white background (>= 245) is left transparent.
    inv = (255 - img_cut_char).astype(np.float32)
    colored = 255.0 - np.dstack([inv] * 3) * (1 - color.astype(np.float32) / 255)
    colored = colored.astype(np.uint8)
    yy, xx, _ = np.where(colored < 245)
    region = img[bbox[0] : bbox[2], bbox[1] : bbox[3]]
    region[yy, xx] = colored[yy, xx]

    if len(bboxes) != 0:
        bboxes = np.vstack((bboxes, bbox))
        colors = np.vstack((colors, color))
    else:
        bboxes = np.array([bbox])
        colors = np.array([color])
    return img, bboxes, colors


def get_char_mask_by_color(
    img: np.ndarray, bbox, color, color_int_shift: int = 75
) -> np.ndarray:
    """Recover an instance mask by keying its paste color inside its box,
    then dilating 3×3 (reference: create_img_from_chars.py:136-158)."""
    arr = np.zeros(img.shape[:2], dtype=np.uint8)
    ymin, xmin, ymax, xmax = (int(v) for v in bbox)
    roi = img[ymin:ymax, xmin:xmax]
    color = np.asarray(color, np.float32)
    cmax = np.minimum(color + color_int_shift, 255)
    cmin = np.maximum(color - color_int_shift, 0)
    mask = np.all((roi >= cmin) & (roi <= cmax), axis=-1).astype(np.uint8)
    mask = cv2.dilate(mask, _DILATE_ELEMENT)
    arr[ymin:ymax, xmin:xmax] = mask
    return arr


# ---------------------------------------------------------------------------
# Glyph sources
# ---------------------------------------------------------------------------

_FONTS = [
    cv2.FONT_HERSHEY_SIMPLEX,
    cv2.FONT_HERSHEY_DUPLEX,
    cv2.FONT_HERSHEY_COMPLEX,
    cv2.FONT_HERSHEY_TRIPLEX,
    cv2.FONT_HERSHEY_COMPLEX_SMALL,
    cv2.FONT_HERSHEY_SCRIPT_SIMPLEX,
    cv2.FONT_HERSHEY_SCRIPT_COMPLEX,
]


def render_glyph(char: str, variant: int = 0) -> np.ndarray:
    """Black glyph on a white 64×64-ish canvas, deterministic per variant.

    Seeded with crc32 (NOT the builtin hash(), which is salted per
    process and would make generated datasets irreproducible)."""
    import zlib

    rnd = random.Random(zlib.crc32(f"{char}:{variant}".encode()))
    font = _FONTS[variant % len(_FONTS)]
    italic = cv2.FONT_ITALIC if (variant // len(_FONTS)) % 2 else 0
    thickness = 1 + rnd.randint(0, 2)
    scale = 1.6 + rnd.uniform(-0.3, 0.5)
    canvas = np.full((72, 72), 255, np.uint8)
    cv2.putText(
        canvas, char, (12, 52), font | italic, scale, 0, thickness, cv2.LINE_AA
    )
    return canvas


def deform_glyph(img: np.ndarray, max_rotate: float = 25.0,
                 elastic: float = 0.08) -> np.ndarray:
    """Per-instance glyph deformation: stroke-thickness jitter, rotation,
    and a coarse elastic warp.

    The reference composites real handwriting (yymnist digits / Omniglot
    letters) whose intra-class variation font rendering lacks; without
    this the synthetic benchmark saturates (N3K3 mAP 1.000 in round 1).
    Deformation happens BEFORE pasting so color-keyed mask recovery is
    untouched."""
    original = img
    h, w = img.shape[:2]
    pad = int(0.3 * max(h, w)) + 2
    img = cv2.copyMakeBorder(
        img, pad, pad, pad, pad, cv2.BORDER_CONSTANT, value=255
    )
    k = random.choice([0, 0, 1, 2])
    if k:  # ink is dark: erode thickens, dilate thins
        op = random.choice([cv2.erode, cv2.dilate])
        img = op(img, np.ones((k + 1, k + 1), np.uint8))
    ang = random.uniform(-max_rotate, max_rotate)
    m = cv2.getRotationMatrix2D(
        (img.shape[1] / 2, img.shape[0] / 2), ang, 1.0
    )
    img = cv2.warpAffine(
        img, m, (img.shape[1], img.shape[0]),
        flags=cv2.INTER_LINEAR, borderMode=cv2.BORDER_CONSTANT,
        borderValue=255,
    )
    gh = gw = 4
    amp_x = elastic * img.shape[1]
    amp_y = elastic * img.shape[0]
    dx = cv2.resize(
        np.random.uniform(-amp_x, amp_x, (gh, gw)).astype(np.float32),
        (img.shape[1], img.shape[0]),
    )
    dy = cv2.resize(
        np.random.uniform(-amp_y, amp_y, (gh, gw)).astype(np.float32),
        (img.shape[1], img.shape[0]),
    )
    xs, ys = np.meshgrid(
        np.arange(img.shape[1], dtype=np.float32),
        np.arange(img.shape[0], dtype=np.float32),
    )
    img = cv2.remap(
        img, xs + dx, ys + dy, cv2.INTER_LINEAR,
        borderMode=cv2.BORDER_CONSTANT, borderValue=255,
    )
    if (img < 128).sum() < 4:  # warped the ink away: keep the original
        return original
    return cut_char_img(img)


def paste_distractor(img: np.ndarray, crop: np.ndarray, bboxes,
                     hw_max: int) -> bool:
    """Paste an UNANNOTATED clutter glyph at a spot with ZERO overlap
    with every annotated box (so color-keyed mask recovery, which only
    looks inside annotated boxes, can never pick it up). Gray-toned so
    it reads as background texture. Returns success."""
    h_c, w_c = crop.shape[:2]
    if h_c >= hw_max or w_c >= hw_max:
        return False
    boxes = np.asarray(bboxes, np.float64).reshape(-1, 4)
    for _ in range(30):
        ymin = np.random.randint(0, hw_max - h_c)
        xmin = np.random.randint(0, hw_max - w_c)
        y2, x2 = ymin + h_c, xmin + w_c
        if len(boxes):
            ix = np.minimum(boxes[:, 3], x2) - np.maximum(boxes[:, 1], xmin)
            iy = np.minimum(boxes[:, 2], y2) - np.maximum(boxes[:, 0], ymin)
            if ((ix > 0) & (iy > 0)).any():
                continue
        intensity = np.random.randint(90, 200)
        inv = ((255 - crop).astype(np.float32) / 255.0)[..., None]
        region = img[ymin:y2, xmin:x2].astype(np.float32)
        blended = region * (1 - inv) + intensity * inv
        img[ymin:y2, xmin:x2] = blended.astype(np.uint8)
        return True
    return False


class GlyphBank:
    """Per-subset pools of glyph crops with category ids.

    Mimics the reference's per-subset file lists
    (datasets/mnistiseg/mnistiseg_create.py, omniiseg_create.py): each
    subset gets disjoint glyph variants so train/val/test instances differ.
    """

    def __init__(
        self,
        chars: Sequence[str],
        variants_per_subset: Dict[str, int] | None = None,
    ):
        self.chars = list(chars)
        variants_per_subset = variants_per_subset or {
            "train": 10, "val": 5, "test": 5
        }
        self.pools: Dict[str, List] = {}
        v0 = 0
        for subset, n_var in variants_per_subset.items():
            pool = []
            for ci, ch in enumerate(self.chars):
                for v in range(v0, v0 + n_var):
                    pool.append((ci, render_glyph(ch, v)))
            self.pools[subset] = pool
            v0 += n_var

    def sample(self, subset: str):
        pool = self.pools[subset]
        return pool[np.random.randint(0, len(pool))]


def create_ds(
    glyph_bank: GlyphBank,
    new_subset_quantities: Dict[str, int],
    sizes_max_amount: Dict[str, int],
    sizes_min_max_ratios: Dict[str, Sequence[float]],
    result_imgs_root_fp: str,
    img_new_size: int,
    seed: int = 8,
    deform: bool = False,
    distractors_max: int = 0,
) -> None:
    """Generator loop (reference: create_img_from_chars.py:161-247):
    per image, for each size class paste up to the class quota of glyphs
    with IoU < 0.2; keep images with >= 2 instances; write jpgs +
    per-subset pickles of boxes / cat ids / colors.

    ``deform`` applies per-instance glyph deformation and
    ``distractors_max`` adds unannotated gray clutter glyphs — together
    they substitute for the intra-class variation of the reference's
    real handwriting sources."""
    np.random.seed(seed)
    random.seed(seed)

    for subset, quantity in new_subset_quantities.items():
        counter = 0
        bboxes_all: List[np.ndarray] = []
        cat_ids_all: List[List[int]] = []
        colors_all: List[np.ndarray] = []

        subset_fp = os.path.join(result_imgs_root_fp, subset)
        create_empty_dir_unsafe(subset_fp)
        while counter < quantity:
            img = np.full((img_new_size, img_new_size, 3), 255, np.uint8)
            bboxes_cur: List = []
            cat_ids_cur: List[int] = []
            colors_cur: List = []

            for size in sorted(sizes_max_amount.keys()):
                n = np.random.randint(0, sizes_max_amount[size])
                for _ in range(n):
                    cat_id, glyph = glyph_bank.sample(subset)
                    crop = cut_char_img(glyph)
                    if deform:
                        crop = deform_glyph(crop)
                    crop = resize_char_img(crop, sizes_min_max_ratios[size])
                    result = paste_colored_char_img(
                        img, crop, bboxes_cur, colors_cur,
                        iou_max=0.2, hw_max=img_new_size,
                    )
                    if result:
                        img, bboxes_cur, colors_cur = result
                        cat_ids_cur.append(cat_id)
                if len(bboxes_cur) > 4:
                    break

            if len(bboxes_cur) < 2:
                continue

            for _ in range(np.random.randint(0, distractors_max + 1)
                           if distractors_max else 0):
                cat_id, glyph = glyph_bank.sample(subset)
                crop = cut_char_img(glyph)
                if deform:
                    crop = deform_glyph(crop)
                crop = resize_char_img(
                    crop, sizes_min_max_ratios[sorted(sizes_max_amount)[0]]
                )
                paste_distractor(img, crop, bboxes_cur, img_new_size)

            cv2.imwrite(
                os.path.join(subset_fp, "%06d.jpg" % counter), img[..., ::-1]
            )
            counter += 1
            bboxes_all.append(np.asarray(bboxes_cur))
            cat_ids_all.append(cat_ids_cur)
            colors_all.append(np.asarray(colors_cur))

        write_pkl_unsafe(
            os.path.join(result_imgs_root_fp, f"{subset}_bboxes.pkl"), bboxes_all
        )
        write_pkl_unsafe(
            os.path.join(result_imgs_root_fp, f"{subset}_cat_ids.pkl"), cat_ids_all
        )
        write_pkl_unsafe(
            os.path.join(result_imgs_root_fp, f"{subset}_colors.pkl"), colors_all
        )


def get_new_shape(h, w, target_size: int = 800, max_size: int = 1333) -> np.ndarray:
    """Aspect-preserving resize: shorter side → target_size, longer side
    capped at max_size (reference: create_img_from_chars.py:250-267).
    Returns an int (h, w) pair."""
    old = np.array([h, w])
    new = np.array([h, w])
    idx = int(np.argmax(old))
    ar = old[idx] / old[1 - idx]
    new[1 - idx] = target_size
    new[idx] = int(target_size * ar)
    if new[idx] > max_size:
        new[idx] = max_size
        new[1 - idx] = int(max_size / ar)
    return new
