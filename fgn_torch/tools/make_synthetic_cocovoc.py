"""Synthetic COCO/VOC-format stand-in datasets for the COCO2VOC configs.

The port's counterpart of the JAX package's ``tools/make_synthetic_cocovoc.py``,
with the same function, flags, defaults and output, byte for byte on one
OpenCV build. The real COCO/VOC archives are not needed (no download): this
tool renders glyph-scene datasets in the real on-disk formats the loaders
(``data/coco.py``, ``data/voc.py``) consume:

  * ``data/COCO``: ``{train,val}2017/*.jpg`` + ``annotations/
    instances_{train,val}2017.json`` with the standard 80 COCO categories
    (real names + sparse original ids, so the VOC-overlap novel split in
    ``fst_bindings.COCOFewShot.select_cats`` resolves exactly as on real
    COCO), polygon + compressed-RLE segmentations, a few crowd anns;
  * ``data/VOCdevkit/VOC2012``: ``JPEGImages``, ``Annotations`` XML,
    ``SegmentationObject``/``SegmentationClass`` palette PNGs with
    ignore borders, ``ImageSets/Segmentation/{train,val,trainval}.txt``,
    plus two deliberately inconsistent images that the parser audit
    (voc.py::VOCDSParse.get_excluded) must catch.

Category appearance: each of the 80 categories is a distinct font
character (the 20 VOC-overlap categories share their character across
the COCO and VOC datasets, with disjoint render variants per subset, so
novel-category transfer is semantically meaningful). Scenes reuse the
synth compositor primitives (render/deform/cut glyphs, palette colors,
gray unannotated distractors — data/synth.py).

Geometry: COCO images are all 480x640 landscape (one 800x1072 padded
train canvas); VOC images are mixed 375x500 / 500x375 so the AR-grouped
batching path (episodic.py::_apply_ar_grouping) runs on real mixed-AR
data at the 384x512 / 512x384 canvases.

Host code only: numpy and OpenCV, no device.

Usage:
    python -m fgn_torch.tools.make_synthetic_cocovoc            # default sizes
    python -m fgn_torch.tools.make_synthetic_cocovoc --coco-train 80 ...
"""

from __future__ import annotations

import argparse
import os
import random
from typing import Dict, List, Sequence, Tuple

import cv2
import numpy as np

from fgn_torch.data import rle as RLE
from fgn_torch.data.synth import (
    cut_char_img,
    deform_glyph,
    get_palette_np,
    paste_distractor,
    render_glyph,
)
from fgn_torch.data.voc import (
    VOC_IGNORE_COLOR, VOC_LABEL_COLORS, VOC_LABELS, voc_colormap,
)
from fgn_torch.ops.boxes import box_iou_np
from fgn_torch.utils.io import write_json_unsafe

# The standard 80-category COCO list: real names, real sparse original
# ids (instances_val2017.json "categories"). The 20 VOC-overlap entries
# must match fst_bindings.COCOFewShot.VOC_CAT_NAMES by name and
# voc.VOC_LABEL_TO_COCO_ORIGINAL_ID by id.
COCO_CATEGORIES: Tuple[Tuple[int, str], ...] = (
    (1, "person"), (2, "bicycle"), (3, "car"), (4, "motorcycle"),
    (5, "airplane"), (6, "bus"), (7, "train"), (8, "truck"), (9, "boat"),
    (10, "traffic light"), (11, "fire hydrant"), (13, "stop sign"),
    (14, "parking meter"), (15, "bench"), (16, "bird"), (17, "cat"),
    (18, "dog"), (19, "horse"), (20, "sheep"), (21, "cow"),
    (22, "elephant"), (23, "bear"), (24, "zebra"), (25, "giraffe"),
    (27, "backpack"), (28, "umbrella"), (31, "handbag"), (32, "tie"),
    (33, "suitcase"), (34, "frisbee"), (35, "skis"), (36, "snowboard"),
    (37, "sports ball"), (38, "kite"), (39, "baseball bat"),
    (40, "baseball glove"), (41, "skateboard"), (42, "surfboard"),
    (43, "tennis racket"), (44, "bottle"), (46, "wine glass"),
    (47, "cup"), (48, "fork"), (49, "knife"), (50, "spoon"), (51, "bowl"),
    (52, "banana"), (53, "apple"), (54, "sandwich"), (55, "orange"),
    (56, "broccoli"), (57, "carrot"), (58, "hot dog"), (59, "pizza"),
    (60, "donut"), (61, "cake"), (62, "chair"), (63, "couch"),
    (64, "potted plant"), (65, "bed"), (67, "dining table"),
    (70, "toilet"), (72, "tv"), (73, "laptop"), (74, "mouse"),
    (75, "remote"), (76, "keyboard"), (77, "cell phone"),
    (78, "microwave"), (79, "oven"), (80, "toaster"), (81, "sink"),
    (82, "refrigerator"), (84, "book"), (85, "clock"), (86, "vase"),
    (87, "scissors"), (88, "teddy bear"), (89, "hair drier"),
    (90, "toothbrush"),
)

# VOC label (VOC spelling) -> COCO original id, mirroring
# voc.VOC_LABEL_TO_COCO_ORIGINAL_ID (kept local so a generator bug can't
# silently rewrite the loader's table).
VOC_TO_COCO_ID = {
    "aeroplane": 5, "bicycle": 2, "bird": 16, "boat": 9, "bottle": 44,
    "bus": 6, "car": 3, "cat": 17, "chair": 62, "cow": 21,
    "diningtable": 67, "dog": 18, "horse": 19, "motorbike": 4,
    "person": 1, "pottedplant": 64, "sheep": 20, "sofa": 63, "train": 7,
    "tvmonitor": 72,
}
VOC_COCO_IDS = frozenset(VOC_TO_COCO_ID.values())

# 80 distinct cv2-renderable characters: VOC-overlap categories get
# 'A'..'T' (same glyph identity across COCO and VOC); the 60 base
# categories get the rest.
_CHAR_POOL = (
    "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    "abcdefghijklmnopqrstuvwxyz"
    "0123456789"
    "!#$%&*+/<=>?@[]{}~"
)
assert len(_CHAR_POOL) == 80 and len(set(_CHAR_POOL)) == 80


def char_for_category() -> Dict[int, str]:
    """Deterministic category-id -> character map."""
    voc_sorted = sorted(VOC_COCO_IDS)
    base_sorted = [cid for cid, _ in COCO_CATEGORIES if cid not in VOC_COCO_IDS]
    rest = [c for c in _CHAR_POOL if c not in _CHAR_POOL[:20]]
    out = {cid: _CHAR_POOL[i] for i, cid in enumerate(voc_sorted)}
    out.update({cid: rest[i] for i, cid in enumerate(base_sorted)})
    return out


# Disjoint glyph-render variants per subset (like the reference's
# per-subset source file splits): instances in train/val/VOC never share
# the exact same rendering.
VARIANT_RANGES = {
    "train2017": (0, 10), "val2017": (10, 15),
    "voc_train": (15, 20), "voc_val": (20, 25),
}


def compose_scene(
    h: int,
    w: int,
    cat_ids: Sequence[int],
    char_of: Dict[int, str],
    variants: Tuple[int, int],
    n_min: int = 2,
    n_max: int = 6,
    distractors_max: int = 2,
):
    """Render one glyph scene. Returns (img RGB uint8, instances) where
    instances = [(coco_cat_id, visible_mask uint8 (h, w))]; later pastes
    may occlude earlier ones (IoU-capped at 0.2), masks are the VISIBLE
    pixels, like real overlapping instances."""
    img = np.full((h, w, 3), 255, np.uint8)
    idmap = np.zeros((h, w), np.int32)
    palette = get_palette_np()
    color_order = np.random.permutation(len(palette))
    boxes: List[np.ndarray] = []
    cats: List[int] = []
    n = np.random.randint(n_min, n_max + 1)
    for k in range(n):
        cat = int(cat_ids[np.random.randint(len(cat_ids))])
        variant = np.random.randint(variants[0], variants[1])
        crop = cut_char_img(render_glyph(char_of[cat], variant))
        crop = deform_glyph(crop)
        # two size classes roughly matching the mnist/omni generator's
        # small/large split, scaled for the bigger canvas
        ratio = (
            np.random.uniform(0.9, 1.7)
            if np.random.rand() < 0.5 else np.random.uniform(1.9, 3.2)
        )
        ch, cw = crop.shape[:2]
        crop = cv2.resize(
            crop, (max(int(cw * ratio), 2), max(int(ch * ratio), 2))
        )
        ch, cw = crop.shape[:2]
        if ch >= h or cw >= w:
            continue
        placed = None
        for _ in range(50):
            y0 = np.random.randint(0, h - ch)
            x0 = np.random.randint(0, w - cw)
            box = np.array([y0, x0, y0 + ch, x0 + cw], np.float64)
            if not boxes or box_iou_np(np.asarray(boxes), box[None]).max() < 0.2:
                placed = (y0, x0)
                break
        if placed is None:
            continue
        y0, x0 = placed
        ink = crop < 245
        color = palette[color_order[len(cats) % len(palette)]]
        # glyph intensity modulates toward the palette color
        inv = (255 - crop).astype(np.float32)
        colored = 255.0 - inv[..., None] * (1 - color.astype(np.float32) / 255)
        region = img[y0 : y0 + ch, x0 : x0 + cw]
        region[ink] = colored.astype(np.uint8)[ink]
        idmap[y0 : y0 + ch, x0 : x0 + cw][ink] = len(cats) + 1
        boxes.append(np.array([y0, x0, y0 + ch, x0 + cw], np.float64))
        cats.append(cat)

    instances = []
    for k, cat in enumerate(cats):
        mask = (idmap == k + 1).astype(np.uint8)
        if mask.sum() < 30:  # fully occluded / degenerate
            continue
        instances.append((cat, mask))

    for _ in range(np.random.randint(0, distractors_max + 1)):
        cat = int(cat_ids[np.random.randint(len(cat_ids))])
        variant = np.random.randint(variants[0], variants[1])
        crop = cut_char_img(render_glyph(char_of[cat], variant))
        paste_distractor(img, crop, [b for b in boxes], min(h, w))
    return img, instances


def mask_to_polygons(mask: np.ndarray) -> List[List[float]]:
    cs, _ = cv2.findContours(
        mask, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE
    )
    return [
        c.reshape(-1, 2).astype(np.float64).flatten().tolist()
        for c in cs
        if c.shape[0] >= 3
    ]


def _mask_bbox_xywh(mask: np.ndarray) -> List[float]:
    ys, xs = np.nonzero(mask)
    return [
        float(xs.min()), float(ys.min()),
        float(xs.max() - xs.min() + 1), float(ys.max() - ys.min() + 1),
    ]


# ---------------------------------------------------------------------------
# COCO side
# ---------------------------------------------------------------------------


def make_coco(coco_root: str, n_train: int, n_val: int,
              char_of: Dict[int, str]) -> None:
    os.makedirs(os.path.join(coco_root, "annotations"), exist_ok=True)
    all_ids = [cid for cid, _ in COCO_CATEGORIES]
    for subset, n_imgs in (("train2017", n_train), ("val2017", n_val)):
        img_dir = os.path.join(coco_root, subset)
        os.makedirs(img_dir, exist_ok=True)
        images, annotations = [], []
        ann_id = 1
        made = 0
        while made < n_imgs:
            h, w = 480, 640  # one AR group: one padded canvas
            img, instances = compose_scene(
                h, w, all_ids, char_of, VARIANT_RANGES[subset]
            )
            if len(instances) < 2:
                continue
            made += 1
            img_id = made
            fname = f"{img_id:012d}.jpg"
            cv2.imwrite(os.path.join(img_dir, fname), img[..., ::-1])
            images.append(
                {"id": img_id, "file_name": fname, "height": h, "width": w}
            )
            for j, (cat, mask) in enumerate(instances):
                area = float(mask.sum())
                if j % 3 == 2:
                    # compressed-RLE segmentation branch (ascii counts)
                    r = RLE.encode(mask)
                    seg = {
                        "size": [int(v) for v in r["size"]],
                        "counts": r["counts"].decode("ascii"),
                    }
                else:
                    seg = mask_to_polygons(mask)
                    if not seg:
                        continue
                annotations.append({
                    "id": ann_id, "image_id": img_id, "category_id": cat,
                    "bbox": _mask_bbox_xywh(mask), "area": area,
                    "iscrowd": int(j % 3 == 2 and np.random.rand() < 0.05),
                    "segmentation": seg,
                })
                ann_id += 1
        write_json_unsafe(
            os.path.join(
                coco_root, "annotations", f"instances_{subset}.json"
            ),
            {
                "images": images,
                "annotations": annotations,
                "categories": [
                    {"id": cid, "name": name, "supercategory": "synthetic"}
                    for cid, name in COCO_CATEGORIES
                ],
            },
        )
        print(f"COCO {subset}: {made} images, {ann_id - 1} annotations")


# ---------------------------------------------------------------------------
# VOC side
# ---------------------------------------------------------------------------

_VOC_CMAP_INDEXED = None


def _voc_obj_color(k: int) -> Tuple[int, int, int]:
    """k-th instance color from the VOC palette (1-based)."""
    global _VOC_CMAP_INDEXED
    if _VOC_CMAP_INDEXED is None:
        _VOC_CMAP_INDEXED = voc_colormap()
    return tuple(int(v) for v in _VOC_CMAP_INDEXED[k])


def _write_voc_xml(fp: str, h: int, w: int, objects: List[Dict]) -> None:
    lines = [
        "<annotation>",
        "  <size>",
        f"    <height>{h}</height>",
        f"    <width>{w}</width>",
        "    <depth>3</depth>",
        "  </size>",
    ]
    for o in objects:
        lines += [
            "  <object>",
            f"    <name>{o['name']}</name>",
            f"    <difficult>{o['difficult']}</difficult>",
            "    <bndbox>",
            f"      <ymin>{o['box'][0]}</ymin>",
            f"      <xmin>{o['box'][1]}</xmin>",
            f"      <ymax>{o['box'][2]}</ymax>",
            f"      <xmax>{o['box'][3]}</xmax>",
            "    </bndbox>",
            "  </object>",
        ]
    lines.append("</annotation>")
    with open(fp, "w") as f:
        f.write("\n".join(lines))


def make_voc(voc_root: str, n_train: int, n_val: int,
             char_of: Dict[int, str]) -> None:
    for sub in ("JPEGImages", "Annotations", "SegmentationObject",
                "SegmentationClass", os.path.join("ImageSets", "Segmentation")):
        os.makedirs(os.path.join(voc_root, sub), exist_ok=True)
    ids_by_subset: Dict[str, List[str]] = {"train": [], "val": []}
    serial = 0
    for subset, n_imgs in (("train", n_train), ("val", n_val)):
        variants = VARIANT_RANGES[f"voc_{subset}"]
        made = 0
        # two deliberately inconsistent train images exercise the
        # parser audit (phantom XML box / wrong XML class)
        corrupt_plan = {0: "extra-xml-box", 1: "wrong-class"} if (
            subset == "train"
        ) else {}
        while made < n_imgs:
            h, w = (375, 500) if serial % 2 == 0 else (500, 375)
            img, instances = compose_scene(
                h, w, sorted(VOC_COCO_IDS), char_of, variants,
                n_min=2, n_max=5, distractors_max=1,
            )
            if len(instances) < 2:
                continue
            serial += 1
            img_id = f"2012_{serial:06d}"
            made += 1
            obj_png = np.zeros((h, w, 3), np.uint8)
            cls_png = np.zeros((h, w, 3), np.uint8)
            xml_objects = []
            coco_to_voc = {v: k for k, v in VOC_TO_COCO_ID.items()}
            any_inst = np.zeros((h, w), bool)
            for k, (cat, mask) in enumerate(instances):
                any_inst |= mask.astype(bool)
            for k, (cat, mask) in enumerate(instances):
                m = mask.astype(bool)
                name = coco_to_voc[cat]
                obj_png[m] = _voc_obj_color(k + 1)
                cls_png[m] = VOC_LABEL_COLORS[name]
                # classic VOC ignore border around the instance
                border = cv2.dilate(
                    mask, np.ones((3, 3), np.uint8)
                ).astype(bool) & ~any_inst
                obj_png[border] = VOC_IGNORE_COLOR
                cls_png[border] = VOC_IGNORE_COLOR
                ys, xs = np.nonzero(m)
                xml_objects.append({
                    "name": name,
                    "difficult": int(np.random.rand() < 0.03),
                    "box": [
                        int(ys.min()), int(xs.min()),
                        int(ys.max()) + 1, int(xs.max()) + 1,
                    ],
                })
            kind = corrupt_plan.get(made - 1)
            if kind == "extra-xml-box":
                xml_objects.append({
                    "name": "person", "difficult": 0,
                    "box": [2, 2, 40, 40],
                })
            elif kind == "wrong-class":
                xml_objects[0] = dict(
                    xml_objects[0],
                    name=("cat" if xml_objects[0]["name"] != "cat" else "dog"),
                )
            cv2.imwrite(
                os.path.join(voc_root, "JPEGImages", f"{img_id}.jpg"),
                img[..., ::-1],
            )
            cv2.imwrite(
                os.path.join(
                    voc_root, "SegmentationObject", f"{img_id}.png"
                ),
                obj_png[..., ::-1],
            )
            cv2.imwrite(
                os.path.join(
                    voc_root, "SegmentationClass", f"{img_id}.png"
                ),
                cls_png[..., ::-1],
            )
            _write_voc_xml(
                os.path.join(voc_root, "Annotations", f"{img_id}.xml"),
                h, w, xml_objects,
            )
            ids_by_subset[subset].append(img_id)
        print(f"VOC {subset}: {made} images")
    sets_dir = os.path.join(voc_root, "ImageSets", "Segmentation")
    for name, ids in (
        ("train", ids_by_subset["train"]),
        ("val", ids_by_subset["val"]),
        ("trainval", ids_by_subset["train"] + ids_by_subset["val"]),
    ):
        with open(os.path.join(sets_dir, f"{name}.txt"), "w") as f:
            f.write("\n".join(ids) + "\n")


def make_all(
    coco_root: str = "data/COCO",
    voc_root: str = os.path.join("data", "VOCdevkit", "VOC2012"),
    coco_train: int = 800,
    coco_val: int = 240,
    voc_train: int = 150,
    voc_val: int = 80,
    seed: int = 8,
    cache_roots: Sequence[str] = ("data/coco_cache", "data/voc_cache"),
) -> None:
    np.random.seed(seed)
    random.seed(seed)
    char_of = char_for_category()
    make_coco(coco_root, coco_train, coco_val, char_of)
    make_voc(voc_root, voc_train, voc_val, char_of)
    # VOCDS resolves categories through COCOCats.json in its own cache
    # root; seed it (and the COCO cache) so either dataset can init first.
    cats = {
        str(cid): {"id": cid, "name": name, "supercategory": "synthetic"}
        for cid, name in COCO_CATEGORIES
    }
    for root in cache_roots:
        os.makedirs(root, exist_ok=True)
        write_json_unsafe(os.path.join(root, "COCOCats.json"), cats)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--coco-root", default="data/COCO")
    ap.add_argument(
        "--voc-root", default=os.path.join("data", "VOCdevkit", "VOC2012")
    )
    ap.add_argument("--coco-train", type=int, default=800)
    ap.add_argument("--coco-val", type=int, default=240)
    ap.add_argument("--voc-train", type=int, default=150)
    ap.add_argument("--voc-val", type=int, default=80)
    ap.add_argument("--seed", type=int, default=8)
    args = ap.parse_args()
    make_all(
        coco_root=args.coco_root, voc_root=args.voc_root,
        coco_train=args.coco_train, coco_val=args.coco_val,
        voc_train=args.voc_train, voc_val=args.voc_val, seed=args.seed,
    )
