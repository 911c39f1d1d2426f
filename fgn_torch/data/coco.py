"""COCO instance-segmentation dataset loader (pycocotools-free).

Rebuild of the reference COCO stack (datasets/coco/coco_ds.py +
create_annotation_coco.py):

  * annotation filtering (``filter_coco_anns`` — reference
    ``filter_coco``, create_annotation_coco.py:143-326): 'ignore' and
    degenerate (<1 px side) annotations dropped, CROWD KEPT (:152-154),
    small-annotation counting at min-area-ratio 0.005 (:237-252);
  * category remap: original sparse COCO ids → contiguous 0..79 sorted
    by original id, cached as ``COCOCats.json`` (coco_ds.py:74-103);
  * the compact 5-pkl annotation cache with the reference's exact
    filenames ``{subset}2017_{imgs_sps,rles_counts,bboxes,cat_ids,
    rles_hw_sizes}.pkl`` (>10× smaller than the json, coco_ds.py:110-137);
  * segmentation normalization: polygons are rasterized (cv2), both RLE
    flavors pass through, everything is stored as compressed RLE counts
    + (h, w) (coco_ds.py:246-263 — pycocotools replaced by data/rle.py);
  * boxes YXYX, ImageNet mean/std, target 800 / max 1333 (coco_ds.py:34-41).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import cv2
import numpy as np

from fgn_torch.data import rle as RLE
from fgn_torch.utils.io import (
    check_file_if_exists,
    read_json,
    read_pkl,
    write_json_unsafe,
    write_pkl_unsafe,
)

MIN_AREA_RATIO = 0.005


def polygons_to_rle(polygons: Sequence[Sequence[float]], h: int, w: int) -> Dict:
    """COCO polygon segmentation → compressed RLE (rasterized with cv2,
    replacing pycocotools frPyObjects)."""
    mask = np.zeros((h, w), np.uint8)
    pts = [
        np.round(np.asarray(p, np.float64).reshape(-1, 2)).astype(np.int32)
        for p in polygons
        if len(p) >= 6
    ]
    if pts:
        cv2.fillPoly(mask, pts, 1)
    return RLE.encode(mask)


def segmentation_to_rle(seg, h: int, w: int) -> Dict:
    """Any COCO segmentation flavor → compressed RLE
    (reference get_rle_for_coco_img_inst, coco_ds.py:246-263)."""
    if isinstance(seg, list):
        return polygons_to_rle(seg, h, w)
    counts = seg["counts"]
    if isinstance(counts, list):  # uncompressed RLE
        mask = RLE.counts_to_mask(counts, *seg["size"])
        return RLE.encode(mask)
    if isinstance(counts, str):
        counts = counts.encode("ascii")
    return {"size": list(seg["size"]), "counts": counts}


def filter_coco_anns(
    imgs: Dict[int, Dict],
    anns_by_img: Dict[int, List[Dict]],
    verbose: bool = True,
) -> List[Dict]:
    """Filter annotations per image (reference filter_coco,
    create_annotation_coco.py:143-326). Returns entries
    ``{"image_id", "img", "anns"}`` for images with >= 1 valid ann.

    Crowd annotations are KEPT (:152-154); 'ignore' and degenerate
    (< 1 px side) are dropped; small annotations (< 0.5% of the image)
    are counted for the stats line."""
    out = []
    n_dropped = n_crowd = n_small = 0
    for img_id, img in imgs.items():
        kept = []
        area_img = float(img["height"]) * float(img["width"])
        for ann in anns_by_img.get(img_id, []):
            if ann.get("ignore"):
                n_dropped += 1
                continue
            x, y, w, h = ann["bbox"]
            if w < 1 or h < 1:
                n_dropped += 1
                continue
            if ann.get("iscrowd"):
                n_crowd += 1
            if (w * h) / max(area_img, 1.0) < MIN_AREA_RATIO:
                n_small += 1
            kept.append(ann)
        if kept:
            out.append({"image_id": img_id, "img": img, "anns": kept})
    if verbose:
        print(
            f"filter_coco_anns: {len(out)} images kept, {n_dropped} anns "
            f"dropped, {n_crowd} crowd kept, {n_small} small (<{MIN_AREA_RATIO})"
        )
    return out


class COCODS:
    ds_name = "coco"
    target_size = 800
    max_size = 1333
    imgs_set_possible = ("train", "val")
    # ImageNet stats in 0-255 scale (the reference keeps 0-1 floats and a
    # ToTensor transform; fgn_torch normalizes uint8 on device)
    mean = np.array([123.675, 116.28, 103.53], np.float32)
    std = np.array([58.395, 57.12, 57.375], np.float32)

    def __init__(self, imgs_set: str = "val", root: str = "",
                 coco_root: str = ""):
        assert imgs_set in self.imgs_set_possible
        assert root, "COCODS needs a cache root"
        self.imgs_set = imgs_set
        self.root = root
        self.coco_root = coco_root
        os.makedirs(root, exist_ok=True)
        self.imgs_dir_fp = os.path.join(coco_root, f"{imgs_set}2017")
        self._load_cats()
        self.read_data()
        self._img_cache: Dict[int, np.ndarray] = {}

    # -- categories (reference coco_ds.py:74-103) --------------------------

    def _load_cats(self):
        cats_fp = os.path.join(self.root, "COCOCats.json")
        if check_file_if_exists(cats_fp):
            coco_cats = read_json(cats_fp)
        else:
            ann_fp = self._ann_fp("val") if check_file_if_exists(
                self._ann_fp("val")
            ) else self._ann_fp(self.imgs_set)
            data = read_json(ann_fp)
            coco_cats = {str(c["id"]): c for c in data["categories"]}
            write_json_unsafe(cats_fp, coco_cats)
        cats_sorted = np.sort(np.array([int(k) for k in coco_cats], np.int32))
        self.original_to_new_cats_ids = np.full(
            cats_sorted[-1] + 1, -1, np.int32
        )
        self.new_cats_ids_to_original = cats_sorted
        self.original_to_new_cats_ids[cats_sorted] = np.arange(len(cats_sorted))
        self.cats_names_to_new_cats_ids = {}
        self.new_cats_ids_to_cats_names = {}
        for key, cat in coco_cats.items():
            new_id = int(self.original_to_new_cats_ids[int(key)])
            self.cats_names_to_new_cats_ids[cat["name"]] = new_id
            self.new_cats_ids_to_cats_names[new_id] = cat["name"]

    @property
    def num_cats(self) -> int:
        return len(self.new_cats_ids_to_original)

    def _ann_fp(self, subset: str) -> str:
        return os.path.join(
            self.coco_root, "annotations", f"instances_{subset}2017.json"
        )

    # -- compact cache (reference coco_ds.py:110-244) ----------------------

    _CACHE_SUFFIXES = (
        "_imgs_sps.pkl", "_rles_counts.pkl", "_bboxes.pkl", "_cat_ids.pkl",
        "_rles_hw_sizes.pkl",
    )

    def _cache_fp(self, suffix: str) -> str:
        return os.path.join(self.root, f"{self.imgs_set}2017{suffix}")

    def check_all_files_exist(self) -> bool:
        return all(
            check_file_if_exists(self._cache_fp(s))
            for s in self._CACHE_SUFFIXES
        )

    def read_data(self):
        if self.check_all_files_exist():
            self.imgs_sps = read_pkl(self._cache_fp("_imgs_sps.pkl"))
            self.info_isegmaps_counts = read_pkl(
                self._cache_fp("_rles_counts.pkl")
            )
            self.bboxes = read_pkl(self._cache_fp("_bboxes.pkl"))
            self.cat_ids = read_pkl(self._cache_fp("_cat_ids.pkl"))
            self.info_isegmaps_hw_sizes = read_pkl(
                self._cache_fp("_rles_hw_sizes.pkl")
            )
            return

        print("COCODS: building the compact annotation cache")
        data = read_json(self._ann_fp(self.imgs_set))
        imgs = {img["id"]: img for img in data["images"]}
        anns_by_img: Dict[int, List[Dict]] = {}
        for ann in data["annotations"]:
            anns_by_img.setdefault(ann["image_id"], []).append(ann)
        entries = filter_coco_anns(imgs, anns_by_img)

        self.imgs_sps, self.bboxes, self.cat_ids = [], [], []
        self.info_isegmaps_counts, self.info_isegmaps_hw_sizes = [], []
        for e in entries:
            img = e["img"]
            h, w = int(img["height"]), int(img["width"])
            boxes, cats, counts = [], [], []
            for ann in e["anns"]:
                x, y, bw, bh = ann["bbox"]
                boxes.append([y, x, y + bh, x + bw])  # YXYX
                cats.append(
                    int(self.original_to_new_cats_ids[int(ann["category_id"])])
                )
                r = segmentation_to_rle(ann.get("segmentation", []), h, w)
                counts.append(r["counts"])
            self.imgs_sps.append(img["file_name"])
            self.bboxes.append(np.asarray(boxes, np.float32))
            self.cat_ids.append(np.asarray(cats, np.int64))
            self.info_isegmaps_counts.append(counts)
            self.info_isegmaps_hw_sizes.append(np.array([h, w], np.int32))

        write_pkl_unsafe(self._cache_fp("_imgs_sps.pkl"), self.imgs_sps)
        write_pkl_unsafe(
            self._cache_fp("_rles_counts.pkl"), self.info_isegmaps_counts
        )
        write_pkl_unsafe(self._cache_fp("_bboxes.pkl"), self.bboxes)
        write_pkl_unsafe(self._cache_fp("_cat_ids.pkl"), self.cat_ids)
        write_pkl_unsafe(
            self._cache_fp("_rles_hw_sizes.pkl"), self.info_isegmaps_hw_sizes
        )

    # -- access -------------------------------------------------------------

    def __len__(self):
        return len(self.imgs_sps)

    def img_fp(self, i: int) -> str:
        return os.path.join(self.imgs_dir_fp, self.imgs_sps[i])

    def read_img(self, i: int) -> np.ndarray:
        if i not in self._img_cache:
            if len(self._img_cache) > 64:
                self._img_cache.clear()
            bgr = cv2.imread(self.img_fp(i))
            self._img_cache[i] = np.ascontiguousarray(bgr[..., ::-1])
        return self._img_cache[i]

    def img_hw(self, i: int):
        hw = self.info_isegmaps_hw_sizes[i]
        return (int(hw[0]), int(hw[1]))

    def ann(self, i: int):
        return (
            np.asarray(self.bboxes[i], np.float32).reshape(-1, 4),
            np.asarray(self.cat_ids[i], np.int64),
        )

    def get_isegmap(self, i: int, j: int) -> np.ndarray:
        h, w = self.img_hw(i)
        return RLE.decode(
            {"size": [h, w], "counts": self.info_isegmaps_counts[i][j]}
        )

    def __getitem__(self, i: int):
        img = self.read_img(i)
        bboxes, cat_ids = self.ann(i)
        isegmaps = (
            np.stack([self.get_isegmap(i, j) for j in range(len(bboxes))])
            if len(bboxes) else np.zeros((0, *img.shape[:2]), np.uint8)
        )
        return {
            "img": img, "bboxes": bboxes, "cat_ids": cat_ids,
            "isegmaps": isegmaps,
        }

    def denormalize(self, x: np.ndarray) -> np.ndarray:
        return np.clip(x * self.std + self.mean, 0, 255).astype(np.uint8)
