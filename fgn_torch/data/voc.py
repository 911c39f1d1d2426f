"""PASCAL VOC instance-segmentation mining + dataset.

Rebuild of the reference's VOC stack (datasets/voc/voc_ds_parse.py,
voc_ds.py, resources/Colors.py):

  * ``voc_colormap`` — the VOC palette computed algorithmically (bit
    interleave), replacing the vendored chainercv table (Colors.py);
  * ``VOCDSParse`` — mines per-instance masks from SegmentationObject /
    SegmentationClass PNGs, parses XML boxes
    (get_ann_data_entry — voc_ds_parse.py:137-198; get_img_data_entry —
    :200-268), audits annotation consistency (bbox-count mismatch,
    category-set mismatch, IoU-mismatch / low-IoU matching, min-size,
    out-of-bounds — get_excluded, :690-760) and caches exclusions as
    ``EXCLUDED_{SET}.json``; matched results (XML boxes ↔ mask colors by
    IoU argmax) are emitted with RLE masks and VOC→COCO category ids
    (get_result_entry/get_results — :762-887) cached as
    ``PARSED_DATA_{SET}_COCO_NEW.pkl`` (voc_ds.py:41-71);
  * ``VOCDS`` — COCODS-compatible dataset over the parsed data;
    target = max = 512 (voc_ds.py:21-22).
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

import cv2
import numpy as np

from fgn_torch.data import rle as RLE
from fgn_torch.ops.boxes import box_iou_np
from fgn_torch.utils.io import (
    check_file_if_exists,
    read_json,
    read_pkl,
    write_json_unsafe,
    write_pkl_unsafe,
)

VOC_LABELS = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)

# VOC name → original COCO category id (name aliases applied downstream:
# aeroplane→airplane, sofa→couch, tvmonitor→tv, motorbike→motorcycle;
# reference voc_ds_parse.py:869-887).
VOC_LABEL_TO_COCO_ORIGINAL_ID = {
    "aeroplane": 5, "bicycle": 2, "bird": 16, "boat": 9, "bottle": 44,
    "bus": 6, "car": 3, "cat": 17, "chair": 62, "cow": 21,
    "diningtable": 67, "dog": 18, "horse": 19, "motorbike": 4, "person": 1,
    "pottedplant": 64, "sheep": 20, "sofa": 63, "train": 7, "tvmonitor": 72,
}


def voc_colormap(n: int = 256) -> np.ndarray:
    """The VOC palette via bit interleaving (chainercv/VOC devkit
    algorithm). (n, 3) uint8 RGB; index 255 is the 'ignore' border."""
    cmap = np.zeros((n, 3), np.uint8)
    for i in range(n):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        cmap[i] = (r, g, b)
    return cmap


_CMAP = voc_colormap()
VOC_BACKGROUND_COLOR = tuple(int(v) for v in _CMAP[0])
VOC_IGNORE_COLOR = tuple(int(v) for v in _CMAP[255])
VOC_LABEL_COLORS = {
    name: tuple(int(v) for v in _CMAP[i + 1])
    for i, name in enumerate(VOC_LABELS)
}
_COLOR_TO_LABEL = {color: name for name, color in VOC_LABEL_COLORS.items()}

IOU_MATCH_MIN = 0.5


class VOCDSParse:
    def __init__(self, imgs_set: str, voc_root: str, root: str):
        self.imgs_set = imgs_set
        self.voc_root = voc_root
        self.root = root
        os.makedirs(root, exist_ok=True)
        list_fp = os.path.join(
            voc_root, "ImageSets", "Segmentation", f"{imgs_set}.txt"
        )
        with open(list_fp) as f:
            self.ids = [line.strip() for line in f if line.strip()]

    # -- raw entry readers ----------------------------------------------------

    def _read_png_rgb(self, subdir: str, img_id: str) -> np.ndarray:
        fp = os.path.join(self.voc_root, subdir, f"{img_id}.png")
        return np.ascontiguousarray(cv2.imread(fp)[..., ::-1])

    def get_ann_data_entry(self, i: int):
        """XML boxes (reference voc_ds_parse.py:137-198) →
        (bboxes YXYX (g,4), codes (g,), names (g,), difficult (g,),
        size (2,))."""
        img_id = self.ids[i]
        tree = ET.parse(
            os.path.join(self.voc_root, "Annotations", f"{img_id}.xml")
        )
        size = tree.find("size")
        hw = np.array(
            [int(size.find("height").text), int(size.find("width").text)],
            np.int64,
        )
        boxes, codes, names, difficult = [], [], [], []
        for obj in tree.findall("object"):
            name = obj.find("name").text
            bb = obj.find("bndbox")
            boxes.append([
                float(bb.find("ymin").text), float(bb.find("xmin").text),
                float(bb.find("ymax").text), float(bb.find("xmax").text),
            ])
            names.append(name)
            codes.append(VOC_LABELS.index(name) if name in VOC_LABELS else -1)
            d = obj.find("difficult")
            difficult.append(int(d.text) if d is not None else 0)
        return (
            np.asarray(boxes, np.float64).reshape(-1, 4),
            np.asarray(codes, np.int64),
            np.asarray(names, dtype=object),
            np.asarray(difficult, np.int64),
            hw,
        )

    @staticmethod
    def _unique_colors(px: np.ndarray, return_counts: bool = False):
        """``np.unique(px.reshape(-1, 3), axis=0)`` (and its counts): the
        same rows in the same order, from one sort of 24-bit keys instead of
        a sort of byte rows, which took most of the time of a VOC parse."""
        flat = px.reshape(-1, 3).astype(np.uint32)
        keys = (flat[:, 0] << 16) | (flat[:, 1] << 8) | flat[:, 2]
        out = np.unique(keys, return_counts=return_counts)
        u = out[0] if return_counts else out
        rows = np.stack([u >> 16, (u >> 8) & 255, u & 255], -1).astype(np.uint8)
        return (rows, out[1]) if return_counts else rows

    def get_img_data_entry(self, i: int, size=None):
        """Mine instances from the palette PNGs (reference :200-268) →
        (bboxes YXYX, codes, names, colors). The ignore border and
        background are never instances."""
        img_id = self.ids[i]
        obj = self._read_png_rgb("SegmentationObject", img_id)
        cls = self._read_png_rgb("SegmentationClass", img_id)
        colors = self._unique_colors(obj)
        boxes, codes, names, inst_colors = [], [], [], []
        for color in colors:
            t = tuple(int(v) for v in color)
            if t in (VOC_BACKGROUND_COLOR, VOC_IGNORE_COLOR):
                continue
            mask = np.all(obj == color, axis=-1)
            ys, xs = np.nonzero(mask)
            if len(ys) == 0:
                continue
            boxes.append(
                [ys.min(), xs.min(), ys.max() + 1, xs.max() + 1]
            )
            # class = majority class-PNG color under the instance mask
            cvals, counts = self._unique_colors(cls[mask], return_counts=True)
            order = np.argsort(-counts)
            name = None
            for j in order:
                cand = tuple(int(v) for v in cvals[j])
                if cand in _COLOR_TO_LABEL:
                    name = _COLOR_TO_LABEL[cand]
                    break
            names.append(name if name is not None else "?")
            codes.append(VOC_LABELS.index(name) if name in VOC_LABELS else -1)
            inst_colors.append(t)
        return (
            np.asarray(boxes, np.float64).reshape(-1, 4),
            np.asarray(codes, np.int64),
            np.asarray(names, dtype=object),
            inst_colors,
        )

    def get_isegmap_by_color(self, i: int, color) -> np.ndarray:
        obj = self._read_png_rgb("SegmentationObject", self.ids[i])
        return np.all(obj == np.asarray(color, np.uint8), axis=-1).astype(
            np.uint8
        )

    # -- audits (reference get_excluded, :690-760) -----------------------------

    def _excluded_fp(self) -> str:
        return os.path.join(self.root, f"EXCLUDED_{self.imgs_set.upper()}.json")

    def audit_one(self, i: int) -> Optional[str]:
        """Exclusion reason for image i, or None if consistent."""
        ann_boxes, _, ann_names, difficult, size = self.get_ann_data_entry(i)
        img_boxes, _, img_names, colors = self.get_img_data_entry(i, size)

        if len(ann_boxes) != len(img_boxes):
            return "bbox-count mismatch"
        if sorted(map(str, ann_names)) != sorted(map(str, img_names)):
            return "category-set mismatch"
        if len(img_boxes) == 0:
            return "no instances"
        # out-of-bounds XML boxes
        if (
            (ann_boxes[:, 0] < 0).any() or (ann_boxes[:, 1] < 0).any()
            or (ann_boxes[:, 2] > size[0] + 1).any()
            or (ann_boxes[:, 3] > size[1] + 1).any()
        ):
            return "out-of-bounds bbox"
        # IoU matching: each mask instance claims its best XML box —
        # assignments must be unique, above threshold, and class-consistent
        ious = box_iou_np(img_boxes, ann_boxes)
        best = ious.argmax(axis=1)
        if len(set(best.tolist())) != len(best):
            return "IoU-ambiguous match"
        for m, a in enumerate(best):
            if ious[m, a] < IOU_MATCH_MIN:
                return "low IoU"
            if str(img_names[m]) != str(ann_names[a]):
                return "matched-category mismatch"
        # degenerate / tiny instances
        hs = img_boxes[:, 2] - img_boxes[:, 0]
        ws = img_boxes[:, 3] - img_boxes[:, 1]
        if (hs < 2).any() or (ws < 2).any():
            return "min-size"
        return None

    def get_excluded(self) -> List[str]:
        fp = self._excluded_fp()
        if check_file_if_exists(fp):
            return list(read_json(fp))
        excluded = []
        reasons: Dict[str, str] = {}
        for i, img_id in enumerate(self.ids):
            reason = self.audit_one(i)
            if reason is not None:
                excluded.append(img_id)
                reasons[img_id] = reason
        write_json_unsafe(fp, excluded)
        write_json_unsafe(
            os.path.join(
                self.root, f"EXCLUDED_{self.imgs_set.upper()}_REASONS.json"
            ),
            reasons,
        )
        return excluded

    def count_stats(self) -> Dict:
        """Dataset-QA statistics the reference computes alongside the
        audits (voc_ds_parse.py:690-760): difficult-annotation counts
        and out-of-bounds XML coordinate counts. Cached as
        ``STATS_{SET}.json``."""
        fp = os.path.join(self.root, f"STATS_{self.imgs_set.upper()}.json")
        if check_file_if_exists(fp):
            return read_json(fp)
        stats = {
            "n_images": len(self.ids), "total_anns": 0,
            "difficult_anns": 0, "oob_boxes": 0,
            "difficult_by_label": {}, "max_oob_px": 0.0,
        }
        for i in range(len(self.ids)):
            boxes, _, names, difficult, size = self.get_ann_data_entry(i)
            stats["total_anns"] += len(boxes)
            stats["difficult_anns"] += int(difficult.sum())
            for name, d in zip(names, difficult):
                if d:
                    key = str(name)
                    stats["difficult_by_label"][key] = (
                        stats["difficult_by_label"].get(key, 0) + 1
                    )
            if len(boxes):
                over = np.concatenate([
                    np.maximum(-boxes[:, :2], 0).reshape(-1),
                    np.maximum(boxes[:, 2] - size[0], 0),
                    np.maximum(boxes[:, 3] - size[1], 0),
                ])
                stats["oob_boxes"] += int(
                    ((boxes[:, 0] < 0) | (boxes[:, 1] < 0)
                     | (boxes[:, 2] > size[0] + 1)
                     | (boxes[:, 3] > size[1] + 1)).sum()
                )
                stats["max_oob_px"] = max(
                    stats["max_oob_px"], float(over.max())
                )
        write_json_unsafe(fp, stats)
        return stats

    def dump_evidence(self, out_dir: str) -> int:
        """Render excluded images (XML boxes over the image | instance
        PNG) — the reference commits these audit artifacts
        (datasets/voc/resources/'IOU Mismatch/' etc.). Returns the
        number of renders written."""
        os.makedirs(out_dir, exist_ok=True)
        reasons_fp = os.path.join(
            self.root, f"EXCLUDED_{self.imgs_set.upper()}_REASONS.json"
        )
        self.get_excluded()
        reasons = read_json(reasons_fp) if check_file_if_exists(
            reasons_fp
        ) else {}
        n = 0
        for i, img_id in enumerate(self.ids):
            if img_id not in reasons:
                continue
            jpg = cv2.imread(
                os.path.join(self.voc_root, "JPEGImages", f"{img_id}.jpg")
            )
            if jpg is None:
                continue
            ann_boxes, _, ann_names, _, _ = self.get_ann_data_entry(i)
            for b, name in zip(ann_boxes.astype(int), ann_names):
                cv2.rectangle(jpg, (b[1], b[0]), (b[3], b[2]), (0, 0, 255), 2)
                cv2.putText(jpg, str(name), (b[1], max(b[0] - 3, 10)),
                            cv2.FONT_HERSHEY_PLAIN, 1.0, (0, 0, 255), 1)
            obj = self._read_png_rgb("SegmentationObject", img_id)[..., ::-1]
            canvas = np.concatenate(
                [jpg, np.ascontiguousarray(obj)], axis=1
            )
            reason = reasons[img_id].replace("/", "-")
            cv2.imwrite(
                os.path.join(out_dir, f"{reason} {img_id}.png"), canvas
            )
            n += 1
        return n

    # -- results (reference get_result_entry/get_results, :762-887) ------------

    def get_results(self) -> List[Dict]:
        excluded = set(self.get_excluded())
        out = []
        for i, img_id in enumerate(self.ids):
            if img_id in excluded:
                continue
            ann_boxes, _, ann_names, difficult, size = self.get_ann_data_entry(i)
            img_boxes, _, img_names, colors = self.get_img_data_entry(i, size)
            ious = box_iou_np(img_boxes, ann_boxes)
            best = ious.argmax(axis=1)
            boxes, cats, rles = [], [], []
            for m, a in enumerate(best):
                name = str(img_names[m])
                boxes.append(img_boxes[m])
                cats.append(VOC_LABEL_TO_COCO_ORIGINAL_ID[name])
                rles.append(
                    RLE.encode(self.get_isegmap_by_color(i, colors[m]))
                )
            out.append({
                "img_sp": f"{img_id}.jpg",
                "hw": [int(size[0]), int(size[1])],
                "bboxes": np.asarray(boxes, np.float32).reshape(-1, 4),
                "coco_cat_ids": np.asarray(cats, np.int64),
                "rles": rles,
            })
        return out


class VOCDS:
    """COCODS-compatible dataset over the parsed VOC instance data;
    categories land in the COCO contiguous id space via COCOCats.json
    (reference voc_ds.py:41-71)."""

    ds_name = "voc"
    target_size = 512
    max_size = 512
    mean = np.array([123.675, 116.28, 103.53], np.float32)
    std = np.array([58.395, 57.12, 57.375], np.float32)

    # COCO-side names for the aliased VOC categories
    ALIASES = {
        "aeroplane": "airplane", "sofa": "couch", "tvmonitor": "tv",
        "motorbike": "motorcycle", "diningtable": "dining table",
        "pottedplant": "potted plant",
    }

    def __init__(self, imgs_set: str = "trainval", root: str = "",
                 voc_root: str = "", coco_root: str = ""):
        assert root, "VOCDS needs a cache root"
        self.imgs_set = imgs_set
        self.root = root
        self.voc_root = voc_root
        self.imgs_dir_fp = os.path.join(voc_root, "JPEGImages")
        self._load_cats()

        parsed_fp = os.path.join(
            root, f"PARSED_DATA_{imgs_set.upper()}_COCO_NEW.pkl"
        )
        if check_file_if_exists(parsed_fp):
            records = read_pkl(parsed_fp)
        else:
            parser = VOCDSParse(imgs_set, voc_root=voc_root, root=root)
            records = parser.get_results()
            write_pkl_unsafe(parsed_fp, records)
        self.records = records
        self.imgs_sps = [r["img_sp"] for r in records]
        self.bboxes = [r["bboxes"] for r in records]
        self.cat_ids = [
            self.original_to_new_cats_ids[r["coco_cat_ids"]]
            for r in records
        ]
        self._img_cache: Dict[int, np.ndarray] = {}

    def _load_cats(self):
        cats_fp = os.path.join(self.root, "COCOCats.json")
        coco_cats = read_json(cats_fp)
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

    def __len__(self):
        return len(self.records)

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
        return tuple(self.records[i]["hw"])

    def ann(self, i: int):
        return (
            np.asarray(self.bboxes[i], np.float32).reshape(-1, 4),
            np.asarray(self.cat_ids[i], np.int64),
        )

    def get_isegmap(self, i: int, j: int) -> np.ndarray:
        return RLE.decode(self.records[i]["rles"][j])

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
