"""MNISTISEG / OMNIISEG — synthetic raw instance-segmentation datasets.

Rebuild of the reference's dataset base class + generators
(datasets/mnistiseg/mnistiseg_ds.py, mnistiseg_create.py,
datasets/omniiseg/*): images of colored glyphs on white 512×512 canvases;
per-image pickles hold YXYX boxes, category ids and paste colors; masks
are recovered on the fly by color keying (mnistiseg_ds.py:114-144).

Conventions kept: boxes YXYX; ``{subset}_{bboxes,cat_ids,colors}.pkl``
next to a ``{subset}/`` image directory; ``target_size/max_size`` drive
the aspect-preserving resize at episode build time (480 for these
datasets, mnistiseg_ds.py:25-26).

``create()`` replaces the separate *_create.py scripts; the glyph source
is the in-repo renderer (data/synth.py — cv2 Hershey fonts, since the
yymnist/Omniglot archives can't be downloaded in a zero-egress build).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import cv2
import numpy as np

from fgn_torch.data import synth
from fgn_torch.utils.io import read_pkl


class MNISTISEG:
    ds_name = "mnistiseg"
    chars = tuple("0123456789")
    img_size = 512
    target_size = 480
    max_size = 480
    # Size classes: up to 2 pastes per class, ratios relative to the
    # ~45 px rendered glyphs (reference uses 4-15× of 28 px crops,
    # mnistiseg_create.py:28-56 — similar final object sizes).
    sizes_max_amount = {"small": 2, "medium": 2, "large": 2}
    sizes_min_max_ratios = {
        "small": [0.8, 1.5], "medium": [1.5, 2.8], "large": [2.8, 4.5]
    }
    variants_per_subset = {"train": 10, "val": 5, "test": 5}
    # Per-instance deformation + unannotated clutter: substitutes for
    # the reference's real-handwriting intra-class variation (round-1
    # fonts-only data saturated at mAP 1.000 — VERDICT item 7).
    deform_glyphs = True
    distractors_max = 3
    # Channel stats measured over the generated val subset with
    # count_mean_std() (white-dominant canvases with colored glyphs).
    mean = np.array([246.35, 246.27, 246.30], np.float32)
    std = np.array([33.90, 34.05, 34.24], np.float32)

    def __init__(self, imgs_set: str = "train", root: str = ""):
        assert root, "MNISTISEG needs an explicit root"
        self.imgs_set = imgs_set
        self.root = root
        self.imgs_dir_fp = os.path.join(root, imgs_set)
        self.imgs_sps: List[str] = sorted(os.listdir(self.imgs_dir_fp))
        self.bboxes = read_pkl(os.path.join(root, f"{imgs_set}_bboxes.pkl"))
        self.cat_ids = read_pkl(os.path.join(root, f"{imgs_set}_cat_ids.pkl"))
        self.colors = read_pkl(os.path.join(root, f"{imgs_set}_colors.pkl"))
        assert len(self.imgs_sps) == len(self.bboxes)
        self._img_cache: Dict[int, np.ndarray] = {}
        # Warm the OS page cache sequentially: episode construction
        # reads parents in random order (support sampling), and a block
        # device reads at random far slower than it streams. One
        # sequential pass makes every later imread decode-bound instead
        # of seek-bound.
        for sp in self.imgs_sps:
            with open(os.path.join(self.imgs_dir_fp, sp), "rb") as fh:
                fh.read()

    # -- creation -------------------------------------------------------------

    @classmethod
    def create(cls, root: str, quantities: Dict[str, int], seed: int = 8):
        bank = synth.GlyphBank(list(cls.chars), cls.variants_per_subset)
        synth.create_ds(
            bank, quantities, cls.sizes_max_amount, cls.sizes_min_max_ratios,
            root, img_new_size=cls.img_size, seed=seed,
            deform=cls.deform_glyphs, distractors_max=cls.distractors_max,
        )
        return root

    # -- access ---------------------------------------------------------------

    @property
    def num_cats(self) -> int:
        return len(self.chars)

    def __len__(self):
        return len(self.imgs_sps)

    def img_fp(self, i: int) -> str:
        return os.path.join(self.imgs_dir_fp, self.imgs_sps[i])

    def read_img(self, i: int) -> np.ndarray:
        """RGB uint8, cached (support building re-reads parent images)."""
        if i not in self._img_cache:
            if len(self._img_cache) > 64:
                self._img_cache.clear()
            bgr = cv2.imread(self.img_fp(i))
            self._img_cache[i] = np.ascontiguousarray(bgr[..., ::-1])
        return self._img_cache[i]

    def img_hw(self, i: int):
        return (self.img_size, self.img_size)

    def ann(self, i: int):
        """(bboxes YXYX float32 (g, 4), cat_ids int64 (g,))."""
        return (
            np.asarray(self.bboxes[i], np.float32).reshape(-1, 4),
            np.asarray(self.cat_ids[i], np.int64),
        )

    def get_isegmap(self, i: int, j: int) -> np.ndarray:
        """(H, W) uint8 mask of instance j of image i (color keying,
        reference mnistiseg_ds.py:108-144)."""
        img = self.read_img(i)
        bbox = np.asarray(self.bboxes[i][j])
        color = np.asarray(self.colors[i][j])
        return synth.get_char_mask_by_color(img, bbox, color)

    def __getitem__(self, i: int):
        img = self.read_img(i)
        bboxes, cat_ids = self.ann(i)
        isegmaps = np.stack(
            [self.get_isegmap(i, j) for j in range(len(bboxes))]
        ) if len(bboxes) else np.zeros((0, *img.shape[:2]), np.uint8)
        return {
            "img": img, "bboxes": bboxes, "cat_ids": cat_ids,
            "isegmaps": isegmaps,
        }

    # -- stats / viz (reference mnistiseg_ds.py:163-241) ----------------------

    def denormalize(self, x: np.ndarray) -> np.ndarray:
        return np.clip(x * self.std + self.mean, 0, 255).astype(np.uint8)

    def count_mean_std(self):
        """Streaming two-moment channel stats over the subset."""
        s = np.zeros(3, np.float64)
        s2 = np.zeros(3, np.float64)
        n = 0
        for i in range(len(self)):
            img = self.read_img(i).astype(np.float64)
            s += img.sum(axis=(0, 1))
            s2 += (img ** 2).sum(axis=(0, 1))
            n += img.shape[0] * img.shape[1]
        mean = s / n
        std = np.sqrt(s2 / n - mean ** 2)
        return mean.astype(np.float32), std.astype(np.float32)

    def visualize(self, out_dir: str, n: int = 5, seed: int = 8):
        os.makedirs(out_dir, exist_ok=True)
        rnd = np.random.RandomState(seed)
        for k, i in enumerate(rnd.choice(len(self), min(n, len(self)), False)):
            item = self[int(i)]
            img = item["img"].copy()
            for b, m in zip(item["bboxes"].astype(int), item["isegmaps"]):
                img[m > 0] = 255 - img[m > 0]
                cv2.rectangle(img, (b[1], b[0]), (b[3], b[2]), (0, 0, 0), 1)
            cv2.imwrite(
                os.path.join(out_dir, f"Image {k:04}.png"), img[..., ::-1]
            )


class OMNIISEG(MNISTISEG):
    """Letters dataset (reference datasets/omniiseg/: Omniglot Latin
    alphabet, 26 categories; novel letters are those of 'SPUTNIK')."""

    ds_name = "omniiseg"
    chars = tuple("ABCDEFGHIJKLMNOPQRSTUVWXYZ")
    mean = np.array([247.53, 247.37, 247.34], np.float32)
    std = np.array([31.31, 32.03, 32.07], np.float32)
