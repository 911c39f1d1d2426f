"""Dataset bindings: FewShotISEG engine × raw datasets.

Rebuild of the reference's per-dataset subclasses
(datasets/fewshotiseg/{mnistiseg,omniiseg,coco,voc}_fst.py): each binds
the inner raw dataset class, support crop size, and the novel-category
split; ``init_ds_class_by_config`` is the name→class dispatch the runtime
uses (reference main.py:347-361).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from fgn_torch.data.episodic import FewShotISEG
from fgn_torch.data.mnistiseg import MNISTISEG, OMNIISEG


class MNISTFewShotISEG(FewShotISEG):
    """MNISTISEG binding (reference mnistiseg_fst.py): novel digits
    {1, 3, 5, 7} (:56-71), support crops 128 px (:16)."""

    inner_ds_cl = MNISTISEG
    spp_img_size = 128

    def select_cats(self):
        return np.array([1, 3, 5, 7], np.int64)


class OMNIFewShotISEG(MNISTFewShotISEG):
    """OMNIISEG binding (reference omniiseg_fst.py): novel = the letters
    of 'SPUTNIK' (:21-24)."""

    inner_ds_cl = OMNIISEG

    def select_cats(self):
        letters = sorted(set("SPUTNIK"))
        return np.array([ord(ch) - ord("A") for ch in letters], np.int64)


class COCOFewShot(FewShotISEG):
    """COCO binding (reference coco_fst.py): novel = the 20 VOC-
    overlapping categories, matched by name with the VOC→COCO aliases
    (:22-54); support crops 256 px (:15)."""

    spp_img_size = 256
    coco_root = ""

    # VOC category names on the COCO side (aliases already applied:
    # aeroplane→airplane, sofa→couch, tvmonitor→tv, motorbike→motorcycle).
    VOC_CAT_NAMES = (
        "airplane", "bicycle", "bird", "boat", "bottle", "bus", "car",
        "cat", "chair", "cow", "dining table", "dog", "horse",
        "motorcycle", "person", "potted plant", "sheep", "couch",
        "train", "tv",
    )

    def make_inner_ds(self, ds_name: str, subset: str):
        from fgn_torch.data.coco import COCODS

        return COCODS(
            imgs_set=subset,
            root=self.inner_root or os.path.join("data", "coco_cache"),
            coco_root=self.coco_root or os.path.join("data", "COCO"),
        )

    def select_cats(self):
        name_to_id = self.inner_ds.cats_names_to_new_cats_ids
        ids = []
        for name in self.VOC_CAT_NAMES:
            if name in name_to_id:
                ids.append(name_to_id[name])
        return np.asarray(sorted(ids), np.int64)


class VOCFewShot(COCOFewShot):
    """VOC binding (reference voc_fst.py). VOC categories land in the
    COCO contiguous id space (VOCDS does the remap), so every VOC
    category is 'novel' in the COCO2VOC setup. Augmentations are
    disabled in FT=Use (reference voc_fst.py:18-24)."""

    voc_root = ""

    def __init__(self, config: Dict):
        config = dict(config)
        if config.get("finetune") == "Use":
            config["augment_qry"] = False
            config["augment_spp"] = False
        super().__init__(config)

    def make_inner_ds(self, ds_name: str, subset: str):
        from fgn_torch.data.voc import VOCDS

        return VOCDS(
            imgs_set=subset,
            root=self.inner_root or os.path.join("data", "voc_cache"),
            voc_root=self.voc_root or os.path.join(
                "data", "VOCdevkit", "VOC2012"
            ),
            coco_root=self.coco_root or os.path.join("data", "COCO"),
        )


_DS_CLASSES = {
    "MNISTISEG": MNISTFewShotISEG,
    "OMNIISEG": OMNIFewShotISEG,
    "COCO": COCOFewShot,
    "VOC": VOCFewShot,
}


def init_ds_class_by_config(cfg: Dict) -> FewShotISEG:
    """Name→class dispatch on ``sampling_origin_ds``
    (reference main.py:347-361)."""
    cfg = dict(cfg)
    name = cfg["sampling_origin_ds"]
    cls = _DS_CLASSES[name]
    return cls(cfg)
