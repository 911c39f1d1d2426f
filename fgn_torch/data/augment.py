"""Lightweight cv2-based augmentation pipeline.

Replaces the reference's imgaug sequences
(datasets/mnistiseg/mnistiseg_ds.py:45-58): one random geometric op
(translate ±15 px / scale 0.8–1.2 / rotate ±15° / shear ±5°, edge-padded)
followed by one random photometric op (gaussian noise / impulse noise /
gaussian blur / hue shift ±50).

Semantics kept from ``BaseFewShotISEG.augment_with_imgaug``
(datasets/fewshotiseg/base_fst.py:734-770): boxes ride along as warped
corner AABBs, masks are warped with nearest interpolation, and if any box
lands fully outside the image the whole augmentation is discarded.
"""

from __future__ import annotations

import random
from typing import Optional, Tuple

import cv2
import numpy as np


class Augmenter:
    def __init__(
        self,
        geometric: bool = True,
        photometric: bool = True,
        translate_px: int = 15,
        scale_range: Tuple[float, float] = (0.8, 1.2),
        rotate_deg: float = 15.0,
        shear_deg: float = 5.0,
        hue_shift: int = 50,
    ):
        self.geometric = geometric
        self.photometric = photometric
        self.translate_px = translate_px
        self.scale_range = scale_range
        self.rotate_deg = rotate_deg
        self.shear_deg = shear_deg
        self.hue_shift = hue_shift

    # -- geometric ---------------------------------------------------------

    def _sample_affine(self, h: int, w: int) -> np.ndarray:
        op = random.randrange(4)
        cx, cy = w / 2.0, h / 2.0
        if op == 0:  # translate
            tx = random.uniform(-self.translate_px, self.translate_px)
            ty = random.uniform(-self.translate_px, self.translate_px)
            return np.array([[1, 0, tx], [0, 1, ty]], np.float64)
        if op == 1:  # scale about center
            s = random.uniform(*self.scale_range)
            return np.array(
                [[s, 0, cx * (1 - s)], [0, s, cy * (1 - s)]], np.float64
            )
        if op == 2:  # rotate about center
            a = random.uniform(-self.rotate_deg, self.rotate_deg)
            return cv2.getRotationMatrix2D((cx, cy), a, 1.0)
        # shear about center
        sh = np.tan(np.deg2rad(random.uniform(-self.shear_deg, self.shear_deg)))
        return np.array([[1, sh, -sh * cy], [0, 1, 0]], np.float64)

    @staticmethod
    def _warp_boxes(m: np.ndarray, boxes_yxyx: np.ndarray) -> np.ndarray:
        if len(boxes_yxyx) == 0:
            return boxes_yxyx
        y1, x1, y2, x2 = (boxes_yxyx[:, i] for i in range(4))
        corners = np.stack(
            [
                np.stack([x1, y1], -1),
                np.stack([x2, y1], -1),
                np.stack([x1, y2], -1),
                np.stack([x2, y2], -1),
            ],
            axis=1,
        )  # (n, 4, 2) as (x, y)
        ones = np.ones((*corners.shape[:2], 1))
        warped = np.concatenate([corners, ones], -1) @ m.T  # (n, 4, 2)
        nx1 = warped[..., 0].min(1)
        nx2 = warped[..., 0].max(1)
        ny1 = warped[..., 1].min(1)
        ny2 = warped[..., 1].max(1)
        return np.stack([ny1, nx1, ny2, nx2], -1).astype(np.float32)

    # -- photometric -------------------------------------------------------
    #
    # Episode construction is the host hot loop (SURVEY hard part #5), so
    # the photometric ops avoid per-call RNG and dtype churn: noise comes
    # from a pre-generated bank sliced at a
    # random offset, adds saturate in cv2 (no float round-trip), and the
    # hue shift is a 256-entry LUT on the uint8 H channel.

    _NOISE_BANK: Optional[np.ndarray] = None  # int16 ~N(0, 4), shared
    _UNIF_BANK: Optional[np.ndarray] = None  # uint8 uniform, shared

    @classmethod
    def _banks(cls, need: int = 0):
        # Banks must strictly exceed the request so randrange(size - need)
        # has room; grow (power of two, min 2^21) for large COCO-resized
        # images (e.g. 800x1333x3) instead of raising.
        size = cls._NOISE_BANK.size if cls._NOISE_BANK is not None else 0
        if size <= need + 1:
            size = 1 << 21
            while size <= need + 1:
                size <<= 1
            rng = np.random.default_rng(0)
            cls._NOISE_BANK = np.round(
                rng.standard_normal(size, dtype=np.float32) * 4.0
            ).astype(np.int16)
            cls._UNIF_BANK = rng.integers(0, 256, size, dtype=np.uint8)
        return cls._NOISE_BANK, cls._UNIF_BANK

    def _photometric(self, img: np.ndarray) -> np.ndarray:
        op = random.randrange(4)
        if op == 0:  # additive gaussian noise (bank slice, saturating add)
            noise, _ = self._banks(img.size)
            n = img.size
            off = random.randrange(noise.size - n)
            return cv2.add(
                img, noise[off: off + n].reshape(img.shape), dtype=cv2.CV_8U
            )
        if op == 1:  # impulse noise on ~3% of pixels
            npix = img.shape[0] * img.shape[1]
            _, unif = self._banks(npix + img.size)
            off = random.randrange(unif.size - npix - img.size)
            mask = unif[off: off + npix].reshape(img.shape[:2]) < 8  # ~3%
            out = img.copy()
            out[mask] = unif[off + npix: off + npix + int(mask.sum()) * 3]\
                .reshape(-1, 3)[: int(mask.sum())]
            return out
        if op == 2:  # gaussian blur
            sigma = random.uniform(0.3, 1.5)
            return cv2.GaussianBlur(img, (0, 0), sigma)
        # hue shift via LUT on the uint8 H channel (H in [0, 180))
        shift = random.randint(-self.hue_shift, self.hue_shift)
        hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
        lut = ((np.arange(256) + shift) % 180).astype(np.uint8)
        hsv[..., 0] = cv2.LUT(hsv[..., 0], lut)
        return cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)

    # -- pipeline ----------------------------------------------------------

    @staticmethod
    def _warp_masks(m: np.ndarray, masks: np.ndarray) -> np.ndarray:
        """Warp a (g, mh, mw) mask stack in ONE cv2 call by moving g to
        channels (the per-mask loop was an episode-pipeline hot spot).
        Float masks (downsampled soft targets) warp bilinear; binary
        masks warp nearest and stay boolean."""
        g, mh, mw = masks.shape
        soft = masks.dtype.kind == "f"
        stack = np.ascontiguousarray(
            np.moveaxis(masks if soft else masks.astype(np.uint8), 0, -1)
        )
        warped = cv2.warpAffine(
            stack, m, (mw, mh),
            flags=cv2.INTER_LINEAR if soft else cv2.INTER_NEAREST,
            borderMode=cv2.BORDER_CONSTANT, borderValue=0,
        )
        if warped.ndim == 2:  # g == 1: cv2 drops the channel axis
            warped = warped[..., None]
        out = np.moveaxis(warped, -1, 0)
        return out if soft else out.astype(bool)

    def __call__(
        self,
        img: np.ndarray,
        bboxes_yxyx: np.ndarray,
        isegmaps: Optional[np.ndarray] = None,
        mask_scale: int = 1,
    ):
        """``mask_scale`` > 1 means ``isegmaps`` ride at 1/scale of the
        image resolution (quarter-res training targets); the affine is
        applied in that frame (same linear part, translation /scale)."""
        h, w = img.shape[:2]
        new_img, new_boxes, new_masks = img, bboxes_yxyx, isegmaps

        if self.geometric:
            m = self._sample_affine(h, w)
            warped_img = cv2.warpAffine(
                img, m, (w, h), flags=cv2.INTER_LINEAR,
                borderMode=cv2.BORDER_REPLICATE,
            )
            boxes = self._warp_boxes(m, np.asarray(bboxes_yxyx).reshape(-1, 4))
            # Reject if any box is fully outside (reference behaviour).
            bad = False
            clipped = boxes.copy()
            for i, b in enumerate(boxes):
                if b[2] <= 0 or b[3] <= 0 or b[0] >= h or b[1] >= w:
                    bad = True
                    break
                clipped[i] = [
                    max(b[0], 0), max(b[1], 0), min(b[2], h), min(b[3], w)
                ]
            if not bad:
                new_img = warped_img
                new_boxes = clipped.astype(np.float32)
                if isegmaps is not None and len(isegmaps):
                    mm = m
                    if mask_scale != 1:
                        # M' = S @ A|t @ S^-1: linear part unchanged,
                        # translation scales into the mask frame.
                        mm = m.copy()
                        mm[:, 2] /= mask_scale
                    new_masks = self._warp_masks(mm, np.asarray(isegmaps))

        if self.photometric:
            new_img = self._photometric(np.ascontiguousarray(new_img))

        if new_masks is None:
            new_masks = isegmaps
        return new_img, np.asarray(new_boxes, np.float32).reshape(-1, 4), new_masks


IDENTITY = Augmenter(geometric=False, photometric=False)
