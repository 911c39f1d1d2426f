"""The port's mask IoU (``fgn_torch/data/rle.py::iou``, which counts each
detection's pixels at its gts' pixels) against the JAX package's
(``fgn_tpu/data/rle.py::iou``, dense float64 rows multiplied), on the CPU.
Pixel counts are integers, so the two agree exactly. Tolerance: none."""

import numpy as np
import pytest

from fgn_tpu.data import rle as JR
from fgn_torch.data import rle as R


def _masks(rng, n, h, w):
    out = []
    for i in range(n):
        m = np.zeros((h, w), np.uint8)
        if i % 7 != 6:  # every seventh mask empty
            y0, x0 = rng.integers(0, h - 8), rng.integers(0, w - 8)
            y1 = int(rng.integers(y0 + 1, h + 1))
            x1 = int(rng.integers(x0 + 1, w + 1))
            m[y0:y1, x0:x1] = rng.random((y1 - y0, x1 - x0)) < 0.7
        out.append(m)
    return out


@pytest.mark.parametrize("crowd", [[0, 0, 0], [0, 1, 0], [1]],
                         ids=["no-crowd", "one-crowd", "crowd-only"])
@pytest.mark.parametrize("seed", [0, 1])
def test_iou_equals_jax(seed, crowd):
    rng = np.random.default_rng(seed)
    dts = _masks(rng, 40, 120, 160)
    gts = _masks(rng, len(crowd), 120, 160)
    gts[0] = np.maximum(gts[0], dts[0])  # one pair with IoU well above 0
    dts[1] = 1 - dts[1]  # a mask over most of the image, its corners too
    rd, rg = [R.encode(m) for m in dts], [R.encode(m) for m in gts]
    jd, jg = [JR.encode(m) for m in dts], [JR.encode(m) for m in gts]
    got, want = R.iou(rd, rg, crowd), JR.iou(jd, jg, crowd)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    assert (got > 0).any()


def test_iou_size_mismatch_raises():
    a = R.encode(np.ones((4, 6), np.uint8))
    b = R.encode(np.ones((4, 8), np.uint8))
    with pytest.raises(ValueError, match="mismatch"):
        R.iou([a], [b], [0])
