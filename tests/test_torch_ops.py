"""fgn_torch ops against the JAX package on CPU: box coder, anchors, gather
RoIAlign, padded NMS, and the synthetic episode batch.

Inputs are made with numpy from a seed and go through both functions.
Tolerances: box ops, anchors and deltas ≤ 1e-6 (relative where the values
are image coordinates: one f32 rounding of exp/log may differ); gather
RoIAlign ≤ 1e-5 (f32, four corner products summed in the same order);
NMS exact (discrete keep decisions on identical f32 IoUs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgn_tpu.ops import anchors as j_anchors
from fgn_tpu.ops import boxes as j_boxes
from fgn_tpu.ops import nms as j_nms
from fgn_tpu.ops.roi_align import roi_align as j_roi_align
from fgn_torch.data import batching as t_batching
from fgn_torch.ops import anchors as t_anchors
from fgn_torch.ops import boxes as t_boxes
from fgn_torch.ops import nms as t_nms
from fgn_torch.ops import roi_align as t_roi

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(x)


def _random_boxes(rng, shape, lo=0.0, hi=100.0):
    ctr = rng.uniform(lo, hi, shape + (2,))
    wh = rng.uniform(5, 40, shape + (2,))
    return np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)


def test_box_area_and_iou():
    rng = np.random.default_rng(0)
    a = _random_boxes(rng, (2, 17))
    b = _random_boxes(rng, (2, 9))
    a[0, 3, 2:] = a[0, 3, :2] - 1.0  # degenerate: negative extent
    np.testing.assert_allclose(
        t_boxes.box_area(_t(a)).numpy(), _np(j_boxes.box_area(a)), atol=1e-6,
        rtol=1e-6,
    )
    got = t_boxes.box_iou(_t(a), _t(b)).numpy()
    ref = _np(j_boxes.box_iou(jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == ref.shape == (2, 17, 9)
    np.testing.assert_allclose(got, ref, atol=1e-6)


@pytest.mark.parametrize("stds", [(1.0, 1.0, 1.0, 1.0), (0.1, 0.1, 0.2, 0.2)])
def test_delta_encode_decode(stds):
    rng = np.random.default_rng(1)
    props = _random_boxes(rng, (64,))
    gt = _random_boxes(rng, (64,))
    enc = t_boxes.delta_encode(_t(props), _t(gt), stds=stds).numpy()
    ref = _np(j_boxes.delta_encode(props, gt, stds=stds))
    np.testing.assert_allclose(enc, ref, atol=1e-6, rtol=1e-6)
    # decode, with deltas beyond wh_ratio_clip and the max_shape clip
    deltas = rng.normal(0, 3, (64, 4)).astype(np.float32)
    for max_shape in (None, (60, 80)):
        got = t_boxes.delta_decode(
            _t(props), _t(deltas), stds=stds, max_shape=max_shape
        ).numpy()
        ref = _np(j_boxes.delta_decode(props, deltas, stds=stds,
                                       max_shape=max_shape))
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6)


def test_delta_decode_per_image_max_shape():
    """The batched port clips each image to its own (h, w), as the
    reference does under vmap."""
    rng = np.random.default_rng(2)
    props = _random_boxes(rng, (3, 20), hi=120.0)
    deltas = rng.normal(0, 1, (3, 20, 4)).astype(np.float32)
    hw = np.array([[50, 90], [100, 40], [64, 64]], np.int32)
    got = t_boxes.delta_decode(
        _t(props), _t(deltas), max_shape=(_t(hw[:, 0:1]), _t(hw[:, 1:2]))
    ).numpy()
    ref = np.stack([
        _np(j_boxes.delta_decode(props[i], deltas[i],
                                 max_shape=(hw[i, 0], hw[i, 1])))
        for i in range(3)
    ])
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("h,w,stride", [(4, 4, 16), (30, 30, 16), (5, 7, 8)])
def test_anchors_match(h, w, stride):
    got = t_anchors.generate_anchors(h, w, stride).numpy()
    ref = _np(j_anchors.generate_anchors(h, w, stride))
    assert got.shape == ref.shape == (h * w * 15, 4)
    np.testing.assert_allclose(got, ref, atol=1e-6)
    for border in (0, 8, -1):
        assert np.array_equal(
            t_anchors.anchor_inside_flags(_t(got), 60, 50, border).numpy(),
            _np(j_anchors.anchor_inside_flags(jnp.asarray(ref), 60, 50,
                                              border)),
        )


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("scale", [1.0, 1 / 16])
def test_roi_align_gather_matches(aligned, scale):
    rng = np.random.RandomState(8)
    B, H, W, C = 2, 12, 14, 8
    fmap = rng.randn(B, H, W, C).astype(np.float32)
    rois = (rng.rand(B, 6, 4).astype(np.float32) * 16 - 2) / scale
    rois[..., 2:] = rois[..., :2] + rng.rand(B, 6, 2).astype(np.float32) * 9 / scale
    rois[0, 0] = [-40, -40, -20, -20]  # wholly outside
    rois[1, 1, 2:] = rois[1, 1, :2]  # zero size
    got = t_roi.roi_align(_t(fmap), _t(rois), 7, spatial_scale=scale,
                          aligned=aligned).numpy()
    ref = _np(j_roi_align(jnp.asarray(fmap), jnp.asarray(rois), 7,
                          spatial_scale=scale, aligned=aligned))
    assert got.shape == ref.shape == (B, 6, 7, 7, C)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_roi_align_gather_mask_channel():
    """The support-mask call: C=1, uint8 masks dequantized first."""
    rng = np.random.RandomState(3)
    masks = (rng.rand(4, 32, 32) > 0.5).astype(np.uint8) * 255
    rois = np.tile(np.array([4, 4, 28, 28], np.float32), (4, 1, 1))
    fm = t_batching.mask_to_float(_t(masks)).reshape(4, 32, 32, 1)
    got = t_roi.roi_align(fm, _t(rois), 7).numpy()
    ref = _np(j_roi_align(
        jnp.asarray(masks, jnp.float32).reshape(4, 32, 32, 1) / 255.0,
        jnp.asarray(rois), 7,
    ))
    np.testing.assert_allclose(got, ref, atol=1e-5)


def _jax_nms(boxes, scores, valid, thr, max_out):
    return [
        np.stack(x)
        for x in zip(*(
            [_np(a) for a in j_nms.nms_padded(
                jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
                jnp.asarray(valid[i]), thr, max_out)]
            for i in range(boxes.shape[0])
        ))
    ]


@pytest.mark.parametrize("m,thr", [(256, 0.5), (300, 0.7), (128, 0.3), (513, 0.5)])
def test_nms_padded_matches(m, thr):
    rng = np.random.default_rng(m)
    B = 2
    boxes = _random_boxes(rng, (B, m))
    scores = rng.uniform(size=(B, m)).astype(np.float32)
    valid = rng.uniform(size=(B, m)) > 0.1
    got = t_nms.nms_padded(_t(boxes), _t(scores), _t(valid), thr, 100)
    ref = _jax_nms(boxes, scores, valid, thr, 100)
    for a, b, name in zip(got, ref, ["boxes", "scores", "idx", "valid"]):
        assert np.array_equal(a.numpy(), b), name
    assert got[2].dtype == torch.int32


def test_nms_padded_max_out_above_m():
    rng = np.random.default_rng(5)
    boxes = _random_boxes(rng, (1, 40))
    scores = rng.uniform(size=(1, 40)).astype(np.float32)
    valid = np.ones((1, 40), bool)
    got = t_nms.nms_padded(_t(boxes), _t(scores), _t(valid), 0.5, 64)
    ref = _jax_nms(boxes, scores, valid, 0.5, 64)
    for a, b in zip(got, ref):
        assert np.array_equal(a.numpy(), b)


def test_nms_ties_keep_lower_index():
    """Equal scores order as lax.top_k: stable, lower index first (where
    torch.topk would differ)."""
    s = np.array([[0.5, 0.7, 0.5, -np.inf, 0.7, -np.inf, 0.5]], np.float32)
    _, order = t_nms._sort_desc(_t(s))
    assert order[0].tolist() == list(_np(jax.lax.top_k(jnp.asarray(s[0]), 7)[1]))


def test_batched_nms_matches():
    rng = np.random.default_rng(7)
    B, M = 3, 300
    boxes = _random_boxes(rng, (B, M))
    scores = rng.uniform(size=(B, M)).astype(np.float32)
    valid = rng.uniform(size=(B, M)) > 0.1
    cls = rng.integers(0, 4, (B, M)).astype(np.int32)
    got = t_nms.batched_nms(_t(boxes), _t(scores), _t(cls), _t(valid), 0.5, 64)
    ref = [
        np.stack(x) for x in zip(*(
            [_np(a) for a in j_nms.batched_nms(
                jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
                jnp.asarray(cls[i]), jnp.asarray(valid[i]), 0.5, 64)]
            for i in range(B)
        ))
    ]
    for a, b, name in zip(got, ref, ["boxes", "scores", "cls", "idx", "valid"]):
        assert np.array_equal(a.numpy(), b), name


@pytest.mark.parametrize("case", ["identical", "none_valid"])
def test_nms_degenerate(case):
    boxes = np.tile(np.array([[[10, 10, 50, 50]]], np.float32), (1, 128, 1))
    scores = np.linspace(1, 0, 128, dtype=np.float32)[None]
    valid = np.full((1, 128), case == "identical")
    got = t_nms.nms_padded(_t(boxes), _t(scores), _t(valid), 0.5, 16)
    ref = _jax_nms(boxes, scores, valid, 0.5, 16)
    for a, b in zip(got, ref):
        assert np.array_equal(a.numpy(), b)
    assert int(got[3].sum()) == (1 if case == "identical" else 0)


def test_toy_batch_matches_graft_entry():
    from __graft_entry__ import _toy_batch

    ref = _toy_batch(B=2, H=64, W=96, N=3, K=2, S=32, G=5, seed=4)
    got = t_batching.toy_batch(B=2, H=64, W=96, N=3, K=2, S=32, G=5, seed=4)
    for name in got._fields:
        assert np.array_equal(getattr(got, name).numpy(),
                              _np(getattr(ref, name))), name


def test_mask_to_float_and_to_device():
    m8 = torch.tensor([[0, 255, 51]], dtype=torch.uint8)
    assert torch.equal(t_batching.mask_to_float(m8),
                       torch.tensor([[0.0, 1.0, 0.2]]))
    mf = torch.tensor([[0.0, 0.5]])
    assert torch.equal(t_batching.mask_to_float(mf), mf)
    b = t_batching.toy_batch(B=1, H=32, W=32, N=1, K=1, S=16)
    moved = t_batching.to_device(b, "cpu")
    assert all(t.device.type == "cpu" for t in moved)
