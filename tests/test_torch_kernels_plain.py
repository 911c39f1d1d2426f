"""The plain versions of fgn_torch's CUDA kernels against the JAX package's
Pallas TPU kernels (interpret mode), their custom VJP and plain references,
on CPU.

The CUDA kernels themselves run only on the card (``chip_smoke.py``); here
each wrapper is called with CPU tensors, where it takes its plain version
and launches nothing.

Tolerances: RoIAlign in f32 ≤ 1e-5 (the same hat-weight contractions,
summed in another order by another library); bf16 in and out within
2 bf16 ulp of the f32 result on the same bf16 inputs, the bound the JAX
package's own test holds its kernel to. The RoIAlign backward (the map's
gradient) in f32 within 1e-5 × max|df| of the JAX package's VJP; with a
bf16 map and cotangent within 2 bf16 ulp of max|df|. The NMS keep mask is
exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgn_tpu.ops.nms import _greedy_alive as j_greedy_alive
from fgn_tpu.ops.nms_pallas import greedy_alive_pallas
from fgn_tpu.ops.roi_align import roi_align as j_roi_align
from fgn_tpu.ops.roi_align_pallas import roi_align_pallas
from fgn_torch.ops.nms import _greedy_alive, nms_padded
from fgn_torch.ops.nms_cuda import greedy_alive_cuda
from fgn_torch.ops.roi_align_cuda import (
    _roi_align_plain, _roi_align_plain_bwd, roi_align_backward_cuda,
    roi_align_cuda,
)

torch.set_num_threads(2)

ROIS = np.array(
    [
        [[1.0, 1.0, 9.0, 9.0], [0.0, 0.0, 14.0, 12.0], [3.2, 2.1, 7.9, 10.4],
         [-6.0, -4.0, 2.0, 3.0], [20.0, 20.0, 30.0, 25.0], [4.0, 4.0, 4.0, 4.0]],
        [[2.0, 3.0, 6.0, 6.0], [0.5, 0.5, 2.0, 2.0], [5.0, 5.0, 13.0, 11.0],
         [1.0, 0.0, 12.0, 6.0], [13.5, 11.5, 16.0, 15.0], [7.0, 2.0, 7.0, 9.0]],
    ],
    np.float32,
)  # inside, partly outside, wholly outside, zero-size


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("aligned", [True, False])
def test_roi_align_plain_matches_pallas_and_gather(rng, aligned):
    B, H, W, C = 2, 12, 14, 8
    fmap = rng.rand(B, H, W, C).astype(np.float32)
    got = _roi_align_plain(_t(fmap), _t(ROIS), 4, aligned=aligned).numpy()
    pallas = np.asarray(roi_align_pallas(
        jnp.asarray(fmap), jnp.asarray(ROIS), 4, aligned=aligned,
        roi_chunk=2, channel_block=8, interpret=True,
    ))
    gather = np.asarray(j_roi_align(jnp.asarray(fmap), jnp.asarray(ROIS), 4,
                                    aligned=aligned))
    assert got.shape == pallas.shape == (B, 6, 4, 4, C)
    np.testing.assert_allclose(got, pallas, atol=1e-5)
    np.testing.assert_allclose(got, gather, atol=1e-5)


def test_roi_align_plain_scale_and_padding(rng):
    """R not a multiple of the TPU kernel's ROI chunk (its padding path),
    spatial scale 1/16."""
    B, H, W, C = 1, 8, 8, 16
    fmap = rng.rand(B, H, W, C).astype(np.float32)
    rois = (rng.rand(B, 5, 4).astype(np.float32) * 60).reshape(B, 5, 4)
    rois[..., 2:] = rois[..., :2] + 30
    got = _roi_align_plain(_t(fmap), _t(rois), 7, spatial_scale=1 / 16).numpy()
    pallas = np.asarray(roi_align_pallas(
        jnp.asarray(fmap), jnp.asarray(rois), 7, spatial_scale=1 / 16,
        roi_chunk=4, channel_block=16, interpret=True,
    ))
    gather = np.asarray(j_roi_align(jnp.asarray(fmap), jnp.asarray(rois), 7,
                                    spatial_scale=1 / 16))
    assert got.shape == (1, 5, 7, 7, 16)
    np.testing.assert_allclose(got, pallas, atol=1e-5)
    np.testing.assert_allclose(got, gather, atol=1e-5)


def test_roi_align_plain_bf16_in_out(rng):
    B, H, W, C = 2, 12, 14, 16
    fmap32 = rng.rand(B, H, W, C).astype(np.float32)
    fmap_bf16 = torch.from_numpy(fmap32).to(torch.bfloat16)
    got = _roi_align_plain(fmap_bf16, _t(ROIS), 7)
    assert got.dtype == torch.bfloat16
    pallas = roi_align_pallas(
        jnp.asarray(fmap32, jnp.bfloat16), jnp.asarray(ROIS), 7,
        roi_chunk=2, channel_block=8, interpret=True,
    )
    ref = np.asarray(j_roi_align(
        jnp.asarray(fmap32, jnp.bfloat16).astype(jnp.float32),
        jnp.asarray(ROIS), 7,
    ))
    err = np.abs(got.float().numpy() - ref)
    assert err.max() < 2 * 2.0 ** -8, err.max()
    err_pallas = np.abs(got.float().numpy()
                        - np.asarray(pallas, np.float32))
    assert err_pallas.max() < 2 * 2.0 ** -8, err_pallas.max()


def test_roi_align_wrapper_takes_plain_version_on_cpu(rng):
    fmap = _t(rng.rand(2, 12, 14, 8).astype(np.float32))
    before = roi_align_cuda.launches
    got = roi_align_cuda(fmap, _t(ROIS), 7, spatial_scale=0.5)
    assert torch.equal(got, _roi_align_plain(fmap, _t(ROIS), 7,
                                             spatial_scale=0.5))
    assert roi_align_cuda.launches == before


def test_roi_align_wrapper_rejects_other_devices():
    fmap = torch.zeros((1, 4, 4, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        roi_align_cuda(fmap, torch.zeros((1, 1, 4), device="meta"))


def _jax_vjp(fmap, rois, cot, out_size, aligned, roi_chunk, **kw):
    """The map's gradient by the JAX package: the Pallas kernel's custom
    VJP (interpret mode), and jax.grad of the gather form."""
    def pallas(f):
        return roi_align_pallas(f, jnp.asarray(rois), out_size, aligned=aligned,
                                roi_chunk=roi_chunk, channel_block=8,
                                interpret=True, **kw)

    _, vjp = jax.vjp(pallas, jnp.asarray(fmap))
    df_pallas = vjp(jnp.asarray(cot).astype(jnp.asarray(fmap).dtype))[0]
    df_gather = jax.grad(lambda f: jnp.sum(
        j_roi_align(f, jnp.asarray(rois), out_size, aligned=aligned, **kw)
        * jnp.asarray(cot, jnp.float32)))(jnp.asarray(fmap, jnp.float32))
    return np.asarray(df_pallas, np.float32), np.asarray(df_gather)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("roi_chunk", [1, 4])
def test_roi_align_plain_bwd_matches_jax_vjp(rng, aligned, roi_chunk):
    """ROIs inside, partly and wholly outside, of zero size; R = 6 not a
    multiple of either package's ROI chunk."""
    B, H, W, C = 2, 12, 14, 8
    fmap = rng.rand(B, H, W, C).astype(np.float32)
    cot = rng.randn(B, 6, 4, 4, C).astype(np.float32)
    got = _roi_align_plain_bwd(_t(cot), _t(ROIS), H, W, torch.float32, 4,
                               aligned=aligned, roi_chunk=roi_chunk).numpy()
    pallas, gather = _jax_vjp(fmap, ROIS, cot, 4, aligned, roi_chunk)
    scale = np.abs(pallas).max()
    assert got.shape == (B, H, W, C)
    assert np.abs(got - pallas).max() <= 1e-5 * scale
    assert np.abs(got - gather).max() <= 1e-5 * scale
    assert np.abs(got[0, :, :, 0]).max() > 0  # gradient reached the map


def test_roi_align_plain_bwd_scale_and_bf16(rng):
    """spatial_scale 1/16, 7x7 bins; then a bf16 map and cotangent: the
    result in bf16, within 2 bf16 ulp of max|df| of the f32 gradient on the
    same bf16 inputs."""
    B, H, W, C = 1, 8, 8, 16
    rois = (rng.rand(B, 5, 4).astype(np.float32) * 60).reshape(B, 5, 4)
    rois[..., 2:] = rois[..., :2] + 30
    cot = rng.randn(B, 5, 7, 7, C).astype(np.float32)
    fmap = rng.rand(B, H, W, C).astype(np.float32)
    got = _roi_align_plain_bwd(_t(cot), _t(rois), H, W, torch.float32, 7,
                               spatial_scale=1 / 16).numpy()
    pallas, gather = _jax_vjp(fmap, rois, cot, 7, True, 4, spatial_scale=1 / 16)
    scale = np.abs(pallas).max()
    assert np.abs(got - pallas).max() <= 1e-5 * scale
    assert np.abs(got - gather).max() <= 1e-5 * scale

    cot16 = torch.from_numpy(cot).to(torch.bfloat16)
    got16 = _roi_align_plain_bwd(cot16, _t(rois), H, W, torch.bfloat16, 7,
                                 spatial_scale=1 / 16)
    assert got16.dtype == torch.bfloat16
    ref = _roi_align_plain_bwd(cot16.float(), _t(rois), H, W, torch.float32, 7,
                               spatial_scale=1 / 16).numpy()
    bound = 2 * 2.0 ** -8 * np.abs(ref).max()
    assert np.abs(got16.float().numpy() - ref).max() <= bound
    pallas16, _ = _jax_vjp(
        jnp.asarray(fmap, jnp.bfloat16), rois,
        np.asarray(jnp.asarray(cot16.float().numpy(), jnp.bfloat16)), 7, True,
        4, spatial_scale=1 / 16)
    assert np.abs(got16.float().numpy() - pallas16).max() <= bound


def test_roi_align_autograd_uses_plain_bwd_on_cpu(rng):
    """On CPU tensors roi_align_cuda's backward is _roi_align_plain_bwd,
    through roi_align_backward_cuda, and launches nothing; no gradient
    reaches the ROIs."""
    fmap = _t(rng.rand(2, 12, 14, 8).astype(np.float32)).requires_grad_()
    rois = _t(ROIS).requires_grad_()
    cot = _t(rng.randn(2, 6, 7, 7, 8).astype(np.float32))
    before = (roi_align_cuda.launches, roi_align_backward_cuda.launches)
    out = roi_align_cuda(fmap, rois, 7, spatial_scale=0.5)
    out.backward(cot)
    want = _roi_align_plain_bwd(cot, _t(ROIS), 12, 14, torch.float32, 7,
                                spatial_scale=0.5)
    assert torch.equal(fmap.grad, want)
    assert torch.equal(roi_align_backward_cuda(cot, _t(ROIS), 12, 14, 7,
                                               spatial_scale=0.5), want)
    assert rois.grad is None
    assert (roi_align_cuda.launches, roi_align_backward_cuda.launches) == before
    with pytest.raises(ValueError, match="unsupported device"):
        roi_align_backward_cuda(torch.zeros((1, 1, 7, 7, 8), device="meta"),
                                torch.zeros((1, 1, 4), device="meta"), 4, 4)


def _sorted_boxes(seed, B, Mp, n_valid):
    rng = np.random.default_rng(seed)
    ctr = rng.uniform(0, 100, (B, Mp, 2))
    wh = rng.uniform(5, 40, (B, Mp, 2))
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)
    alive = np.zeros((B, Mp), bool)
    alive[:, :n_valid] = rng.uniform(size=(B, n_valid)) > 0.1
    return boxes, alive


@pytest.mark.parametrize(
    "mp,n_valid,thr", [(128, 128, 0.5), (256, 200, 0.3), (384, 300, 0.7),
                       (512, 513 - 128, 0.5)]
)
def test_greedy_alive_plain_matches_pallas(mp, n_valid, thr):
    B = 2
    boxes, alive = _sorted_boxes(mp, B, mp, n_valid)
    got = _greedy_alive(_t(boxes), _t(alive), thr, 128).numpy()
    for i in range(B):
        pallas = np.asarray(greedy_alive_pallas(
            jnp.asarray(boxes[i]), jnp.asarray(alive[i]), thr, interpret=True
        ))
        sweep = np.asarray(j_greedy_alive(
            jnp.asarray(boxes[i]), jnp.asarray(alive[i]), thr, 128
        ))
        assert np.array_equal(got[i], pallas)
        assert np.array_equal(got[i], sweep)


@pytest.mark.parametrize("case", ["identical", "none_alive"])
def test_greedy_alive_plain_degenerate(case):
    boxes = np.tile(np.array([[[10, 10, 50, 50]]], np.float32), (1, 128, 1))
    alive = np.full((1, 128), case == "identical")
    got = _greedy_alive(_t(boxes), _t(alive), 0.5, 128).numpy()
    ref = np.asarray(greedy_alive_pallas(
        jnp.asarray(boxes[0]), jnp.asarray(alive[0]), 0.5, interpret=True
    ))
    assert np.array_equal(got[0], ref)
    assert got.sum() == (1 if case == "identical" else 0)


def test_nms_wrapper_takes_plain_version_on_cpu():
    boxes, alive = _sorted_boxes(3, 2, 256, 256)
    before = greedy_alive_cuda.launches
    got = greedy_alive_cuda(_t(boxes), _t(alive), 0.7)
    assert torch.equal(got, _greedy_alive(_t(boxes), _t(alive), 0.7))
    assert greedy_alive_cuda.launches == before
    # as the alive_fn of nms_padded, M not a multiple of 128
    scores = torch.rand(2, 200, generator=torch.Generator().manual_seed(0))
    valid = torch.ones(2, 200, dtype=torch.bool)
    a = nms_padded(_t(boxes[:, :200]), scores, valid, 0.5, 50,
                   alive_fn=greedy_alive_cuda)
    b = nms_padded(_t(boxes[:, :200]), scores, valid, 0.5, 50,
                   alive_fn=_greedy_alive)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
