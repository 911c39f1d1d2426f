"""The plain versions of fgn_torch's CUDA kernels against the JAX package's
Pallas TPU kernels (interpret mode), their custom VJP and plain references,
on CPU.

The CUDA kernels themselves run only on the card (``chip_smoke.py``); here
each wrapper is called with CPU tensors, where it takes its plain version
and launches nothing.

The staged forward kernel's shape rules (``_channel_tile``,
``_rois_per_block``) and its arithmetic (``_bin_lists``, the merged corner
lists, and ``_roi_align_separable``, the separable sum over them) are
plain Python and torch, held here too.

Tolerances: RoIAlign in f32 ≤ 1e-5 (the same hat-weight contractions,
summed in another order by another library); bf16 in and out within
2 bf16 ulp of the f32 result on the same bf16 inputs, the bound the JAX
package's own test holds its kernel to. The RoIAlign backward (the map's
gradient) in f32 within 1e-5 × max|df| of the JAX package's VJP; with a
bf16 map and cotangent within 2 bf16 ulp of max|df|. The NMS keep mask is
exact.

The NMS kernel's walk (``_greedy_alive_walk``: chunks of 32 rows, the kept
rows of one chunk suppressing the later columns while the next chunk is
decided, chunks after the last alive row skipped) and its wrapper's rules
(``_staged``, ``_cluster_size``) are held here too.

So are the ctypes bindings (``ops/_build._SIGNATURES``,
``native._SIGNATURES``) against the ``extern "C"`` definitions of their
sources, read as text: no compiler is needed.
"""

import ctypes
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgn_tpu.ops.nms import _greedy_alive as j_greedy_alive
from fgn_tpu.ops.nms_pallas import greedy_alive_pallas
from fgn_tpu.ops.roi_align import roi_align as j_roi_align
from fgn_tpu.ops.roi_align_pallas import roi_align_pallas
from fgn_torch.ops.nms import _greedy_alive, _greedy_alive_walk, nms_padded
from fgn_torch.ops.nms_cuda import (
    _WALK_SMEM_MAX, _cluster_size, _staged, _walk_smem, greedy_alive_cuda,
)
from fgn_torch.ops.roi_align_cuda import (
    _SMEM_MAX, _SMEM_TWO_BLOCKS, _bin_lists, _channel_tile, _hat_weights,
    _list_bytes, _roi_align_forward, _roi_align_plain, _roi_align_plain_bwd,
    _roi_align_separable, _roi_axes, _rois_per_block, roi_align_backward_cuda,
    roi_align_cuda,
)
from fgn_torch.utils.profiling import counts

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
    before = counts()
    got = roi_align_cuda(fmap, _t(ROIS), 7, spatial_scale=0.5)
    assert torch.equal(got, _roi_align_plain(fmap, _t(ROIS), 7,
                                             spatial_scale=0.5))
    assert counts() == before


def test_roi_align_wrapper_rejects_other_devices():
    fmap = torch.zeros((1, 4, 4, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        roi_align_cuda(fmap, torch.zeros((1, 1, 4), device="meta"))


# (H, W, C) of the maps the model gives RoIAlign: toy test maps (64 px
# queries, 32 px supports at stride 16; the 12x14 map of the tests above),
# 128 px supports, 480 px queries, COCO2VOC's 800x1088 queries. → the
# staged kernel's tile in bf16 and f32.
MAP_TILES = [
    ((2, 2, 1024), 128, 128), ((4, 4, 1024), 128, 128),
    ((12, 14, 8), 8, 8), ((12, 14, 128), 128, 128),
    ((8, 8, 1024), 128, 128), ((30, 30, 1024), 32, 16),
    ((50, 68, 1024), 16, 8),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hwc,bf16_tile,f32_tile", MAP_TILES)
def test_channel_tile_of_the_model_maps(hwc, bf16_tile, f32_tile, dtype):
    """Every map of the model takes the staged kernel: the tile divides C,
    holds at least 8 channels (16 bytes), keeps the slice and the bin lists
    within two blocks an SM, and is the largest such power of two."""
    H, W, C = hwc
    esize = 2 if dtype == torch.bfloat16 else 4
    ct = _channel_tile(H, W, C, dtype)
    assert ct == (bf16_tile if dtype == torch.bfloat16 else f32_tile)
    assert C % ct == 0 and 8 <= ct <= 128 and ct & (ct - 1) == 0
    assert ct * esize % 16 == 0
    assert H * W * ct * esize + _list_bytes(7, 2) <= _SMEM_TWO_BLOCKS
    if ct < 128 and C % (2 * ct) == 0:
        assert H * W * 2 * ct * esize + _list_bytes(7, 2) > _SMEM_TWO_BLOCKS


@pytest.mark.parametrize("H,W,C,dtype,want", [
    (100, 100, 1024, torch.bfloat16, 8),   # fits one block an SM only
    (60, 100, 1024, torch.float32, 8),
    (128, 128, 128, torch.bfloat16, None),  # past the limit: direct kernel
    (120, 120, 1024, torch.bfloat16, None),
    (60, 120, 1024, torch.float32, None),
    (30, 30, 12, torch.bfloat16, None),     # no tile of 8+ channels divides C
    (30, 30, 4, torch.float32, None),
])
def test_channel_tile_limits(H, W, C, dtype, want):
    assert _channel_tile(H, W, C, dtype) == want
    esize = 2 if dtype == torch.bfloat16 else 4
    if want is None and C % 8 == 0:
        assert H * W * 8 * esize + _list_bytes(7, 2) > _SMEM_MAX
    elif want is not None:
        assert H * W * want * esize + _list_bytes(7, 2) <= _SMEM_MAX


@pytest.mark.parametrize("B,tiles,R", [
    (8, 32, 300), (8, 32, 100), (72, 8, 1), (12, 32, 128), (108, 8, 1),
    (4, 64, 300), (1, 16, 64), (2, 1, 6),
])
def test_rois_per_block(B, tiles, R):
    """Whole chunks of 8 ROIs, no empty block, two chunks or more per block
    where there are two, and 16 blocks per SM (132) where the ROIs allow."""
    per = _rois_per_block(B, tiles, R, sms=132)
    groups = -(-R // per)
    chunks = -(-R // 8)
    assert per % 8 == 0 and per >= min(16, 8 * chunks)
    assert (groups - 1) * per < R <= groups * per
    assert groups * tiles * B >= min(16 * 132, tiles * B * (chunks // 2))


def _axis_lists(rois, size, axis, O, S, scale, aligned):
    y1, bh, x1, bw = _roi_axes(_t(rois), O, scale, aligned)
    start, bin_size = (y1, bh) if axis == "y" else (x1, bw)
    return (_bin_lists(start, bin_size, size, O, S),
            _hat_weights(start, bin_size, size, O, S))


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("O,S", [(7, 2), (4, 2), (7, 1), (3, 3)])
@pytest.mark.parametrize("axis", ["y", "x"])
def test_bin_lists_reproduce_hat_weights(axis, O, S, aligned):
    """The merged (index, weight) lists of every bin, summed, give
    ``_hat_weights`` × S, on ROIs inside the map, straddling its edge,
    wholly outside, of zero size, aligned and not; each list holds at most
    2S distinct indices, and a bin narrower than a pixel at most S + 1."""
    size = 12 if axis == "y" else 14
    (idx, w, n), hat = _axis_lists(ROIS, size, axis, O, S, 1.0, aligned)
    dense = torch.zeros(hat.shape, dtype=torch.float32).scatter_add_(
        -1, idx, w)
    np.testing.assert_allclose(dense.numpy(), (hat * S).numpy(), atol=1e-6)
    assert int(n.max()) <= 2 * S
    for lst, cnt in zip(idx.reshape(-1, 2 * S), n.reshape(-1)):
        assert len(set(lst[:cnt].tolist())) == int(cnt)
    y1, bh, x1, bw = _roi_axes(_t(ROIS), O, 1.0, aligned)
    narrow = (bh if axis == "y" else bw) < 1.0
    assert bool((n[narrow] <= S + 1).all())
    assert tuple(n.shape) == (2, 6, O)
    assert int(n[0, 4].sum()) == 0  # the ROI wholly outside the map


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("O", [4, 7])
def test_separable_sum_matches_pallas_and_plain(rng, O, aligned):
    """The staged kernel's order of summation (separable, over the merged
    lists) against the JAX package's TPU kernel in interpret mode and the
    plain version, f32, within 1e-5 of the output's scale."""
    B, H, W, C = 2, 12, 14, 8
    fmap = rng.rand(B, H, W, C).astype(np.float32)
    got = _roi_align_separable(_t(fmap), _t(ROIS), O, aligned=aligned).numpy()
    pallas = np.asarray(roi_align_pallas(
        jnp.asarray(fmap), jnp.asarray(ROIS), O, aligned=aligned,
        roi_chunk=2, channel_block=8, interpret=True,
    ))
    plain = _roi_align_plain(_t(fmap), _t(ROIS), O, aligned=aligned).numpy()
    scale = np.abs(plain).max()
    assert got.shape == pallas.shape == (B, 6, O, O, C)
    assert np.abs(got - pallas).max() <= 1e-5 * scale
    assert np.abs(got - plain).max() <= 1e-5 * scale


def test_separable_sum_scale_and_bf16(rng):
    """spatial_scale 1/16 and sampling ratio 2 at out_size 7, as the model
    calls it; a bf16 map gives a bf16 result within 2 bf16 ulp of the f32
    sum on the same bf16 inputs."""
    B, H, W, C = 1, 8, 8, 16
    fmap = rng.rand(B, H, W, C).astype(np.float32)
    rois = (rng.rand(B, 5, 4).astype(np.float32) * 60).reshape(B, 5, 4)
    rois[..., 2:] = rois[..., :2] + 30
    got = _roi_align_separable(_t(fmap), _t(rois), 7, spatial_scale=1 / 16)
    pallas = np.asarray(roi_align_pallas(
        jnp.asarray(fmap), jnp.asarray(rois), 7, spatial_scale=1 / 16,
        roi_chunk=4, channel_block=16, interpret=True,
    ))
    scale = np.abs(pallas).max()
    assert np.abs(got.numpy() - pallas).max() <= 1e-5 * scale
    f16 = _t(fmap).to(torch.bfloat16)
    got16 = _roi_align_separable(f16, _t(rois), 7, spatial_scale=1 / 16)
    assert got16.dtype == torch.bfloat16
    ref = _roi_align_plain(f16.float(), _t(rois), 7, spatial_scale=1 / 16)
    bound = 2 * 2.0 ** -8 * float(ref.abs().max())
    assert float((got16.float() - ref).abs().max()) <= bound


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("O", [7, 14])
def test_roi_axes_divide_as_ieee(rng, O, aligned):
    """The plain versions' bin sizes are the ROI's side divided by O with
    one IEEE rounding, as the kernels' ``__fdiv_rn`` computes them (the
    forward on the CPU launches nothing)."""
    rois = _t((rng.rand(2, 50, 4) * 480).astype(np.float32))
    y1, bh, x1, bw = _roi_axes(rois, O, 1 / 16, aligned)
    off = 0.5 if aligned else 0.0
    for lo, hi, got in ((1, 3, bh), (0, 2, bw)):
        side = (rois[..., hi] * (1 / 16) - off) - (rois[..., lo] * (1 / 16) - off)
        if not aligned:
            side = side.clamp(min=1.0)
        want = (side.double() / O).float()
        assert torch.equal(got, want)
    before = counts()
    fmap = _t(rng.rand(2, 30, 30, 8).astype(np.float32))
    got = _roi_align_forward(fmap, rois, O, 1 / 16, 2, aligned)
    assert torch.equal(got, _roi_align_plain(fmap, rois, O, 1 / 16, 2, aligned))
    assert counts() == before


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
    before = counts()
    out = roi_align_cuda(fmap, rois, 7, spatial_scale=0.5)
    out.backward(cot)
    want = _roi_align_plain_bwd(cot, _t(ROIS), 12, 14, torch.float32, 7,
                                spatial_scale=0.5)
    assert torch.equal(fmap.grad, want)
    assert torch.equal(roi_align_backward_cuda(cot, _t(ROIS), 12, 14, 7,
                                               spatial_scale=0.5), want)
    assert rois.grad is None
    assert counts() == before
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
    before = counts()
    got = greedy_alive_cuda(_t(boxes), _t(alive), 0.7)
    assert torch.equal(got, _greedy_alive(_t(boxes), _t(alive), 0.7))
    assert counts() == before
    # as the alive_fn of nms_padded, M not a multiple of 128
    scores = torch.rand(2, 200, generator=torch.Generator().manual_seed(0))
    valid = torch.ones(2, 200, dtype=torch.bool)
    a = nms_padded(_t(boxes[:, :200]), scores, valid, 0.5, 50,
                   alive_fn=greedy_alive_cuda)
    b = nms_padded(_t(boxes[:, :200]), scores, valid, 0.5, 50,
                   alive_fn=_greedy_alive)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# Chains of three boxes, each overlapping the next at IoU 2/3 and the third
# at IoU 3/7: the first suppresses the second, which therefore does not
# suppress the third (threshold 0.5). Rows within each 256, so that chains
# sit inside a chunk of 32, cross into the next chunk, and reach two and
# four chunks ahead.
CHAINS = ((30, 31, 32), (60, 70, 100), (95, 130, 170), (200, 201, 240))


def _nms_case(kind, Mp, B=2, seed=0):
    """Score-sorted (B, Mp, 4) f32 XYXY boxes and (B, Mp) alive flags."""
    rng = np.random.default_rng(seed)
    i = np.arange(Mp, dtype=np.float32)
    alive = np.ones((B, Mp), bool)
    if kind == "random":  # RPN-like on a 480 px image, a few dead
        ctr = rng.uniform(0, 480, (B, Mp, 2))
        wh = rng.uniform(4, 196, (B, Mp, 2))
        boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1)
        alive = rng.uniform(size=(B, Mp)) > 0.05
    elif kind in ("chains", "disjoint"):  # far apart: no box overlaps another
        x, y = (i % 64) * 100, (i // 64) * 100
        boxes = np.tile(np.stack([x, y, x + 10, y + 10], -1), (B, 1, 1))
        for blk in range(0, Mp if kind == "chains" else 0, 256):
            for trip in CHAINS:
                base = boxes[:, blk + trip[0]].copy()
                for k, r in enumerate(trip):
                    boxes[:, blk + r] = base + [2.0 * k, 0, 2.0 * k, 0]
    elif kind == "exact":  # pairs at IoU exactly 1/2 (and 1/4 every other)
        x = (i // 2) * 10
        boxes = np.stack([x, 0 * x, x + 2, 0 * x + 1], -1)
        boxes[1::2, 2] = x[1::2] + 1
        boxes[1::4, 2] = x[1::4] + 0.5
        boxes = np.tile(boxes, (B, 1, 1))
    elif kind == "zero_area":  # zero widths, zero heights and points
        ctr = rng.uniform(0, 100, (B, Mp, 2))
        wh = rng.uniform(4, 40, (B, Mp, 2))
        boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1)
        boxes[:, ::3, 2] = boxes[:, ::3, 0]
        boxes[:, 1::5, 3] = boxes[:, 1::5, 1]
        boxes[:, 7::9] = 5.0
        alive = rng.uniform(size=(B, Mp)) > 0.1
    else:  # "none": nothing alive
        boxes = rng.uniform(0, 100, (B, Mp, 4))
        alive[:] = False
    return boxes.astype(np.float32), alive


@pytest.mark.parametrize("kind,mp,thr", [
    ("random", 128, 0.7), ("random", 384, 0.5), ("random", 1024, 0.7),
    ("random", 1024, 0.3), ("chains", 256, 0.5), ("chains", 512, 0.5),
    ("exact", 256, 0.5), ("exact", 256, 0.25), ("zero_area", 512, 0.0),
    ("zero_area", 512, 0.5), ("disjoint", 1024, 0.5), ("none", 256, 0.5),
])
def test_walk_order_matches_pallas_and_sweeps(kind, mp, thr):
    """The kernel's order of decisions and suppressions gives the greedy
    keep mask bit for bit: against the JAX package's TPU kernel (interpret
    mode) and blocked sweep, and the port's sweep."""
    boxes, alive = _nms_case(kind, mp)
    got = _greedy_alive_walk(_t(boxes), _t(alive), thr).numpy()
    assert np.array_equal(got, _greedy_alive(_t(boxes), _t(alive), thr).numpy())
    for b in range(boxes.shape[0]):
        pallas = np.asarray(greedy_alive_pallas(
            jnp.asarray(boxes[b]), jnp.asarray(alive[b]), thr, interpret=True))
        sweep = np.asarray(j_greedy_alive(
            jnp.asarray(boxes[b]), jnp.asarray(alive[b]), thr, 128))
        assert np.array_equal(got[b], pallas)
        assert np.array_equal(got[b], sweep)
    want_dropped = {"chains": len(CHAINS) * mp // 256, "disjoint": 0,
                    "exact": mp // 4 if thr < 0.5 else 0}
    if kind in want_dropped:  # the second box of each chain; exact pairs
        assert int((alive & ~got).sum(1).max()) == want_dropped[kind]
    assert not (got & ~alive).any()


def test_walk_ragged_last_chunk():
    """Mp not a multiple of the 32-row chunk: the last chunk is partial."""
    boxes, alive = _nms_case("random", 100, B=3, seed=1)
    got = _greedy_alive_walk(_t(boxes), _t(alive), 0.5)
    assert torch.equal(got, _greedy_alive(_t(boxes), _t(alive), 0.5, 100))
    sweep = j_greedy_alive(jnp.asarray(boxes[0]), jnp.asarray(alive[0]), 0.5, 100)
    assert np.array_equal(got[0].numpy(), np.asarray(sweep))


@pytest.mark.parametrize("mp,staged", [
    (128, True), (1024, True), (4096, True), (6144, True), (11_357, True),
    (11_358, False), (16_384, False),
])
def test_walk_shared_memory_rule(mp, staged):
    """A mailbox slot (8 bytes) and a word of removed bits (4) per chunk of
    32, and the boxes and areas of an image (20 bytes a candidate), stay in
    a block's shared memory up to Mp = 11,357, every Mp of the model
    included; past that the walk reads the boxes from device memory."""
    chunks = -(-mp // 32)
    assert _walk_smem(mp, False) == -(-12 * chunks // 16) * 16 <= _WALK_SMEM_MAX
    assert _walk_smem(mp, True) == _walk_smem(mp, False) + 20 * mp
    assert _staged(mp) == staged
    assert (_walk_smem(mp, True) <= _WALK_SMEM_MAX) == staged


# Clusters of G walk blocks the card can run at once, as the occupancy query
# reported them on an H100 (132 SMs) for the walk's 1024-thread blocks.
H100_CLUSTERS = {16: 7, 8: 15, 4: 30, 2: 66}


@pytest.mark.parametrize("B,mp,want", [
    (8, 4096, 8), (8, 1024, 8),  # flagship RPN, detections: 7 of 16 fit
    (12, 4096, 8),               # the train step's RPN
    (4, 6144, 16), (4, 1024, 16),  # COCO2VOC
    (2, 128, 2),                 # 4 chunks: two a block at most
    (2, 32, 1), (40, 4096, 2), (200, 4096, 1),
])
def test_cluster_size_rule(B, mp, want):
    """The largest cluster of 16 or fewer blocks that leaves each block two
    chunks and lets the card hold all B clusters at once."""
    g = _cluster_size(B, mp, H100_CLUSTERS.get)
    assert g == want
    assert g == 1 or (H100_CLUSTERS[g] >= B and 2 * 32 * g <= mp)


def test_nms_wrapper_rejects_other_devices():
    before = counts()
    boxes = torch.zeros((1, 128, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        greedy_alive_cuda(boxes, torch.zeros((1, 128), dtype=torch.bool,
                                             device="meta"), 0.5)
    assert counts() == before


# --- the ctypes bindings against their C sources ------------------------------
#
# A binding whose argument list drifts from its C definition corrupts memory
# silently on the card, and nothing compiles there until a call. So each
# bound function must be defined inside its source's ``extern "C"`` blocks
# with as many parameters as its ``argtypes``, each of the kind ctypes passes
# (a pointer as ``c_void_p`` or ``c_char_p``), and every function defined
# there must be bound.

_C_TYPES = {"int": ctypes.c_int, "float": ctypes.c_float,
            "long long": ctypes.c_longlong}


def _c_kind(decl: str):
    """The ctypes kinds a C parameter or return type may be bound as."""
    if "*" in decl:
        return (ctypes.c_char_p,) if re.search(r"\bchar\s*\*", decl) else (
            ctypes.c_void_p, ctypes.c_char_p)
    words = re.sub(r"\b(const|unsigned|signed)\b", " ", decl).split()
    return (_C_TYPES[" ".join(words[:-1])],)  # less the name


def _extern_c_functions(path: Path):
    """{name: (return type, [parameter declarations])} of the functions
    defined at the top level of the file's ``extern "C"`` blocks."""
    src = re.sub(r"//[^\n]*|/\*.*?\*/", "", path.read_text(), flags=re.S)
    found = {}
    for start in re.finditer(r'extern\s+"C"\s*\{', src):
        depth, top = 1, []  # the block's text outside nested braces
        for ch in src[start.end():]:
            depth += (ch == "{") - (ch == "}")
            if depth == 0:
                break
            if depth == 1 or (depth == 2 and ch == "{"):
                top.append(ch)
        for m in re.finditer(r"([A-Za-z_][\w\s\*]*?)\b(\w+)\s*\(([^()]*)\)\s*\{",
                             "".join(top)):
            params = [p.strip() for p in m.group(3).split(",")
                      if p.strip() not in ("", "void")]
            found[m.group(2)] = (m.group(1).strip(), params)
    return found


def _binding_sources():
    from fgn_torch import native
    from fgn_torch.ops import _build

    out = {name: (_build.SRC_DIR / f"{name}.cu", sigs)
           for name, sigs in _build._SIGNATURES.items()}
    out["rle"] = (native.SRC, native._SIGNATURES)
    return out


@pytest.mark.parametrize("name", ["roi_align", "nms", "group_norm",
                                  "vit_attention", "optim", "rle"])
def test_bindings_match_sources(name):
    path, sigs = _binding_sources()[name]
    defined = _extern_c_functions(path)
    assert set(defined) == set(sigs), (
        f"{path.name}: defined but not bound {sorted(set(defined) - set(sigs))}"
        f", bound but not defined {sorted(set(sigs) - set(defined))}")
    for fn, (argtypes, restype) in sigs.items():
        ret, params = defined[fn]
        assert len(params) == len(argtypes), (fn, params, argtypes)
        for i, (decl, bound) in enumerate(zip(params, argtypes)):
            assert bound in _c_kind(decl), (fn, i, decl, bound)
        assert restype in _c_kind(ret + " x"), (fn, ret, restype)


def test_every_source_is_bound():
    from fgn_torch.ops import _build

    sources = {p.stem for p in _build.SRC_DIR.glob("*.cu")}
    assert sources == set(_build._SIGNATURES)
    assert sources == {"roi_align", "nms", "group_norm", "vit_attention",
                       "optim"}
