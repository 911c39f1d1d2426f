"""The staged RoIAlign backward kernel's rules and arithmetic on CPU.

The kernel itself runs only on the card (``chip_smoke.py``). Here:
``_bwd_channel_tile``, the tile rule, at every map the repo's configs give
RoIAlign; ``_roi_align_bwd_ordered``, the kernel's dense weights and order
of summation in torch, against the JAX package's VJP of its Pallas kernel
(interpret mode) and against ``_roi_align_plain_bwd``; and the wrapper on
CPU tensors, which takes the plain version and launches nothing.

Tolerances as in ``test_torch_kernels_plain.py``: f32 within 1e-5 of
max|df| (the same sums in another order); a bf16 cotangent gives a bf16
gradient within 2 bf16 ulp of max|df| of the f32 gradient on the same
inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgn_tpu.ops.roi_align import roi_align as j_roi_align
from fgn_tpu.ops.roi_align_pallas import roi_align_pallas
from fgn_torch.ops.roi_align_cuda import (
    _ROI_CHUNK, _SMEM_MAX, _bwd_channel_tile, _bwd_smem, _bwd_threads,
    _roi_align_bwd_ordered, _roi_align_plain_bwd, roi_align_cuda,
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


def _rois(rng, B, R, extent):
    """ROIs as ``ROIS`` mixes them, R per image: most inside the map, some
    partly or wholly outside, some of zero size."""
    ctr = rng.rand(B, R, 2) * extent * 1.4 - 0.2 * extent
    wh = rng.rand(B, R, 2) * extent * 0.6
    rois = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)
    rois[:, 3::7, 2:] = rois[:, 3::7, :2]
    rois[:, 5::11] += 3 * extent
    return rois


# (H, W, C, R) of every map the repo's configs give the backward: flagship
# supports (108 maps, R = 1); COCO2VOC supports at 256 px; flagship sampled
# ROIs (R = 128); COCO2VOC 800x1088 training; 800x1333. → the tile in bf16
# and in f32.
BWD_MAPS = [
    ((8, 8, 1024, 1), 128, 128),
    ((16, 16, 1024, 1), 128, 128),
    ((30, 30, 1024, 128), 32, 32),
    ((50, 68, 1024, 128), 8, 8),
    ((50, 84, 1024, 128), 8, 8),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hwcr,bf16_tile,f32_tile", BWD_MAPS)
def test_bwd_channel_tile_of_the_model_maps(hwcr, bf16_tile, f32_tile, dtype):
    """Every map of the repo's configs takes the staged backward: the tile
    divides C, holds 16 bytes of g or more, and is the largest power of two
    up to 128 that fits in a block's shared memory."""
    H, W, C, R = hwcr
    esize = 2 if dtype == torch.bfloat16 else 4
    ct = _bwd_channel_tile(H, W, C, dtype, R)
    assert ct == (bf16_tile if dtype == torch.bfloat16 else f32_tile)
    assert C % ct == 0 and 8 <= ct <= 128 and ct * esize % 16 == 0
    assert _bwd_smem(H, W, ct, esize, R) <= _SMEM_MAX
    if ct < 128:
        assert _bwd_smem(H, W, 2 * ct, esize, R) > _SMEM_MAX


@pytest.mark.parametrize("H,want", [(8, 256), (16, 512), (30, 960), (50, 1024)])
def test_bwd_threads_a_warp_a_row(H, want):
    assert _bwd_threads(H) == want


@pytest.mark.parametrize("H,W,C,R,dtype", [
    (128, 128, 128, 64, torch.bfloat16),  # the accumulator alone is too big
    (60, 100, 1024, 128, torch.float32),
    (30, 30, 12, 128, torch.bfloat16),    # no tile of 8+ channels divides C
])
def test_bwd_channel_tile_sends_to_atomics(H, W, C, R, dtype):
    assert _bwd_channel_tile(H, W, C, dtype, R) is None
    if C % 8 == 0:
        esize = 2 if dtype == torch.bfloat16 else 4
        assert _bwd_smem(H, W, 8, esize, R) > _SMEM_MAX


def test_bwd_smem_counts_chunks_and_buffers():
    """One buffer of a chunk's g slice for a single chunk, two otherwise,
    beside one set of weights; a chunk holds at most ``_ROI_CHUNK`` ROIs."""
    acc = 30 * 30 * 16 * 4
    g_slice = 49 * 16 * 2
    weights = 8 * 60 * 4 + 16  # dense weights, bin ranges, footprint
    assert _bwd_smem(30, 30, 16, 2, 1) == acc + g_slice + weights
    assert (_bwd_smem(30, 30, 16, 2, _ROI_CHUNK)
            == acc + _ROI_CHUNK * (g_slice + weights))
    assert (_bwd_smem(30, 30, 16, 2, 128)
            == acc + _ROI_CHUNK * (2 * g_slice + weights))


def _jax_vjp(fmap, rois, cot, out_size, aligned, **kw):
    """The map's gradient by the JAX package: the Pallas kernel's custom
    VJP (interpret mode), and jax.grad of the gather form."""
    def pallas(f):
        return roi_align_pallas(f, jnp.asarray(rois), out_size, aligned=aligned,
                                roi_chunk=4, channel_block=8, interpret=True,
                                **kw)

    _, vjp = jax.vjp(pallas, jnp.asarray(fmap))
    df_pallas = vjp(jnp.asarray(cot).astype(jnp.asarray(fmap).dtype))[0]
    df_gather = jax.grad(lambda f: jnp.sum(
        j_roi_align(f, jnp.asarray(rois), out_size, aligned=aligned, **kw)
        * jnp.asarray(cot, jnp.float32)))(jnp.asarray(fmap, jnp.float32))
    return np.asarray(df_pallas, np.float32), np.asarray(df_gather)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("O", [4, 7])
def test_bwd_ordered_matches_jax_vjp_and_plain(rng, O, aligned):
    """ROIs inside, partly and wholly outside, of zero size; R = 6, less
    than a chunk."""
    B, H, W, C = 2, 12, 14, 8
    fmap = rng.rand(B, H, W, C).astype(np.float32)
    cot = rng.randn(B, 6, O, O, C).astype(np.float32)
    got = _roi_align_bwd_ordered(_t(cot), _t(ROIS), H, W, torch.float32, O,
                                 aligned=aligned).numpy()
    pallas, gather = _jax_vjp(fmap, ROIS, cot, O, aligned)
    plain = _roi_align_plain_bwd(_t(cot), _t(ROIS), H, W, torch.float32, O,
                                 aligned=aligned).numpy()
    scale = np.abs(pallas).max()
    assert got.shape == (B, H, W, C)
    assert np.abs(got - pallas).max() <= 1e-5 * scale
    assert np.abs(got - gather).max() <= 1e-5 * scale
    assert np.abs(got - plain).max() <= 1e-5 * scale
    # the wholly outside ROI adds nothing: dropping it changes no bit
    keep = [r for r in range(6) if r != 4]
    got5 = _roi_align_bwd_ordered(_t(cot[:, keep]), _t(ROIS[:, keep]), H, W,
                                  torch.float32, O, aligned=aligned).numpy()
    np.testing.assert_array_equal(got5[0], got[0])


@pytest.mark.parametrize("R", [9, 13])
def test_bwd_ordered_across_chunks_scale_and_bf16(rng, R):
    """R past one chunk and not a multiple of it, spatial_scale 1/16 and
    7x7 bins as the model calls it; then a bf16 cotangent: the result in
    bf16 within 2 bf16 ulp of the f32 gradient on the same inputs."""
    B, H, W, C = 2, 8, 10, 16
    rois = _rois(rng, B, R, 16 * 10)
    cot = rng.randn(B, R, 7, 7, C).astype(np.float32)
    fmap = rng.rand(B, H, W, C).astype(np.float32)
    got = _roi_align_bwd_ordered(_t(cot), _t(rois), H, W, torch.float32, 7,
                                 spatial_scale=1 / 16).numpy()
    pallas, _ = _jax_vjp(fmap, rois, cot, 7, True, spatial_scale=1 / 16)
    plain = _roi_align_plain_bwd(_t(cot), _t(rois), H, W, torch.float32, 7,
                                 spatial_scale=1 / 16).numpy()
    scale = np.abs(pallas).max()
    assert np.abs(got - pallas).max() <= 1e-5 * scale
    assert np.abs(got - plain).max() <= 1e-5 * scale

    cot16 = torch.from_numpy(cot).to(torch.bfloat16)
    got16 = _roi_align_bwd_ordered(cot16, _t(rois), H, W, torch.bfloat16, 7,
                                   spatial_scale=1 / 16)
    assert got16.dtype == torch.bfloat16
    ref = _roi_align_plain_bwd(cot16.float(), _t(rois), H, W, torch.float32,
                               7, spatial_scale=1 / 16).numpy()
    bound = 2 * 2.0 ** -8 * np.abs(ref).max()
    assert np.abs(got16.float().numpy() - ref).max() <= bound


def test_bwd_ordered_generic_sampling_ratio(rng):
    """A sampling ratio that is not a power of two (1 / S² rounds), out_size
    4, unaligned: the generic instance's arithmetic."""
    B, H, W, C = 2, 12, 14, 8
    cot = rng.randn(B, 6, 4, 4, C).astype(np.float32)
    fmap = rng.rand(B, H, W, C).astype(np.float32)
    got = _roi_align_bwd_ordered(_t(cot), _t(ROIS), H, W, torch.float32, 4,
                                 sampling_ratio=3, aligned=False).numpy()
    pallas, _ = _jax_vjp(fmap, ROIS, cot, 4, False, sampling_ratio=3)
    assert np.abs(got - pallas).max() <= 1e-5 * np.abs(pallas).max()


def test_bwd_autograd_on_cpu_launches_nothing(rng):
    """On CPU tensors roi_align_cuda's backward is the plain version, and
    neither backward kernel's counter moves; no gradient reaches the
    ROIs."""
    fmap = _t(rng.rand(2, 12, 14, 8).astype(np.float32)).requires_grad_()
    rois = _t(ROIS).requires_grad_()
    cot = _t(rng.randn(2, 6, 7, 7, 8).astype(np.float32))
    before = counts()
    roi_align_cuda(fmap, rois, 7, spatial_scale=0.5).backward(cot)
    want = _roi_align_plain_bwd(cot, _t(ROIS), 12, 14, torch.float32, 7,
                                spatial_scale=0.5)
    assert torch.equal(fmap.grad, want)
    assert rois.grad is None
    assert counts() == before
