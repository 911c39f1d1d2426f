"""The port's host-side evaluation modules against the JAX package's, on
the same seeded numpy inputs: RLE (native and numpy paths), FSISEGEval,
the mask pastes, ``collate_episodes``, the area resample of gt masks, and
``EpisodeLoader``.

Tolerances: RLE bytes, FSISEGEval metrics, the numpy pastes, the area
resample and collated batches equal (both packages resample a gt mask
whose size is not a multiple of the mask grid with
``cv2.resize(INTER_AREA)``); the torch paste within 1e-6 of the JAX paste.
"""

import subprocess
import sys
import threading
import time

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgn_tpu.data import rle as JR
from fgn_tpu.data.batching import collate_episodes as j_collate
from fgn_tpu.data.fsisegeval import FSISEGEval as JFSISEGEval
from fgn_tpu.ops.mask_paste import paste_masks as j_paste
from fgn_tpu.ops.mask_paste import paste_masks_np as j_paste_np
from fgn_tpu.train.evaluator import _paste_batch_packed as j_paste_packed
from fgn_tpu.train.train_step import unpack_eval_out as j_unpack
from fgn_torch.data import rle as R
from fgn_torch.data.batching import (
    EpisodeLoader, _downsample_mask, collate_episodes, from_numpy,
)
from fgn_torch.data.fsisegeval import FSISEGEval
from fgn_torch.ops.boxes import xyxy_to_yxyx
from fgn_torch.ops.mask_paste import paste_masks, paste_masks_np
from fgn_torch.train.evaluator import _paste_batch, _paste_batch_packed
from fgn_torch.train.train_step import unpack_eval_out, unpack_eval_out_np


@pytest.fixture(params=["native", "numpy"])
def backend(request, monkeypatch):
    """Each RLE test on both paths of the port."""
    if request.param == "numpy":
        monkeypatch.setattr(R, "_native", lambda: None)
    assert R.backend() == request.param
    return request.param


def _masks(seed, shapes=((1, 1), (7, 5), (64, 64), (33, 17), (8, 8))):
    rng = np.random.RandomState(seed)
    out = [(rng.rand(h, w) < p).astype(np.uint8)
           for h, w in shapes for p in (0.3, 0.9)]
    return out + [np.zeros((8, 8), np.uint8), np.ones((8, 8), np.uint8),
                  np.eye(3, dtype=np.uint8)]


# -- RLE --------------------------------------------------------------------


def test_rle_encode_decode_area_bbox(backend):
    for m in _masks(0):
        r, jr = R.encode(m), JR.encode(m)
        assert r == jr
        assert r["counts"] == JR._compress_counts(JR.mask_to_counts(m))
        np.testing.assert_array_equal(R.decode(r), m)
        np.testing.assert_array_equal(R.decode(dict(r, counts=r["counts"].decode())), m)
        assert R.area(r) == JR.area(jr) == int(m.sum())
        np.testing.assert_array_equal(R.to_bbox(r), JR.to_bbox(jr))


def test_rle_counts_form():
    m = np.array([[0, 1], [0, 0]], np.uint8)
    assert R.mask_to_counts(m).tolist() == [2, 1, 1]
    np.testing.assert_array_equal(
        R.decode({"size": [2, 2], "counts": [2, 1, 1]}), m)


def test_rle_merge_iou_crowd(backend):
    rng = np.random.RandomState(1)
    ms = [(rng.rand(30, 20) < 0.4).astype(np.uint8) for _ in range(5)]
    rles, jrles = [R.encode(m) for m in ms], [JR.encode(m) for m in ms]
    for inter in (False, True):
        assert R.merge(rles, intersect=inter) == JR.merge(jrles, intersect=inter)
    crowd = [0, 1, 0]
    np.testing.assert_array_equal(R.iou(rles[:2], rles[2:], crowd),
                                  JR.iou(jrles[:2], jrles[2:], crowd))
    assert R.iou([], rles[2:], crowd).shape == (0, 3)
    a = np.zeros((10, 10), np.uint8)
    a[:5] = 1
    g = np.ones((10, 10), np.uint8)
    assert np.allclose(R.iou([R.encode(a)], [R.encode(g)], [1]), 1.0)
    assert np.allclose(R.iou([R.encode(a)], [R.encode(g)], [0]), 0.5)


def test_rle_encode_mask_results(backend):
    stack = np.stack(_masks(2, shapes=((9, 11),))[:2])
    assert R.encode_mask_results(stack) == JR.encode_mask_results(stack)


PASTE_BOXES = np.array([
    [3.2, 5.1, 40.9, 60.3],
    [0.0, 0.0, 122.9, 96.9],     # full canvas
    [-10.0, -5.0, 30.0, 20.0],   # clipped at origin
    [100.0, 80.0, 200.0, 150.0],  # clipped at far edge
    [50.0, 50.0, 50.0, 50.0],    # degenerate
    [30.5, 40.5, 31.5, 41.5],    # tiny
], np.float32)


def test_paste_encode_native_equals_numpy_paste():
    assert R.backend() == "native"
    rng = np.random.RandomState(3)
    H, W = 97, 123
    probs = rng.rand(len(PASTE_BOXES), 14, 14).astype(np.float32)
    out = R.paste_encode_results(probs, PASTE_BOXES, H, W, 0.5)
    want = paste_masks_np(probs, PASTE_BOXES, 128, 128, 0.5)[:, :H, :W]
    assert out == R.encode_mask_results(want)
    assert out == JR.paste_encode_results(probs, PASTE_BOXES, H, W, 0.5)
    assert R.paste_encode_results(np.zeros((0, 14, 14), np.float32),
                                  np.zeros((0, 4), np.float32), 32, 32) == []


def test_paste_encode_absent_on_numpy(backend):
    got = R.paste_encode_results(np.zeros((1, 14, 14), np.float32),
                                 PASTE_BOXES[:1], 32, 32)
    assert (got is None) == (backend == "numpy")


# -- FSISEGEval -------------------------------------------------------------


def _mask(h, w, y1, x1, y2, x2):
    m = np.zeros((h, w), np.uint8)
    m[y1:y2, x1:x2] = 1
    return m


def _result(gt_boxes, gt_cats, dt_boxes, dt_cats, dt_scores, hw=(64, 64)):
    """Boxes YXYX; masks are the boxes' rectangles."""
    h, w = hw
    return {
        "qry_img_shape": np.array([h, w, 3]),
        "qry_bboxes": np.asarray(gt_boxes, np.float32).reshape(-1, 4),
        "qry_cat_ids": np.asarray(gt_cats, np.int64),
        "qry_isegmaps_rle": [
            JR.encode(_mask(h, w, *np.asarray(b, int))) for b in gt_boxes],
        "dt_bboxes": np.asarray(dt_boxes, np.float32).reshape(-1, 4),
        "dt_cat_ids": np.asarray(dt_cats, np.int64),
        "dt_scores": np.asarray(dt_scores, np.float32),
        "dt_isegmaps_rle": [
            JR.encode(_mask(h, w, *np.asarray(b, int))) for b in dt_boxes],
    }


def _random_results(seed, n=12, n_ways=3):
    rng = np.random.RandomState(seed)
    res = []
    for _ in range(n):
        def boxes(k):
            y1, x1 = rng.randint(0, 40, (2, k))
            return np.stack([y1, x1, y1 + rng.randint(4, 24, k),
                             x1 + rng.randint(4, 24, k)], 1)
        g, d = rng.randint(0, 4), rng.randint(0, 8)
        gt = boxes(g)
        dt = np.concatenate([gt + rng.randint(-3, 4, gt.shape), boxes(d)])
        dt = np.clip(dt, 0, 64)
        res.append(_result(gt, rng.randint(0, n_ways, g), dt,
                           rng.randint(0, n_ways, len(dt)),
                           rng.rand(len(dt)).round(2)))
    return res


L_GT = np.zeros((32, 32), np.uint8)
L_GT[4:20, 4:8] = 1
L_GT[16:20, 4:20] = 1

FSISEG_CASES = {
    "perfect": ([_result([[4, 4, 20, 20], [30, 30, 50, 50]], [0, 1],
                         [[4, 4, 20, 20], [30, 30, 50, 50]], [0, 1],
                         [0.9, 0.8])], 3),
    "no_detections": ([_result([[4, 4, 20, 20]], [0], np.zeros((0, 4)), [],
                               [])], 3),
    "wrong_class": ([_result([[4, 4, 20, 20]], [0], [[4, 4, 20, 20]], [1],
                             [0.9])], 3),
    "low_iou": ([_result([[0, 0, 10, 10]], [0], [[0, 8, 10, 18]], [0],
                         [0.9])], 3),
    "duplicate": ([_result([[4, 4, 24, 24]], [0],
                           [[4, 4, 24, 24], [5, 5, 25, 25]], [0, 0],
                           [0.9, 0.8])], 3),
    "missed_gt": ([_result([[4, 4, 24, 24], [40, 40, 60, 60]], [0, 0],
                           [[4, 4, 24, 24]], [0], [0.9])], 3),
    "score_order": ([_result([[4, 4, 24, 24]], [0],
                             [[40, 40, 60, 60], [4, 4, 24, 24]], [0, 0],
                             [0.9, 0.8])], 3),
    "two_images": ([_result([[4, 4, 24, 24]], [0], [[4, 4, 24, 24]], [0],
                            [0.9]),
                    _result([[4, 4, 24, 24]], [0], np.zeros((0, 4)), [],
                            [])], 3),
    "segm_l_shape": ([dict(_result([[4, 4, 20, 20]], [0], [[4, 4, 20, 20]],
                                   [0], [0.9], hw=(32, 32)),
                           qry_isegmaps_rle=[JR.encode(L_GT)])], 1),
    "hand_101pt": ([_result(
        [[0, 0, 10, 10], [20, 20, 30, 30], [40, 40, 50, 50]], [0, 0, 0],
        [[0, 0, 10, 10], [0, 40, 10, 50], [20, 20, 30, 30],
         [40, 40, 50, 50]], [0, 0, 0, 0], [0.9, 0.8, 0.7, 0.6])], 1),
    "random": (_random_results(5), 3),
}


@pytest.mark.parametrize("iou_type", ["bbox", "segm"])
@pytest.mark.parametrize("case", sorted(FSISEG_CASES))
def test_fsisegeval_equals_jax(case, iou_type):
    res, n_ways = FSISEG_CASES[case]
    got = FSISEGEval(results=res, n_ways=n_ways, iou_type=iou_type).run()
    want = JFSISEGEval(results=res, n_ways=n_ways, iou_type=iou_type).run()
    assert got == want
    if case == "hand_101pt" and iou_type == "bbox":
        assert abs(got["mAP"] - (34 + 67 * 0.75) / 101) < 1e-9


def test_fsisegeval_reads_pickle_dir(tmp_path):
    from fgn_torch.utils.io import write_pkl_unsafe

    res = FSISEG_CASES["random"][0]
    write_pkl_unsafe(str(tmp_path / "chunk_00000.pkl"), res[:5])
    write_pkl_unsafe(str(tmp_path / "chunk_00001.pkl"), res[5:])
    for iou_type in ("bbox", "segm"):
        got = FSISEGEval(results_pkl_dir_fp=str(tmp_path), n_ways=3,
                         iou_type=iou_type).run()
        assert got == JFSISEGEval(results=res, n_ways=3,
                                  iou_type=iou_type).run()


# -- pastes -----------------------------------------------------------------


def _paste_case(seed, n=6, m=14, H=96, W=128):
    rng = np.random.RandomState(seed)
    probs = rng.rand(n, m, m).astype(np.float32)
    x1 = rng.uniform(-10, W - 20, n)
    y1 = rng.uniform(-10, H - 20, n)
    boxes = np.stack([x1, y1, x1 + rng.uniform(4, 60, n),
                      y1 + rng.uniform(4, 60, n)], -1).astype(np.float32)
    boxes[0] = (-30, -30, -5, -5)  # entirely outside
    return probs, boxes


@pytest.mark.parametrize("threshold", [0.5, None])
def test_paste_masks_np_equals_jax(threshold):
    probs, boxes = _paste_case(0)
    got = paste_masks_np(probs, boxes, 96, 128, threshold=threshold)
    np.testing.assert_array_equal(
        got, j_paste_np(probs, boxes, 96, 128, threshold=threshold))
    assert paste_masks_np(probs[:0], boxes[:0], 9, 9).shape == (0, 9, 9)


def test_paste_masks_torch_within_1e6_of_jax():
    probs, boxes = _paste_case(1)
    want = np.asarray(j_paste(jnp.asarray(probs), jnp.asarray(boxes), 96, 128,
                              threshold=None))
    got = paste_masks(torch.from_numpy(probs), torch.from_numpy(boxes), 96,
                      128, threshold=None)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    bools = paste_masks(torch.from_numpy(probs), torch.from_numpy(boxes), 96,
                        128, threshold=0.5).numpy()
    far = np.abs(want - 0.5) > 1e-6
    np.testing.assert_array_equal(bools[far], (want > 0.5)[far])


def test_paste_batch_packed():
    """The device paste of a batch: bits as ``np.packbits`` packs them, on
    a width that is not a multiple of 8, and JAX's packed paste."""
    rng = np.random.RandomState(2)
    logits = rng.randn(2, 3, 14, 14).astype(np.float32) * 3
    boxes = _paste_case(3, n=6, H=40, W=61)[1].reshape(2, 3, 4)
    full = _paste_batch(torch.from_numpy(logits), torch.from_numpy(boxes),
                        40, 61, 0.5).numpy()
    packed = _paste_batch_packed(torch.from_numpy(logits),
                                 torch.from_numpy(boxes), 40, 61, 0.5).numpy()
    assert packed.dtype == np.uint8 and packed.shape == (2, 3, 40, 8)
    np.testing.assert_array_equal(packed, np.packbits(full, axis=-1))
    np.testing.assert_array_equal(
        np.unpackbits(packed, axis=-1, count=61).astype(bool), full)
    want = np.unpackbits(np.asarray(j_paste_packed(logits, boxes, 40, 61, 0.5)),
                         axis=-1, count=61).astype(bool)
    probs = paste_masks(torch.sigmoid(torch.from_numpy(logits)).reshape(6, 14, 14),
                        torch.from_numpy(boxes).reshape(6, 4), 40, 61,
                        threshold=None).numpy().reshape(full.shape)
    # bits may differ only where the probability is at the threshold
    assert not ((full != want) & (np.abs(probs - 0.5) > 1e-6)).any()


def test_unpack_eval_out_forms():
    rng = np.random.RandomState(4)
    pack = np.concatenate([rng.rand(2, 5, 5).astype(np.float32),
                           rng.randint(0, 3, (2, 5, 1)).astype(np.float32),
                           (rng.rand(2, 5, 1) > 0.5).astype(np.float32)], -1)
    logits = rng.randn(2, 5, 14, 14).astype(np.float32)
    out = {"dt_pack": pack, "dt_mask_logits": logits}
    got = unpack_eval_out_np(out)
    want = j_unpack(out)
    tgot = unpack_eval_out({k: torch.from_numpy(v) for k, v in out.items()})
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(tgot[k].numpy(), want[k])
    np.testing.assert_array_equal(xyxy_to_yxyx(pack[..., :4]),
                                  pack[..., :4][..., (1, 0, 3, 2)])


# -- collation and the loader -----------------------------------------------


def _sample(rng, idx, hw, n_inst, N=3, K=2, S=32):
    h, w = hw
    boxes, masks = [], []
    for _ in range(n_inst):
        y1, x1 = rng.randint(0, h // 2), rng.randint(0, w // 2)
        y2, x2 = y1 + rng.randint(4, h // 2), x1 + rng.randint(4, w // 2)
        m = np.zeros((h, w), np.uint8)
        m[y1:y2, x1:x2] = rng.rand(y2 - y1, x2 - x1) > 0.2
        boxes.append([y1, x1, y2, x2])
        masks.append(m)
    cats = rng.randint(0, N, n_inst)
    return {
        "idx": idx,
        "qry_child_idx": idx + 100,
        "qry_img": rng.randint(0, 256, (h, w, 3)).astype(np.uint8),
        "qry_bboxes": np.asarray(boxes, np.float32).reshape(-1, 4),
        "qry_cat_ids": cats.astype(np.int64),
        "qry_cat_ids_real": (cats * 7 + 1).astype(np.int64),
        "qry_isegmaps": np.asarray(masks, np.uint8).reshape(-1, h, w),
        "spp_imgs": rng.randint(0, 256, (N * K, S, S, 3)).astype(np.uint8),
        "spp_bboxes": np.tile(np.array([2, 3, S - 4, S - 2], np.float32),
                              (N * K, 1)),
        "spp_isegmaps": (rng.rand(N * K, S, S) > 0.5).astype(np.float32),
        "cats_ids_to_sample_real": np.arange(N, dtype=np.int64) * 7 + 1,
        "spp_insts_ids": np.arange(N * K, dtype=np.int64) + idx,
        "img_shape": np.asarray([h, w, 3], np.int64),
    }


def _samples(seed, hws):
    rng = np.random.RandomState(seed)
    return [_sample(rng, i, hw, n_inst=i % 4)
            for i, hw in enumerate(hws)]


MEAN, STD = np.array([1.0, 2.0, 3.0]), np.array([4.0, 5.0, 6.0])


@pytest.mark.parametrize("hws,kw", [
    (((64, 64), (48, 64), (64, 32)), dict(max_gt=5)),
    (((64, 64), (48, 64)), dict(max_gt=2, pad_hw=(96, 80), pad_to_batch=4,
                                keep_gt_masks=True)),
    (((64, 64), (48, 64), (32, 32)), dict(max_gt=4, n_real=2,
                                          keep_gt_masks=True)),
    (((66, 50), (97, 123), (64, 64)), dict(max_gt=4, keep_gt_masks=True)),
    (((466, 350), (480, 352), (466, 350), (480, 480)),
     dict(max_gt=6, keep_gt_masks=True)),
], ids=["plain", "pad_to_batch", "n_real", "not_multiple_of_4", "466x350"])
def test_collate_episodes_equals_jax(hws, kw):
    samples = _samples(len(hws), hws)
    batch, meta = collate_episodes(samples, MEAN, STD, **kw)
    jbatch, jmeta = j_collate(samples, MEAN, STD, **kw)
    assert batch._fields == jbatch._fields
    for f, a, b in zip(batch._fields, batch, jbatch):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype, f
        assert a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    assert meta.n_real == jmeta.n_real
    for f, a, b in zip(meta._fields, meta, jmeta):
        if f == "n_real":
            continue
        if isinstance(b, list):
            assert len(a) == len(b), f
            for x, y in zip(a, b):
                assert (x is None and y is None) or np.array_equal(x, y), f
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)
    t = from_numpy(**batch._asdict())
    assert t.qry_img.dtype == torch.uint8 and t.qry_valid.dtype == torch.bool


@pytest.mark.parametrize("hw", [(466, 350), (97, 123), (480, 351), (35, 33),
                                (130, 64), (7, 9)])
def test_downsample_mask_matches_cv2_area(hw):
    h, w = hw
    rng = np.random.RandomState(h * w)
    masks = (rng.rand(3, h, w) > 0.5).astype(np.uint8)
    got = _downsample_mask(masks, h // 4, w // 4)
    want = np.stack([cv2.resize(m.astype(np.float32), (w // 4, h // 4),
                                interpolation=cv2.INTER_AREA) for m in masks])
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


class ListDS:
    """Samples by index, with the attributes the loader reads."""

    mean, std = MEAN, STD

    def __init__(self, n, fail_at=None, delay=0.0):
        self.samples = _samples(9, [(32, 32)] * n)
        self.fail_at, self.delay = fail_at, delay

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        if i == self.fail_at:
            raise KeyError(f"episode {i}")
        time.sleep(self.delay)
        return self.samples[i]


@pytest.mark.parametrize("n,bs,drop_last,start,want", [
    (10, 4, False, 0, [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9]]),
    (10, 4, True, 0, [[0, 1, 2, 3], [4, 5, 6, 7]]),
    (10, 4, False, 1, [[4, 5, 6, 7], [8, 9]]),
    (8, 4, False, 0, [[0, 1, 2, 3], [4, 5, 6, 7]]),
])
def test_loader_order_padding_len(n, bs, drop_last, start, want):
    loader = EpisodeLoader(ListDS(n), bs, max_gt=3, drop_last=drop_last,
                           start_batch=start, keep_gt_masks=True)
    got = list(loader)
    assert len(loader) == len(got) == len(want)
    for (batch, meta), idx in zip(got, want):
        assert meta.n_real == len(idx)
        # the short batch repeats its last sample
        pad = idx + [idx[-1]] * (bs - len(idx))
        assert meta.idx.tolist() == pad
        assert batch.qry_img.shape[0] == bs


def test_loader_worker_ends_on_early_break():
    before = threading.active_count()
    loader = EpisodeLoader(ListDS(40, delay=0.002), 2, max_gt=3, prefetch=1)
    it = iter(loader)
    next(it)
    it.close()  # the consumer breaks out
    deadline = time.monotonic() + 10
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.01)
    assert threading.active_count() == before


def test_loader_worker_exception_reaches_consumer():
    loader = EpisodeLoader(ListDS(10, fail_at=5), 2, max_gt=3)
    seen = []
    with pytest.raises(KeyError, match="episode 5"):
        for _, meta in loader:
            seen.append(meta.idx.tolist())
    assert seen == [[0, 1], [2, 3]]


def test_eval_path_imports_without_cv2():
    code = ("import sys; sys.modules['cv2'] = None; "
            "import fgn_torch.train.evaluator, fgn_torch.data.batching; "
            "assert sys.modules['cv2'] is None; print('ok')")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
