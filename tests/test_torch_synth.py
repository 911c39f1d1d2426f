"""The port's synthetic data generator (``data/synth.py``) and raw datasets
(``data/mnistiseg.py``) against the JAX package's, at small sizes.

Both packages draw from the same global ``random`` and ``np.random`` in
this process, so each call is preceded by the same reseed; generated data
lands in separate tmp roots. Tolerance: none. Glyphs, deformations, pastes,
masks, generated file names, JPEG bytes, pickle contents and dataset items
are equal byte for byte.
"""

import os
import random

import numpy as np
import pytest

from fgn_tpu.data import mnistiseg as jm
from fgn_tpu.data import synth as js
from fgn_tpu.ops.boxes import box_iou_np as j_box_iou_np
from fgn_torch.data import mnistiseg as tm
from fgn_torch.data import synth as ts
from fgn_torch.data.digests import digest
from fgn_torch.ops.boxes import box_iou_np
from fgn_torch.utils.io import read_pkl


def both(fn_t, fn_j, *a, seed=0, **k):
    """fn_t and fn_j on the same arguments, each after the same reseed of
    Python's and numpy's global generators."""
    out = []
    for fn in (fn_t, fn_j):
        random.seed(seed)
        np.random.seed(seed)
        out.append(fn(*a, **k))
    return out


def assert_same(a, b):
    assert digest(a) == digest(b)


def test_palette_and_box_iou():
    np.testing.assert_array_equal(ts.get_palette_np(), js.get_palette_np())
    rng = np.random.RandomState(3)
    b1 = np.sort(rng.rand(7, 4) * 50, axis=1)[:, (0, 1, 2, 3)]
    b2 = np.sort(rng.rand(5, 4) * 50, axis=1)
    got = box_iou_np(b1, b2)
    assert got.dtype == np.float64 and got.shape == (7, 5)
    np.testing.assert_array_equal(got, j_box_iou_np(b1, b2))


@pytest.mark.parametrize("char,variant", [("0", 0), ("7", 3), ("A", 8),
                                          ("S", 13), ("9", 19)])
def test_render_cut_deform_resize_equal(char, variant):
    g = ts.render_glyph(char, variant)
    np.testing.assert_array_equal(g, js.render_glyph(char, variant))
    cut = ts.cut_char_img(g)
    np.testing.assert_array_equal(cut, js.cut_char_img(g))
    a, b = both(ts.deform_glyph, js.deform_glyph, cut, seed=variant)
    np.testing.assert_array_equal(a, b)
    a, b = both(ts.resize_char_img, js.resize_char_img, cut, [1.5, 2.8],
                seed=variant)
    np.testing.assert_array_equal(a, b)


def test_glyph_bank_equal():
    kw = dict(variants_per_subset={"train": 3, "val": 2, "test": 1})
    t = ts.GlyphBank(list("0123456789"), **kw)
    j = js.GlyphBank(list("0123456789"), **kw)
    assert_same(t.pools, j.pools)
    assert both(t.sample, j.sample, "train", seed=4)[0][0] == \
        both(t.sample, j.sample, "train", seed=4)[1][0]


def test_paste_mask_and_distractor_equal():
    glyph = ts.cut_char_img(ts.render_glyph("B", 1))
    outs = []
    for mod in (ts, js):
        random.seed(1)
        np.random.seed(1)
        img = np.full((256, 256, 3), 255, np.uint8)
        bboxes, colors = [], []
        for _ in range(6):
            res = mod.paste_colored_char_img(img, glyph, bboxes, colors,
                                             iou_max=0.2)
            if res is False:
                break
            img, bboxes, colors = res
        masks = [mod.get_char_mask_by_color(img, b, c)
                 for b, c in zip(bboxes, colors)]
        placed = mod.paste_distractor(img, glyph, bboxes, 256)
        outs.append((img, bboxes, colors, masks, placed))
    assert len(outs[0][1]) >= 2
    assert_same(outs[0], outs[1])


def test_get_new_shape_equal():
    for hw, t, m in (((100, 200), 480, 1333), ((100, 500), 800, 1333),
                     ((512, 512), 480, 480), ((375, 500), 800, 1333)):
        np.testing.assert_array_equal(ts.get_new_shape(*hw, t, m),
                                      js.get_new_shape(*hw, t, m))


def _tree(root):
    return {os.path.relpath(os.path.join(d, f), root): os.path.join(d, f)
            for d, _, fs in os.walk(root) for f in fs}


@pytest.mark.parametrize("name", ["MNISTISEG", "OMNIISEG"])
def test_create_and_items_equal(name, tmp_path):
    quantities = {"train": 4, "val": 3}
    roots = []
    for mod, tag in ((tm, "torch"), (jm, "jax")):
        root = str(tmp_path / tag)
        getattr(mod, name).create(root=root, quantities=dict(quantities),
                                  seed=5)
        roots.append(root)
    t_files, j_files = _tree(roots[0]), _tree(roots[1])
    assert sorted(t_files) == sorted(j_files)
    assert len([f for f in t_files if f.endswith(".jpg")]) == 7
    for rel in t_files:
        if rel.endswith(".pkl"):
            assert_same(read_pkl(t_files[rel]), read_pkl(j_files[rel]))
        else:
            with open(t_files[rel], "rb") as a, open(j_files[rel], "rb") as b:
                assert a.read() == b.read(), rel
    for subset in quantities:
        t = getattr(tm, name)(imgs_set=subset, root=roots[0])
        j = getattr(jm, name)(imgs_set=subset, root=roots[1])
        assert len(t) == len(j) == quantities[subset]
        assert (t.num_cats, t.target_size, t.max_size) == (
            j.num_cats, j.target_size, j.max_size)
        np.testing.assert_array_equal(t.mean, j.mean)
        np.testing.assert_array_equal(t.std, j.std)
        for i in range(len(t)):
            assert_same(t[i], j[i])
            assert t.img_hw(i) == j.img_hw(i)
        assert_same(t.count_mean_std(), j.count_mean_std())
