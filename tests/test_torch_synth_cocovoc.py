"""The port's COCO/VOC stand-in generator
(``fgn_torch/tools/make_synthetic_cocovoc.py``) against the JAX package's
``tools/make_synthetic_cocovoc.py``, and ``fgn_torch/utils/io.py::image_size``
against the JAX package's, on the CPU.

Both tools write their trees into one temporary directory from the same seed
at ``coco_train=36, coco_val=8, voc_train=8, voc_val=6, seed=8``. This host
has one OpenCV for both, so every file of the two trees (JPEGs, JSON, XML,
palette PNGs, ImageSets and the ``cache_roots``' ``COCOCats.json``) is equal
byte for byte. Tolerance: none. The port's parsers over the port's files
then give the JAX parsers' results over the JAX files, and the VOC audit
catches exactly the two images the tool plants. The tree's polygons decode
to at least their area, and ``chip_smoke.polygon_coverage`` (the card's
check of polygons against their masks) holds on this host's OpenCV.
"""

import os
import shutil
import subprocess
import sys

import pytest

from fgn_tpu.data import coco as j_coco
from fgn_tpu.data import voc as j_voc
from fgn_tpu.utils.io import image_size as j_image_size
from fgn_torch.data import coco as t_coco
from fgn_torch.data import voc as t_voc
from fgn_torch.data.digests import digest
from fgn_torch.tools import make_synthetic_cocovoc as t_tool
from fgn_torch.utils.io import image_size, read_json
from tools import make_synthetic_cocovoc as j_tool

SIZES = dict(coco_train=36, coco_val=8, voc_train=8, voc_val=6, seed=8)
# the subtrees of one generated tree, each compared as one case
PARTS = ("COCO/train2017", "COCO/val2017", "COCO/annotations",
         "VOC/JPEGImages", "VOC/Annotations", "VOC/SegmentationObject",
         "VOC/SegmentationClass", "VOC/ImageSets/Segmentation",
         "coco_cache", "voc_cache")


def _make(tool, root):
    tool.make_all(
        coco_root=os.path.join(root, "COCO"),
        voc_root=os.path.join(root, "VOC"),
        cache_roots=(os.path.join(root, "coco_cache"),
                     os.path.join(root, "voc_cache")),
        **SIZES)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """{"t": the port's tree, "j": the JAX tool's}; removed at the end."""
    tmp = tmp_path_factory.mktemp("synth_cocovoc")
    out = {}
    for side, tool in (("t", t_tool), ("j", j_tool)):
        out[side] = str(tmp / side)
        _make(tool, out[side])
    yield out
    shutil.rmtree(tmp, ignore_errors=True)


def _listing(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_same_file_list(trees):
    got, want = _listing(trees["t"]), _listing(trees["j"])
    assert got == want
    assert {p.split(os.sep)[0] for p in got} == {
        "COCO", "VOC", "coco_cache", "voc_cache"}


@pytest.mark.parametrize("part", PARTS)
def test_files_equal_byte_for_byte(trees, part):
    t, j = (os.path.join(trees[s], part) for s in ("t", "j"))
    names = sorted(os.listdir(j))
    assert names and sorted(os.listdir(t)) == names
    for name in names:
        with open(os.path.join(t, name), "rb") as a, \
                open(os.path.join(j, name), "rb") as b:
            assert a.read() == b.read(), f"{part}/{name}"


def test_counts_as_asked(trees):
    root = trees["t"]
    assert len(os.listdir(os.path.join(root, "COCO", "train2017"))) == 36
    assert len(os.listdir(os.path.join(root, "COCO", "val2017"))) == 8
    assert len(os.listdir(os.path.join(root, "VOC", "JPEGImages"))) == 14
    cats = read_json(os.path.join(root, "coco_cache", "COCOCats.json"))
    assert len(cats) == 80 and {int(k) for k in cats} == {
        cid for cid, _ in t_tool.COCO_CATEGORIES}


@pytest.mark.parametrize("subset", ["train", "val"])
def test_cocods_equal(trees, subset, tmp_path):
    ds = [mod.COCODS(imgs_set=subset, root=str(tmp_path / side),
                     coco_root=os.path.join(trees[side], "COCO"))
          for side, mod in (("t", t_coco), ("j", j_coco))]
    t, j = ds
    assert len(t) == len(j) > 0 and t.num_cats == j.num_cats == 80
    assert t.cats_names_to_new_cats_ids == j.cats_names_to_new_cats_ids
    for i in range(len(t)):
        assert digest(t[i]) == digest(j[i])


def test_voc_audit_equal(trees, tmp_path):
    parsers = [mod.VOCDSParse("train", voc_root=os.path.join(trees[side], "VOC"),
                              root=str(tmp_path / side))
               for side, mod in (("t", t_voc), ("j", j_voc))]
    t, j = parsers
    assert t.get_excluded() == j.get_excluded()
    # the tool plants two inconsistent train images: a phantom XML box and
    # a wrong XML class
    assert len(t.get_excluded()) == 2
    assert t.count_stats() == j.count_stats()
    assert digest(t.get_results()) == digest(j.get_results())


@pytest.mark.parametrize("path", [
    "COCO/train2017/000000000001.jpg", "VOC/SegmentationClass/2012_000002.png",
    "VOC/JPEGImages/2012_000002.jpg"])
def test_image_size_as_jax(trees, path):
    fp = os.path.join(trees["t"], path)
    assert image_size(fp) == j_image_size(fp)
    assert image_size(fp) in ((640, 480), (500, 375), (375, 500))


@pytest.mark.parametrize("module", [
    "fgn_torch.tools.make_synthetic_cocovoc",
    "fgn_torch.tools.export_pretrained_pth",
    "fgn_torch.tools.diagnose_detector",
    "fgn_torch.tools.eval_cat_shuffle",
    "fgn_torch.utils.io",
])
def test_imports_no_jax(module):
    """Importing the module (and running its ``--help``) leaves JAX and the
    JAX package out of ``sys.modules``."""
    code = (
        "import runpy, sys\n"
        f"import {module}\n"
        "sys.argv = ['x', '--help']\n"
        "try:\n"
        f"    runpy.run_module({module!r}, run_name='__main__')\n"
        "except SystemExit:\n"
        "    pass\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'fgn_tpu', 'tools')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("clean")


def _supportless(ds):
    return [(int(p), int(c)) for p, c in ds.qrys_children
            if not len(ds.cats_insts_list[int(c)])]


@pytest.mark.parametrize("which", ["stage1_eval", "finetune_train"])
def test_supportless_children_as_jax(trees, which, tmp_path):
    """The (query, category) children whose category has no support
    instance, from which an episode raises in ``get_support``: at these
    sizes both packages' COCO2VOC datasets have the same ones (the stand-in
    of ``chip_smoke.py`` is sized so the card's data has none)."""
    from fgn_tpu.data import fst_bindings as j_bind
    from fgn_torch.config import Config
    from fgn_torch.data import fst_bindings as t_bind

    configs = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "fgn_torch", "configs")
    got = {}
    for side, bind in (("t", t_bind), ("j", j_bind)):
        root = trees[side]

        def cfg(d, origin, **kw):
            return dict(d, root=str(tmp_path / side), coco_root=os.path.join(
                root, "COCO"), voc_root=os.path.join(root, "VOC"),
                inner_root=os.path.join(root, f"{origin.lower()}_cache"), **kw)

        if which == "stage1_eval":
            c = Config.from_file(os.path.join(
                configs, "fgn_train_coco2voc_synth.py"))
            ds = bind.init_ds_class_by_config(cfg(c.eval_ds_cfg0, "COCO"))
        else:
            c = Config.from_file(os.path.join(
                configs, "fgn_ft_coco2voc_synth.py"))
            ds = bind.init_ds_class_by_config(
                cfg(c.ft_ds_cfg0, "COCO", repeats=1))
            ds.merge_ds(bind.init_ds_class_by_config(cfg(c.ft_ds_cfg1, "VOC")))
        got[side] = (len(ds.qrys_children), _supportless(ds))
    assert got["t"] == got["j"]
    assert got["t"][0] > 0


@pytest.mark.parametrize("subset", ["train2017", "val2017"])
def test_polygon_area_ratios(trees, subset):
    """The tree's polygon segmentations decoded by the port's parser, over
    their ``area``: a polygon is an external contour of the mask filled
    again, so it gives the area back (the median) or more (a glyph's
    holes); at these sizes on this host no mask has a fragment whose
    contour the tool drops, so none gives less."""
    import numpy as np

    from fgn_torch.data import rle as R

    d = read_json(os.path.join(trees["t"], "COCO", "annotations",
                               f"instances_{subset}.json"))
    imgs = {im["id"]: im for im in d["images"]}
    ratios = []
    for ann in d["annotations"]:
        if isinstance(ann["segmentation"], list):
            im = imgs[ann["image_id"]]
            m = R.decode(t_coco.segmentation_to_rle(
                ann["segmentation"], im["height"], im["width"]))
            ratios.append(float(m.sum()) / ann["area"])
    assert ratios and min(ratios) >= 1.0
    assert float(np.median(ratios)) == 1.0 < max(ratios)


def test_polygon_coverage():
    """``chip_smoke.polygon_coverage`` on this host's OpenCV: every mask
    pixel its decoded polygons miss lies in a component whose contour the
    tool drops, and at its 200 scenes some masks have such pixels."""
    import chip_smoke

    n, n_missed, lo, hi = chip_smoke.polygon_coverage()
    assert n > 500 and n_missed >= 1 and lo < 1.0 < hi


@pytest.mark.parametrize("colors", [3, 256, 0])
def test_unique_colors_as_numpy(colors):
    """``VOCDSParse._unique_colors`` gives ``np.unique(..., axis=0)``'s rows
    and counts (``colors`` 0: no pixel)."""
    import numpy as np

    rng = np.random.default_rng(colors)
    px = rng.integers(0, max(colors, 1), (48, 64 if colors else 0, 3),
                      dtype=np.uint8)
    want, want_n = np.unique(px.reshape(-1, 3), axis=0, return_counts=True)
    got, got_n = t_voc.VOCDSParse._unique_colors(px, return_counts=True)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert (got == want).all() and (got_n == want_n).all()
    assert (t_voc.VOCDSParse._unique_colors(px) == want).all()
