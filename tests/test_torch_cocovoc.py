"""The port's COCO and VOC parsers (``data/coco.py``, ``data/voc.py``), their
episodic bindings and ``check_dir`` against the JAX package's, on a small
COCO/VOC-format stand-in made by ``tools/make_synthetic_cocovoc.py``.

Each package parses the same raw files into its own cache roots. Episodes
are drawn after the same reseed of Python's and numpy's global generators
on both sides. Tolerance: none. Compact caches, parse results, audits,
statistics, evidence renders, RLEs, dataset items, episodes, AR groups and
the corrupt-file report are equal byte for byte.
"""

import os
import random

import cv2
import numpy as np
import pytest

from fgn_tpu.data import check_corrupt as j_cc
from fgn_tpu.data import coco as j_coco
from fgn_tpu.data import fst_bindings as j_bind
from fgn_tpu.data import voc as j_voc
from fgn_torch.data import check_corrupt as t_cc
from fgn_torch.data import coco as t_coco
from fgn_torch.data import fst_bindings as t_bind
from fgn_torch.data import voc as t_voc
from fgn_torch.data.digests import digest
from fgn_torch.utils.io import read_json, read_pkl
from tools.make_synthetic_cocovoc import make_all

SIDES = (("t", t_coco, t_voc, t_bind), ("j", j_coco, j_voc, j_bind))


@pytest.fixture(scope="module")
def syn(tmp_path_factory):
    root = tmp_path_factory.mktemp("cocovoc")
    make_all(
        coco_root=str(root / "COCO"),
        voc_root=str(root / "VOCdevkit" / "VOC2012"),
        coco_train=36, coco_val=8, voc_train=8, voc_val=6, seed=8,
        cache_roots=[str(root / side / c) for side, *_ in SIDES
                     for c in ("coco_cache", "voc_cache")],
    )
    return root


def _files(root):
    return {f: os.path.join(root, f) for f in sorted(os.listdir(root))
            if os.path.isfile(os.path.join(root, f))}


def _same_files(a, b):
    fa, fb = _files(a), _files(b)
    assert sorted(fa) == sorted(fb)
    for name in fa:
        if name.endswith(".pkl"):
            assert digest(read_pkl(fa[name])) == digest(read_pkl(fb[name]))
        elif name.endswith(".json"):
            assert read_json(fa[name]) == read_json(fb[name])
        else:
            with open(fa[name], "rb") as x, open(fb[name], "rb") as y:
                assert x.read() == y.read(), name


def test_rle_conversions_equal():
    rng = np.random.RandomState(0)
    polys = [[3, 4, 50, 10, 40, 60.5, 10, 40], [1, 1, 2, 2]]
    assert t_coco.polygons_to_rle(polys, 64, 70) == \
        j_coco.polygons_to_rle(polys, 64, 70)
    mask = (rng.rand(20, 30) > 0.6).astype(np.uint8)
    from fgn_torch.data import rle as R

    comp = R.encode(mask)
    runs = R.mask_to_counts(mask).tolist()
    for seg in (polys, {"size": [20, 30], "counts": runs},
                {"size": [20, 30], "counts": comp["counts"]},
                {"size": [20, 30], "counts": comp["counts"].decode()}):
        assert t_coco.segmentation_to_rle(seg, 20, 30) == \
            j_coco.segmentation_to_rle(seg, 20, 30)


def test_filter_coco_anns_equal(syn):
    data = read_json(str(syn / "COCO" / "annotations" /
                         "instances_train2017.json"))
    imgs = {img["id"]: img for img in data["images"]}
    by_img = {}
    for ann in data["annotations"]:
        by_img.setdefault(ann["image_id"], []).append(ann)
    by_img[next(iter(imgs))].append({"bbox": [0, 0, 0.5, 9], "ignore": 0})
    got = t_coco.filter_coco_anns(imgs, by_img, verbose=False)
    assert got == j_coco.filter_coco_anns(imgs, by_img, verbose=False)
    assert len(got) == len(imgs)


@pytest.mark.parametrize("subset", ["train", "val"])
def test_cocods_equal(syn, subset):
    ds = [mod.COCODS(imgs_set=subset, root=str(syn / side / "coco_cache"),
                     coco_root=str(syn / "COCO"))
          for side, mod, _, _ in SIDES]
    _same_files(*(d.root for d in ds))
    t, j = ds
    assert len(t) == len(j) > 0 and t.num_cats == j.num_cats == 80
    assert t.cats_names_to_new_cats_ids == j.cats_names_to_new_cats_ids
    for i in range(0, len(t), 3):
        assert digest(t[i]) == digest(j[i])
        assert t.img_hw(i) == j.img_hw(i)


def test_voc_parse_audit_and_vocds_equal(syn, tmp_path):
    np.testing.assert_array_equal(t_voc.voc_colormap(), j_voc.voc_colormap())
    voc_root = str(syn / "VOCdevkit" / "VOC2012")
    parsers = [mod.VOCDSParse("train", voc_root=voc_root,
                              root=str(tmp_path / side))
               for side, _, mod, _ in SIDES]
    t, j = parsers
    assert t.get_excluded() == j.get_excluded()
    assert len(t.get_excluded()) >= 1  # the tool plants inconsistent images
    assert t.count_stats() == j.count_stats()
    for i in range(len(t.ids)):
        assert digest(t.get_ann_data_entry(i)) == digest(j.get_ann_data_entry(i))
    assert digest(t.get_results()) == digest(j.get_results())
    n = [p.dump_evidence(str(tmp_path / f"ev_{side}"))
         for (side, *_), p in zip(SIDES, parsers)]
    assert n[0] == n[1] >= 1
    _same_files(str(tmp_path / "ev_t"), str(tmp_path / "ev_j"))
    _same_files(str(tmp_path / "t"), str(tmp_path / "j"))

    ds = [mod.VOCDS(imgs_set="val", root=str(syn / side / "voc_cache"),
                    voc_root=voc_root, coco_root=str(syn / "COCO"))
          for side, _, mod, _ in SIDES]
    _same_files(*(d.root for d in ds))
    assert len(ds[0]) == len(ds[1]) > 0
    for i in range(len(ds[0])):
        assert digest(ds[0][i]) == digest(ds[1][i])


def _cfg(syn, side, **kw):
    cfg = dict(
        n_ways=3, k_shots=2, ds_base_="COCO", ds_base__subset="train",
        ds_novel="VOC", ds_novel_subset="val", sampling_origin_ds="COCO",
        sampling_origin_ds_subset="train", sampling_cats="base_",
        augment_qry=True, augment_spp=True, qry_mask_scale=4,
        sampling_scenario="parents", shuffle=True, batch=4,
        qry_cats_choice_random=True, qry_cats_order_shuffle=True,
        finetune="Ignore", root=str(syn / side / "fst"),
        coco_root=str(syn / "COCO"),
        voc_root=str(syn / "VOCdevkit" / "VOC2012"),
    )
    cfg.update(kw)
    cfg.setdefault("inner_root", str(syn / side / (
        "voc_cache" if cfg["sampling_origin_ds"] == "VOC" else "coco_cache")))
    return cfg


@pytest.mark.parametrize("kw,n", [
    (dict(), 4),
    (dict(sampling_origin_ds="VOC", sampling_origin_ds_subset="train",
          sampling_cats="all", n_ways=2, k_shots=1), 4),
    # FT=Use on six val images leaves categories without supports: the
    # databag, the flags and the order only
    (dict(sampling_origin_ds="VOC", sampling_origin_ds_subset="val",
          sampling_cats="novel", finetune="Use", n_ways=2, k_shots=1), 0),
], ids=["coco", "voc_ar_groups", "voc_use"])
def test_fewshot_bindings_equal(syn, kw, n):
    ds = [bind.init_ds_class_by_config(_cfg(syn, side, **kw))
          for side, _, _, bind in SIDES]
    t, j = ds
    assert type(t).__name__ == type(j).__name__
    assert (t.augment_qry, t.augment_spp) == (j.augment_qry, j.augment_spp)
    assert digest([t.qrys_parents_, t.insts, t.cats_insts_list]) == \
        digest([j.qrys_parents_, j.insts, j.cats_insts_list])
    np.testing.assert_array_equal(t.cats_novel, j.cats_novel)
    for e in (None, 0, 5):
        for d in ds:
            if e is not None:
                d.reshuffle(e)
        np.testing.assert_array_equal(t.order, j.order)
        assert t._group_hw == j._group_hw
        eps = []
        for d in ds:
            out = []
            for i in range(min(n, len(d))):
                random.seed(i)
                np.random.seed(i)
                out.append(d[i])
            eps.append(out)
        assert digest(eps[0]) == digest(eps[1])
    if kw.get("sampling_cats") == "all":  # VOC mixes 375x500 and 500x375
        assert len(set(t._group_hw.values())) == 2


def test_check_dir_equal(tmp_path):
    d = tmp_path / "imgs"
    d.mkdir()
    img = np.full((16, 16, 3), 128, np.uint8)
    cv2.imwrite(str(d / "good.jpg"), img)
    cv2.imwrite(str(d / "good.png"), img)
    (d / "truncated.jpg").write_bytes(b"\xff\xd8\xff\xe0junk")
    (d / "empty.jpg").write_bytes(b"")
    got = t_cc.check_dir(str(d), verbose=False)
    assert got == j_cc.check_dir(str(d), verbose=False)
    assert {n for n, _ in got} == {"truncated.jpg", "empty.jpg"}
