"""The port's episode engine (``data/episodic.py``, ``augment.py``,
``fs_selection.py``, ``fst_bindings.py``) against the JAX package's, on a
small MNISTISEG split generated once on the host.

Both packages read the same raw split; each keeps its databags, support
banks and selection caches under its own tmp root. Both draw from the same
global ``random`` and ``np.random``, so every episode is drawn after the
same reseed on both sides. Tolerance: none. Databags, support banks, cache
file names, orders, episodes (every field), selection JSONs, renders and
the committed reference (``fgn_torch/data/reference``, regenerated from the
JAX package) are equal byte for byte.

To remake the reference after a change of the engine (on a host with
OpenCV 5.0, as the committed one was made)::

    python -c "import tests.test_torch_episodic as t; t.write_reference()"
"""

import os
import pickle
import random
import shutil
import tempfile
from types import SimpleNamespace

import cv2
import numpy as np
import pytest

from fgn_tpu.config import Config as JConfig
from fgn_tpu.data import augment as j_augment
from fgn_tpu.data import fst_bindings as j_bind
from fgn_tpu.data.batching import collate_episodes as j_collate
from fgn_tpu.data.fs_selection import select_indices as j_select
from fgn_tpu.data.mnistiseg import MNISTISEG as JMNISTISEG
from fgn_tpu.data.synth import GlyphBank as JGlyphBank
from fgn_torch.data import augment as t_augment
from fgn_torch.data import digests as D
from fgn_torch.data import fst_bindings as t_bind
from fgn_torch.data.fs_selection import select_indices
from fgn_torch.data.mnistiseg import MNISTISEG
from fgn_torch.data.synth import get_palette_np
from fgn_torch.utils.io import read_json, read_pkl, write_pkl_unsafe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_engine():
    return SimpleNamespace(
        Config=JConfig, GlyphBank=JGlyphBank, MNISTISEG=JMNISTISEG,
        Augmenter=j_augment.Augmenter,
        init_ds_class_by_config=j_bind.init_ds_class_by_config,
        collate_episodes=j_collate)


def write_reference():
    with tempfile.TemporaryDirectory() as work:
        D.write_reference(jax_engine(), os.path.join(ROOT, "fgn_tpu"), work)


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("raw") / "mnistiseg")
    MNISTISEG.create(root=root, quantities={"train": 60, "val": 12},
                     seed=11)
    return root


def _cfg(raw, **kw):
    cfg = dict(
        n_ways=3, k_shots=1,
        ds_base_="MNISTISEG", ds_base__subset="train",
        ds_novel="MNISTISEG", ds_novel_subset="val",
        sampling_origin_ds="MNISTISEG", sampling_origin_ds_subset="train",
        sampling_cats="base_", sampling_scenario="parents",
        repeats=1, finetune="Ignore", shuffle=False,
        qry_cats_choice_random=True, inner_root=raw,
    )
    cfg.update(kw)
    return cfg


def pair(tmp_path, cfg):
    """(port's dataset, JAX package's dataset) from one config, each with
    its own cache root."""
    t = t_bind.init_ds_class_by_config(dict(cfg, root=str(tmp_path / "t")))
    j = j_bind.init_ds_class_by_config(dict(cfg, root=str(tmp_path / "j")))
    return t, j


def draw(ds, idxs, **kw):
    out = []
    for i in idxs:
        random.seed(i)
        np.random.seed(i)
        out.append(ds.__getitem__(i, **kw))
    return out


def assert_same_ds(t, j):
    assert type(t).__name__ == type(j).__name__
    assert os.path.basename(t.databag_fp) == os.path.basename(j.databag_fp)
    assert D.dataset_digests(t, "x") == D.dataset_digests(j, "x")
    assert len(t) == len(j)
    np.testing.assert_array_equal(t.order, j.order)
    np.testing.assert_array_equal(t.cats_novel, j.cats_novel)
    np.testing.assert_array_equal(t.cats_to_save, j.cats_to_save)
    assert sorted(os.listdir(t.root)) == sorted(os.listdir(j.root))
    for name in os.listdir(t.root):  # the FT selection caches
        if name.endswith(".json"):
            assert read_json(os.path.join(t.root, name)) == read_json(
                os.path.join(j.root, name))


def assert_same_episodes(t, j, n=6):
    idxs = list(range(min(n, len(t))))
    assert D.digest(draw(t, idxs)) == D.digest(draw(j, idxs))


CASES = {
    "ignore_parents": dict(),
    "ignore_parents_k3_augment": dict(k_shots=3, augment_qry=True,
                                      augment_spp=True, qry_mask_scale=4),
    "ignore_children": dict(sampling_scenario="children"),
    "novel_children_augment": dict(sampling_cats="novel",
                                   sampling_scenario="children",
                                   augment_qry=True, n_ways=2),
    "all_first_parents_repeats": dict(sampling_cats="all",
                                      first_parents__only=9, repeats=2,
                                      qry_cats_order_shuffle=True),
    "select": dict(finetune="Select",
                   delete_qry_insts_in_spp_insts_on_train=False),
    "use": dict(finetune="Use", sampling_cats="novel", n_ways=2,
                sampling_origin_ds_subset="val", augment_qry=True),
    "no_spp_bank_fixed_supports": dict(spp_bank=False, spp_random=False,
                                       qry_cats_choice_random=False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_databag_bank_and_episodes_equal(case, raw, tmp_path):
    t, j = pair(tmp_path, _cfg(raw, **CASES[case]))
    assert_same_ds(t, j)
    assert_same_episodes(t, j)


def test_select_indices_and_json_equal(tmp_path):
    rng = np.random.RandomState(4)
    counts = rng.poisson(0.6, (80, 10))
    allowed = np.zeros(10, bool)
    allowed[[0, 2, 4, 6, 8, 9]] = True
    for budget in (1, 3, 9):
        fps = [str(tmp_path / f"{tag}{budget}.json") for tag in "tj"]
        got = select_indices(counts, allowed, budget, cache_fp=fps[0], seed=2)
        want = j_select(counts, allowed, budget, cache_fp=fps[1], seed=2)
        assert got == want
        assert read_json(fps[0]) == read_json(fps[1]) == got
        # the cache answers the second call
        assert select_indices(np.zeros_like(counts), allowed, budget,
                              cache_fp=fps[0]) == got


def test_reshuffle_and_state_dict_resume(raw, tmp_path):
    t, j = pair(tmp_path, _cfg(raw, shuffle=True, batch=4))
    for e in (0, 3, 11):
        t.reshuffle(e)
        j.reshuffle(e)
        np.testing.assert_array_equal(t.order, j.order)
        assert t._group_hw == j._group_hw
    state = t.state_dict()
    t2 = t_bind.init_ds_class_by_config(
        dict(_cfg(raw, shuffle=True, batch=4), root=str(tmp_path / "t")))
    t2.load_state_dict({"order": state["order"].tolist(),
                        "group_hw": {str(k): v for k, v in
                                     state["group_hw"].items()}})
    np.testing.assert_array_equal(t2.order, j.order)
    assert D.digest(draw(t2, range(5))) == D.digest(draw(j, range(5)))


def test_replay_by_stored_ids(raw, tmp_path):
    t, j = pair(tmp_path, _cfg(raw, k_shots=2))
    first = draw(t, range(4))
    for i, s in enumerate(first):
        kw = dict(_qry_child_idx=s["qry_child_idx"],
                  _cats_ids_to_sample_real=s["cats_ids_to_sample_real"],
                  _spp_insts_ids=s["spp_insts_ids"])
        random.seed(100 + i)
        got = t.__getitem__(i, **kw)
        random.seed(200 + i)
        want = j.__getitem__(i, **kw)
        assert D.digest(got) == D.digest(want) == D.digest(s)


def test_merge_ds_equal(raw, tmp_path):
    ds = []
    for side, bind in (("t", t_bind), ("j", j_bind)):
        root = str(tmp_path / side)
        a = bind.init_ds_class_by_config(
            _cfg(raw, finetune="Select", root=root,
                 delete_qry_insts_in_spp_insts_on_train=False))
        b = bind.init_ds_class_by_config(
            _cfg(raw, finetune="Select", root=root, sampling_cats="novel",
                 sampling_origin_ds_subset="val", n_ways=2,
                 delete_qry_insts_in_spp_insts_on_train=False))
        ds.append(a.merge_ds(b))
    t, j = ds
    assert t.merged and j.merged
    assert_same_ds(t, j)
    assert_same_episodes(t, j, n=8)


def test_pickle_roundtrip_reopens_bank(raw, tmp_path):
    t, j = pair(tmp_path, _cfg(raw, k_shots=2))
    # the bank travels by path, not by value
    for k in ("imgs", "masks"):
        got = t.__getstate__()["_spp_bank"][k]
        want = j.__getstate__()["_spp_bank"][k]
        assert isinstance(got, str) and os.path.isfile(got)
        assert os.path.basename(got) == os.path.basename(want)
    t2 = pickle.loads(pickle.dumps(t))
    assert isinstance(t2._spp_bank["imgs"], np.memmap)
    assert D.digest(draw(t2, range(4))) == D.digest(draw(j, range(4)))


def test_init_ds_class_by_config_dispatch():
    assert sorted(t_bind._DS_CLASSES) == sorted(j_bind._DS_CLASSES)
    for name, cls in t_bind._DS_CLASSES.items():
        jcls = j_bind._DS_CLASSES[name]
        assert cls.__name__ == jcls.__name__
        assert cls.__module__.startswith("fgn_torch.")
        assert cls.spp_img_size == jcls.spp_img_size
    for cls in (t_bind.MNISTFewShotISEG, t_bind.OMNIFewShotISEG):
        jcls = j_bind._DS_CLASSES[cls.inner_ds_cl.__name__]
        np.testing.assert_array_equal(cls.select_cats(None),
                                      jcls.select_cats(None))


@pytest.mark.parametrize("seed", range(8))
def test_augmenter_equal(seed):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (96, 80, 3)).astype(np.uint8)
    boxes = np.array([[10, 12, 50, 60], [30, 5, 90, 40]], np.float32)
    soft = rng.rand(2, 24, 20).astype(np.float32)
    hard = rng.rand(2, 96, 80) > 0.5
    for masks, scale in ((soft, 4), (hard, 1), (None, 1)):
        got, want = [], []
        for mod, out in ((t_augment, got), (j_augment, want)):
            random.seed(seed)
            out.append(mod.Augmenter()(img, boxes, masks, mask_scale=scale))
        assert D.digest(got) == D.digest(want)


def test_visualize_and_evaluate_equal(raw, tmp_path):
    from fgn_torch.data import rle as RLE
    from fgn_torch.utils.io import write_pkl_unsafe

    t, j = pair(tmp_path, _cfg(raw, sampling_origin_ds_subset="val"))
    res_dir = str(tmp_path / "results")
    os.makedirs(res_dir)
    results = []
    for s in draw(t, range(len(t))):
        h, w = s["qry_img"].shape[:2]
        rles = [RLE.encode(m) for m in s["qry_isegmaps"]]
        g = len(rles)
        results.append({
            "idx": s["idx"], "qry_img_shape": s["img_shape"],
            "qry_bboxes": s["qry_bboxes"], "qry_cat_ids": s["qry_cat_ids"],
            "qry_isegmaps_rle": rles,
            "dt_bboxes": s["qry_bboxes"] + 1.5,
            "dt_cat_ids": s["qry_cat_ids"],
            "dt_scores": np.linspace(0.9, 0.5, g).astype(np.float32),
            "dt_isegmaps_rle": rles[::-1],
        })
    write_pkl_unsafe(os.path.join(res_dir, "chunk_00000.pkl"), results)
    assert t.evaluate(res_dir) == j.evaluate(res_dir)
    for ds, tag in ((t, "t"), (j, "j")):
        ds.visualize_result(results[1], str(tmp_path / f"vr_{tag}"), "r.png")
        random.seed(0)
        np.random.seed(0)
        ds.visualize(str(tmp_path / f"v_{tag}"), n=2)
    for sub, names in (("vr", ["r.png"]), ("v", ["Image 0000.png",
                                                  "Image 0001.png"])):
        for name in names:
            with open(tmp_path / f"{sub}_t" / name, "rb") as a, \
                    open(tmp_path / f"{sub}_j" / name, "rb") as b:
                assert a.read() == b.read(), (sub, name)


def test_reference_regenerates_from_jax(tmp_path):
    """The committed reference is the JAX package's engine's output, and
    the port's engine gives the same table."""
    want = D.load_table()
    table, ctx = D.digest_table(jax_engine(), os.path.join(ROOT, "fgn_tpu"),
                                str(tmp_path / "jax"))
    assert table == want
    assert D.raw_digests(D.SPLIT_DIR, D.QUANTITIES) == want["raw_images"]
    for got, fp in ((D.glyph_arrays(ctx.pools), D.GLYPHS_FP),
                    (D.warped_arrays(ctx.train_eps), D.EPISODES_FP)):
        ref = D.load_arrays(fp)
        assert sorted(got) == sorted(ref)
        assert all(np.array_equal(got[k], ref[k])
                   and got[k].dtype == ref[k].dtype for k in got)
    port, _ = D.digest_table(D.port_engine(), os.path.join(ROOT, "fgn_torch"),
                             str(tmp_path / "port"), raw=D.SPLIT_DIR)
    for stage in D.STAGES:
        assert port[stage] == want[stage], stage
    assert len(ctx.val) >= 60


def test_check_stages_holds_here_and_catches_a_change(tmp_path, monkeypatch):
    out, ctx = D.check_stages(D.port_engine(),
                              os.path.join(ROOT, "fgn_torch"), str(tmp_path))
    assert all(v["held"] is True for v in out.values())
    assert not any(v["differ"] for v in out.values())
    # an episode field the warps do not reach must be exact
    a = np.zeros((4, 4), np.uint8)
    assert D.within(a, a, D.TOLERANCE["qry_img"])
    b = a.copy()
    b[0, 0] = 13
    assert not D.within(b, a, D.TOLERANCE["qry_img"])
    assert not D.within(a.astype(np.float32), a, D.TOLERANCE["qry_img"])


class _ShiftedWarp:
    """OpenCV for the augmenter, with ``warpAffine`` lowering every
    ``every``-th byte of each warped RGB image by ``delta`` codes (clipped
    at 0): a stand-in for another OpenCV's rounding of the warp."""

    def __init__(self, delta, every):
        self.delta, self.every = delta, every

    def __getattr__(self, name):
        return getattr(cv2, name)

    def warpAffine(self, src, *a, **k):
        out = cv2.warpAffine(src, *a, **k)
        if out.dtype == np.uint8 and out.ndim == 3 and out.shape[-1] == 3:
            flat = out.reshape(-1).astype(np.int16)
            flat[::self.every] -= self.delta
            out = np.clip(flat, 0, 255).astype(np.uint8).reshape(out.shape)
        return out


def _shift_boxes(monkeypatch):
    real = t_augment.Augmenter._warp_boxes
    monkeypatch.setattr(t_augment.Augmenter, "_warp_boxes",
                        staticmethod(lambda m, b: real(m, b) + 1.0))


@pytest.mark.parametrize("change, held", [
    # 1 code on 1/64 of the bytes: after the photometric ops, at most 9
    # codes on ~3 % of an image (TOLERANCE: 12 codes, 5 %)
    (lambda mp: mp.setattr(t_augment, "cv2", _ShiftedWarp(1, 64)), True),
    # 13 codes on 1/256 of the bytes: past TOLERANCE's 12
    (lambda mp: mp.setattr(t_augment, "cv2", _ShiftedWarp(13, 256)), False),
    # a field the warps do not reach (the boxes), which must be exact
    (_shift_boxes, False),
], ids=["warp_within_tolerance", "warp_past_tolerance", "boxes_moved"])
def test_check_stages_tolerance_branches(tmp_path, monkeypatch, change, held):
    """The branches that run where another OpenCV warps otherwise: the
    train episodes and their batch are held within TOLERANCE on the warped
    image fields and exactly on every other field."""
    change(monkeypatch)
    out, _ = D.check_stages(D.port_engine(), os.path.join(ROOT, "fgn_torch"),
                            str(tmp_path))
    for stage in ("train_episodes", "batch"):
        assert out[stage]["differ"], stage
        assert out[stage]["held"] is held, (stage, out[stage]["note"])
    if held:
        assert {k.split(":", 1)[1] for k in out["train_episodes"]["differ"]} \
            <= set(D.WARPED)
        assert set(out["batch"]["differ"]) <= set(D.TOLERANCE)
    for stage in ("databag", "eval_episodes", "raw_images:committed"):
        assert out[stage]["held"] is True and not out[stage]["differ"], stage


def test_structure_checks_hold_the_reference_and_catch_faults(tmp_path):
    """``glyph_structure`` and ``split_structure`` pass the reference's
    glyphs and split, and name a blank glyph, an image whose masks are all
    empty and a category id out of range."""
    engine = D.port_engine()
    ref = D.load_arrays(D.GLYPHS_FP)
    pools = D.glyph_pools(engine)
    assert D.glyph_structure(engine, pools, ref) == []
    pools["val"][3] = (pools["val"][3][0], np.full((72, 72), 255, np.uint8))
    assert D.glyph_structure(engine, pools, ref) == [
        "val:003: 0 ink pixels, 0 on the border"]

    assert D.split_structure(engine, D.SPLIT_DIR, D.QUANTITIES) == (
        [], 389, 0)
    root = str(tmp_path / "split")
    shutil.copytree(D.SPLIT_DIR, root)
    colors = read_pkl(os.path.join(root, "val_colors.pkl"))
    cats = read_pkl(os.path.join(root, "val_cat_ids.pkl"))
    used = {tuple(c) for c in colors[5].tolist()}
    free = [c for c in get_palette_np().tolist() if tuple(c) not in used]
    colors[5] = np.asarray(free[:len(colors[5])], colors[5].dtype)
    cats[7] = [10] + list(cats[7][1:])
    write_pkl_unsafe(os.path.join(root, "val_colors.pkl"), colors)
    write_pkl_unsafe(os.path.join(root, "val_cat_ids.pkl"), cats)
    faults, n, empty = D.split_structure(engine, root, D.QUANTITIES)
    assert faults == ["val/000005.jpg: every mask empty",
                      f"val/000007.jpg: category ids {[10] + list(cats[7][1:])}"]
    assert (n, empty) == (389, len(colors[5]))
