"""The port's category-order-shuffle evaluation
(``fgn_torch/tools/eval_cat_shuffle.py``) against the JAX package's
``tools/eval_cat_shuffle.py``, on the CPU.

The tiny MNISTISEG split of ``tests/test_torch_evaluator.py`` at two ways
(N2K1, so a permutation of the categories is not the identity), its model
at the same width, the same weights on both sides (flax ``model.init`` →
``fgn_torch.bridge``). Each tool's ``run`` reads a config file written here;
the JAX tool's checkpoint and the datasets of both (the tiny classes) are
stood in for, the port's checkpoint is a real one. Python's and numpy's
global generators are reseeded before each run.

  * The episodes of both passes, the permuted replays included (support
    blocks permuted, category ids remapped), equal the JAX tool's byte for
    byte. Tolerance: none.
  * Both passes' metrics equal the JAX tool's within 1e-4, the tolerance of
    ``tests/test_torch_evaluator.py``.
  * On a split whose images (112 px) are padded to the batch's 128 px
    canvas, as every COCO2VOC batch is (800x1066 on 800x1088), the JAX tool
    raises (its detection masks keep the canvas, its gt masks the image)
    and the port's tool, whose passes run through the port's ``Evaluator``,
    scores each detection mask at its image's size: its first pass equals
    an ``Evaluator`` over the same episodes exactly.
"""

import os
import random
import shutil
from types import SimpleNamespace
from unittest import mock

import jax
import numpy as np
import pytest
import torch

import fgn_torch.data.batching as t_batching
import tools.eval_cat_shuffle as j_tool
from fgn_tpu.data.batching import collate_episodes as j_collate
from fgn_tpu.models.fgn import FGN as JFGN
from fgn_tpu.models.fgn import FGNConfig as JConfig
from fgn_tpu.data.fst_bindings import MNISTFewShotISEG as JMNISTFewShotISEG
from fgn_tpu.data.mnistiseg import MNISTISEG as JMNISTISEG
from fgn_torch.bridge import load_flax_params
from fgn_torch.config import FGNConfig
from fgn_torch.data.digests import digest
from fgn_torch.data.fst_bindings import MNISTFewShotISEG
from fgn_torch.data.mnistiseg import MNISTISEG
from fgn_torch.models.fgn import FGN
from fgn_torch.tools import eval_cat_shuffle as tool
from fgn_torch.train.checkpoints import CheckpointManager
from fgn_torch.train.evaluator import Evaluator
from fgn_torch.train.train_step import make_eval_step
from tests.test_torch_evaluator import (
    JTinyFewShot, TINY_MODEL, TINY_RAW, TinyFewShot, TinyMNISTISEG,
)

torch.set_num_threads(2)
MAX_GT = 8
N_EPISODES = 6
MODEL = dict(TINY_MODEL, n_ways=2)
DS_CFG = dict(
    n_ways=2, k_shots=1, ds_base_="MNISTISEG", ds_base__subset="train",
    ds_novel="MNISTISEG", ds_novel_subset="val",
    sampling_origin_ds="MNISTISEG", sampling_origin_ds_subset="val",
    sampling_cats="base_", sampling_scenario="parents", repeats=1,
    finetune="Ignore", shuffle=False, qry_cats_choice_random=True,
    delete_qry_insts_in_spp_insts_on_train=False,
)


class Recorded:
    """A ``collate_episodes`` that keeps the real episodes of every chunk it
    is given."""

    def __init__(self, fn):
        self.fn, self.chunks = fn, []

    def __call__(self, chunk, *a, **k):
        # the real episodes of a batch the loader padded
        self.chunks.append(list(chunk)[:k.get("n_real") or len(chunk)])
        return self.fn(chunk, *a, **k)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cat_shuffle")
    raw = str(tmp / "raw")
    TinyMNISTISEG.create(root=raw, quantities={"train": 4, "val": 8,
                                               "test": 1}, seed=7)
    cfg = dict(DS_CFG, inner_root=raw)
    ds = TinyFewShot(dict(cfg, root=str(tmp / "fst")))
    jds = JTinyFewShot(dict(cfg, root=str(tmp / "jfst")))
    assert len(ds) == len(jds) >= N_EPISODES

    jm = JFGN(cfg=JConfig(**MODEL))
    random.seed(0)
    jb, _ = j_collate([jds[0]], jds.mean, jds.std, max_gt=MAX_GT)
    params = jax.device_get(jax.jit(
        lambda k, b, r: jm.init(k, b, r, method=JFGN.train_forward)
    )(jax.random.PRNGKey(0), jb, jax.random.PRNGKey(1)))
    params = jax.tree_util.tree_map(np.array, params)
    for k in ("rpn_reg", "fc_reg"):  # as tests/test_torch_model.py
        params["params"][k]["kernel"] *= 0.1
    tm = FGN(FGNConfig(**MODEL)).eval()
    load_flax_params(tm, params)
    work = str(tmp / "run")
    CheckpointManager(work).save(2, tm.state_dict(), {},
                                 extra={"epoch": 0, "cursor": 0})
    cfg_fp = str(tmp / "cfg.py")
    with open(cfg_fp, "w") as f:
        f.write(f"model = {MODEL!r}\neval_ds_cfg0 = {cfg!r}\n")
        f.write(f"work_dir = {work!r}\nmax_gt = {MAX_GT}\n")

    fake_ckpt = mock.MagicMock()
    fake_ckpt.return_value.restore.return_value = (2, {"params": params})
    jrec = Recorded(j_tool.collate_episodes)
    random.seed(1)
    np.random.seed(1)
    with mock.patch.object(j_tool, "init_ds_class_by_config",
                           return_value=jds), \
            mock.patch.object(j_tool, "_init_params",
                              return_value=(None, None)), \
            mock.patch.object(j_tool, "CheckpointManager", fake_ckpt), \
            mock.patch.object(j_tool, "collate_episodes", jrec):
        jbase, jshuf = j_tool.run(cfg_fp, N_EPISODES)

    trec = Recorded(t_batching.collate_episodes)
    random.seed(1)
    np.random.seed(1)
    with mock.patch("fgn_torch.data.fst_bindings.init_ds_class_by_config",
                    return_value=ds), \
            mock.patch.object(t_batching, "collate_episodes", trec):
        tbase, tshuf = tool.run(cfg_fp, N_EPISODES, device="cpu")
    yield SimpleNamespace(ds=ds, jrec=jrec, trec=trec, jbase=jbase,
                          jshuf=jshuf, tbase=tbase, tshuf=tshuf, tmp=tmp,
                          params=params, tm=tm, work=work, fake_ckpt=fake_ckpt)
    shutil.rmtree(tmp, ignore_errors=True)


def _passes(rec):
    """(pass 1's episodes, pass 2's): two batches of 4 each."""
    eps = [e for c in rec.chunks for e in c]
    assert len(eps) == 2 * N_EPISODES
    return eps[:N_EPISODES], eps[N_EPISODES:]


@pytest.mark.parametrize("which", [0, 1], ids=["normal", "shuffled"])
def test_episodes_equal_jax_tool(runs, which):
    got, want = _passes(runs.trec)[which], _passes(runs.jrec)[which]
    assert digest(got) == digest(want)


def test_replays_permute_the_categories(runs):
    """Each replay holds its episode's query and categories, its support
    blocks and category ids following the permutation; at least one
    episode's order changed."""
    normal, shuffled = _passes(runs.trec)
    changed = 0
    for a, b in zip(normal, shuffled):
        assert int(a["idx"]) == int(b["idx"])
        assert int(a["qry_child_idx"]) == int(b["qry_child_idx"])
        ca, cb = list(a["cats_ids_to_sample_real"]), list(
            b["cats_ids_to_sample_real"])
        assert sorted(ca) == sorted(cb)
        perm = [ca.index(c) for c in cb]
        np.testing.assert_array_equal(
            b["spp_insts_ids"], np.asarray(a["spp_insts_ids"])[perm])
        changed += perm != list(range(len(perm)))
        np.testing.assert_array_equal(b["qry_img"], a["qry_img"])
    assert changed >= 1


@pytest.mark.parametrize("which", ["base", "shuf"])
def test_metrics_equal_jax_tool(runs, which):
    got, want = getattr(runs, "t" + which), getattr(runs, "j" + which)
    assert sorted(got) == sorted(want) == [
        "bbox_mAP", "bbox_mAR", "segm_mAP", "segm_mAR"]
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4, (k, got[k], want[k])
        assert 0.0 <= got[k] <= 1.0


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA device is here")
def test_default_device_raises_without_cuda(tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.run(str(tmp_path / "cfg.py"), 1)


# 112 px images on a 128 px canvas
PAD_RAW = dict(TINY_RAW, img_size=112, target_size=112, max_size=112,
               ds_name="tiny112_mnistiseg")
Pad112 = type("Pad112", (MNISTISEG,), dict(PAD_RAW))
Pad112FewShot = type("Pad112FewShot", (MNISTFewShotISEG,), dict(
    inner_ds_cl=Pad112, spp_img_size=64))
JPad112 = type("JPad112", (JMNISTISEG,), dict(PAD_RAW))
JPad112FewShot = type("JPad112FewShot", (JMNISTFewShotISEG,), dict(
    inner_ds_cl=JPad112, spp_img_size=64))


def test_padded_canvas(runs):
    tmp = runs.tmp / "pad"
    raw = str(tmp / "raw")
    Pad112.create(root=raw, quantities={"train": 4, "val": 8, "test": 1},
                  seed=7)
    cfg = dict(DS_CFG, inner_root=raw)
    ds = Pad112FewShot(dict(cfg, root=str(tmp / "fst")))
    jds = JPad112FewShot(dict(cfg, root=str(tmp / "jfst")))
    cfg_fp = str(tmp / "cfg.py")
    with open(cfg_fp, "w") as f:
        f.write(f"model = {MODEL!r}\neval_ds_cfg0 = {cfg!r}\n")
        f.write(f"work_dir = {runs.work!r}\nmax_gt = {MAX_GT}\n")

    random.seed(1)
    with mock.patch.object(j_tool, "init_ds_class_by_config",
                           return_value=jds), \
            mock.patch.object(j_tool, "_init_params",
                              return_value=(None, None)), \
            mock.patch.object(j_tool, "CheckpointManager", runs.fake_ckpt), \
            pytest.raises(ValueError, match="mismatch"):
        j_tool.run(cfg_fp, N_EPISODES)

    trec = Recorded(t_batching.collate_episodes)
    random.seed(1)
    with mock.patch("fgn_torch.data.fst_bindings.init_ds_class_by_config",
                    return_value=ds), \
            mock.patch.object(t_batching, "collate_episodes", trec):
        base, shuf = tool.run(cfg_fp, N_EPISODES, device="cpu")
    normal, _ = _passes(trec)
    assert {e["qry_img"].shape[:2] for e in normal} == {(112, 112)}
    ev = Evaluator(runs.tm, tool.Episodes(ds, normal), batch_size=4,
                   eval_step=make_eval_step(runs.tm),
                   work_dir=str(tmp / "ev"), max_gt=MAX_GT, n_plots=0,
                   mask_thr=FGNConfig(**MODEL).mask_thr)
    want = {k.split("/")[1].replace("isegm", "segm").rsplit("_", 2)[0]: v
            for k, v in ev.run().items()}
    assert want == base
    assert sorted(shuf) == sorted(base)
