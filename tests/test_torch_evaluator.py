"""The port's episodic evaluation end to end against the JAX package's
``Evaluator``, on the CPU, on a tiny MNISTISEG split generated on the host
(128 px, no download) with the same weights on both sides (flax
``model.init`` → ``fgn_torch.bridge``). Each evaluator reads its own
package's episodes: the JAX package's ``FewShotISEG`` and the port's, over
the same split.

``FewShotISEG.__getitem__`` draws from Python's global ``random``, so every
episode of each package is drawn once into ``Frozen``, after the same seed;
the two packages' episodes are equal byte for byte.

Tolerances (f32 on both sides; the model's own, tests/test_torch_model.py):
per-episode valid counts, categories and gt RLE equal; boxes within
1e-4·128 px, scores within 1e-4; decoded detection masks equal except at
pixels whose pasted probability is within 1e-3 of ``mask_thr`` on either
side; the four metrics under the same tags within 1e-4.
"""

import os
import random

import jax
import numpy as np
import pytest
import torch

from fgn_tpu.data.batching import collate_episodes as j_collate
from fgn_tpu.data.fsisegeval import FSISEGEval as JFSISEGEval
from fgn_tpu.data.fst_bindings import MNISTFewShotISEG as JMNISTFewShotISEG
from fgn_tpu.data.mnistiseg import MNISTISEG as JMNISTISEG
from fgn_tpu.models.fgn import FGN as JFGN
from fgn_tpu.models.fgn import FGNConfig as JConfig
from fgn_tpu.parallel.mesh import make_mesh
from fgn_tpu.train.evaluator import Evaluator as JEvaluator
from fgn_tpu.train.train_step import make_eval_step as j_make_eval_step
from fgn_torch.bridge import load_flax_params
from fgn_torch.config import FGNConfig
from fgn_torch.data import rle as RLE
from fgn_torch.data.digests import digest
from fgn_torch.data.fst_bindings import MNISTFewShotISEG
from fgn_torch.data.mnistiseg import MNISTISEG
from fgn_torch.models.fgn import FGN
from fgn_torch.ops.mask_paste import paste_masks_np
from fgn_torch.train.evaluator import Evaluator
from fgn_torch.train.train_step import make_eval_step
from fgn_torch.utils.io import read_pkl

torch.set_num_threads(2)

IMG = 128.0
MASK_THR = 0.5


TINY_RAW = dict(
    img_size=128, target_size=128, max_size=128, ds_name="tiny_mnistiseg",
    sizes_max_amount={"small": 2, "large": 2},
    sizes_min_max_ratios={"small": [0.7, 1.0], "large": [1.0, 1.4]},
)
# The tiny split's raw dataset and its binding, in the port and in the JAX
# package.
TinyMNISTISEG = type("TinyMNISTISEG", (MNISTISEG,), dict(TINY_RAW))
TinyFewShot = type("TinyFewShot", (MNISTFewShotISEG,), dict(
    inner_ds_cl=TinyMNISTISEG, spp_img_size=64))
JTinyMNISTISEG = type("JTinyMNISTISEG", (JMNISTISEG,), dict(TINY_RAW))
JTinyFewShot = type("JTinyFewShot", (JMNISTFewShotISEG,), dict(
    inner_ds_cl=JTinyMNISTISEG, spp_img_size=64))


# tests/test_train_e2e.py's TINY_MODEL
TINY_MODEL = dict(
    n_ways=1, k_shots=1, backbone_norm="gn", backbone_frozen=False,
    rpn_train_nms_pre=512, rpn_train_max_per_img=128,
    rpn_test_nms_pre=512, rpn_test_max_per_img=64,
    rpn_num_samples=32, rcnn_num_samples=32, rcnn_max_per_img=10,
)

ATTRS = ("mean", "std", "n_ways", "sampling_origin_ds",
         "sampling_origin_ds_subset", "finetune", "sampling_cats",
         "sampling_scenario")


class Frozen:
    """Every episode of ``ds`` drawn once, with the attributes the
    evaluators and the loader read."""

    def __init__(self, ds):
        random.seed(0)
        self.samples = [ds[i] for i in range(len(ds))]
        for a in ATTRS:
            setattr(self, a, getattr(ds, a))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


class Recorder:
    """An eval step that keeps a host copy of every output it returns."""

    def __init__(self, step, to_np):
        self.step, self.to_np, self.outs = step, to_np, []

    def __call__(self, *a):
        out = self.step(*a)
        self.outs.append({k: self.to_np(v) for k, v in out.items()})
        return out


@pytest.fixture(scope="module")
def evals(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_eval")
    root = str(tmp / "raw")
    TinyMNISTISEG.create(
        root=root, quantities={"train": 4, "val": 6, "test": 1}, seed=7
    )
    cfg = dict(
        n_ways=1, k_shots=1,
        ds_base_="MNISTISEG", ds_base__subset="train",
        ds_novel="MNISTISEG", ds_novel_subset="val",
        sampling_origin_ds="MNISTISEG", sampling_origin_ds_subset="val",
        sampling_cats="base_", sampling_scenario="parents",
        repeats=1, finetune="Ignore", shuffle=False,
        qry_cats_choice_random=True,
        delete_qry_insts_in_spp_insts_on_train=False,
        inner_root=root,
    )
    ds = Frozen(TinyFewShot(dict(cfg, root=str(tmp / "fst"))))
    jds = Frozen(JTinyFewShot(dict(cfg, root=str(tmp / "jfst"))))
    assert digest(ds.samples) == digest(jds.samples)
    assert len(ds) % 4, "want a padded last batch"

    jm = JFGN(cfg=JConfig(**TINY_MODEL))
    jb, _ = j_collate(jds.samples[:1], jds.mean, jds.std, max_gt=8)
    params = jax.device_get(jax.jit(
        lambda k, b, r: jm.init(k, b, r, method=JFGN.train_forward)
    )(jax.random.PRNGKey(0), jb, jax.random.PRNGKey(1)))
    params = jax.tree_util.tree_map(np.array, params)
    for k in ("rpn_reg", "fc_reg"):  # as tests/test_torch_model.py
        params["params"][k]["kernel"] *= 0.1
    tm = FGN(FGNConfig(**TINY_MODEL)).eval()
    load_flax_params(tm, params)

    jstep, _ = j_make_eval_step(jm, make_mesh(jax.devices("cpu")[:1]))
    jrec = Recorder(jstep, np.asarray)
    jev = JEvaluator(jm, jds, batch_size=4, eval_step=jrec,
                     work_dir=str(tmp / "jax"), max_gt=8, n_plots=0,
                     mask_thr=MASK_THR)
    trec = Recorder(make_eval_step(tm), lambda t: t.numpy().copy())
    tev = Evaluator(tm, ds, batch_size=4, eval_step=trec,
                    work_dir=str(tmp / "torch"), max_gt=8, n_plots=0,
                    mask_thr=MASK_THR)
    jmetrics = jev.run(params)
    tmetrics = tev.run()
    results = []
    for ev in (jev, tev):
        d = ev_dir(ev)
        results.append([r for fn in sorted(os.listdir(d))
                        for r in read_pkl(os.path.join(d, fn))])
    return dict(ds=ds, jev=jev, tev=tev, jrec=jrec, trec=trec,
                jmetrics=jmetrics, tmetrics=tmetrics,
                jres=results[0], tres=results[1])


def ev_dir(ev):
    return os.path.join(ev.work_dir, "results_pkl",
                        f"{ev.tag.replace('/', '_')}_{ev.cats_suffix}")


def test_same_results_per_episode(evals):
    jres, tres = evals["jres"], evals["tres"]
    assert len(jres) == len(tres) == len(evals["ds"])
    n_dt = 0
    for j, t in zip(jres, tres):
        assert set(j) == set(t)
        for k in ("idx", "qry_child_idx"):
            assert j[k] == t[k]
        for k in ("cats_ids_to_sample_real", "spp_insts_ids", "qry_img_shape",
                  "qry_bboxes", "qry_cat_ids", "qry_cat_ids_real"):
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
        assert t["qry_isegmaps_rle"] == j["qry_isegmaps_rle"]
        assert len(t["dt_scores"]) == len(j["dt_scores"])
        np.testing.assert_array_equal(t["dt_cat_ids"], j["dt_cat_ids"])
        np.testing.assert_allclose(t["dt_bboxes"], j["dt_bboxes"], rtol=0,
                                   atol=1e-4 * IMG)
        np.testing.assert_allclose(t["dt_scores"], j["dt_scores"], rtol=0,
                                   atol=1e-4)
        assert t["dt_bboxes"].dtype == j["dt_bboxes"].dtype
        n_dt += len(t["dt_scores"])
    assert n_dt > 0


def _episode_probs(rec, i, batch_size):
    """Pasted mask probabilities (float canvases) of episode i's valid
    detections, from the recorded outputs of its batch."""
    out = rec.outs[i // batch_size]
    pack = out["dt_pack"][i % batch_size]
    valid = pack[:, 6] > 0.5
    logits = out["dt_mask_logits"][i % batch_size][valid]
    return 1.0 / (1.0 + np.exp(-logits.astype(np.float32))), pack[valid, :4]


def test_same_masks_but_at_the_threshold(evals):
    n_px = 0
    for i, (j, t) in enumerate(zip(evals["jres"], evals["tres"])):
        h, w = (int(v) for v in t["qry_img_shape"][:2])
        near = np.zeros((len(t["dt_scores"]), h, w), bool)
        for rec in (evals["jrec"], evals["trec"]):
            probs, boxes = _episode_probs(rec, i, 4)
            p = paste_masks_np(probs, boxes, h, w, threshold=None)
            near |= np.abs(p - MASK_THR) <= 1e-3
        for k, (rj, rt) in enumerate(zip(j["dt_isegmaps_rle"],
                                         t["dt_isegmaps_rle"])):
            mj, mt = RLE.decode(rj), RLE.decode(rt)
            assert mt.shape == (h, w)
            differ = (mj != mt) & ~near[k]
            assert not differ.any(), (i, k, int(differ.sum()))
            n_px += int(mt.sum())
    assert n_px > 0


def test_same_metrics(evals):
    j, t = evals["jmetrics"], evals["tmetrics"]
    assert sorted(t) == sorted(j)
    assert len(t) == 4
    assert all(k.startswith("MNISTISEG_val_FT_Ignore/") for k in t)
    for k in j:
        assert abs(t[k] - j[k]) <= 1e-4, (k, t[k], j[k])


def test_jax_fsisegeval_reads_the_port_pickles(evals):
    tev = evals["tev"]
    for iou_type, short in (("bbox", "bbox"), ("segm", "isegm")):
        got = JFSISEGEval(results_pkl_dir_fp=tev.results_dir(), n_ways=1,
                          iou_type=iou_type).run()
        for m in ("mAP", "mAR"):
            assert got[m] == evals["tmetrics"][
                f"{tev.tag}/{short}_{m}_{tev.cats_suffix}"]


def test_cached_pass_and_run_fresh(evals):
    tev = evals["tev"]
    cache = tev._episode_cache
    assert cache is not None and len(cache) == 2
    assert cache[-1][1].n_real == len(evals["ds"]) - 4
    assert tev.run() == evals["tmetrics"]
    assert tev._episode_cache is cache
    fresh = tev.run_fresh()
    assert tev._episode_cache is cache
    # the frozen episodes are the same on a fresh draw
    assert fresh == evals["tmetrics"]
    assert set(tev.last_times) >= {"batches", "fetch", "host", "eval", "wall"}
    assert tev.last_times["batches"] == 2


def test_numpy_rle_path_gives_the_same_pickles(evals, monkeypatch, tmp_path):
    """Without the native library the evaluator pastes with
    ``paste_masks_np`` and encodes in numpy: the same bytes."""
    monkeypatch.setattr(RLE, "_native", lambda: None)
    tev = evals["tev"]
    ev = Evaluator(tev.model, evals["ds"], batch_size=4,
                   eval_step=make_eval_step(tev.model),
                   work_dir=str(tmp_path), max_gt=8, n_plots=0,
                   mask_thr=MASK_THR, cache_episodes=False)
    assert ev.run() == evals["tmetrics"]
    got = [r for fn in sorted(os.listdir(ev.results_dir()))
           for r in read_pkl(os.path.join(ev.results_dir(), fn))]
    for a, b in zip(got, evals["tres"], strict=True):
        assert a["dt_isegmaps_rle"] == b["dt_isegmaps_rle"]
        assert a["qry_isegmaps_rle"] == b["qry_isegmaps_rle"]
        np.testing.assert_array_equal(a["dt_scores"], b["dt_scores"])
