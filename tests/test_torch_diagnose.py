"""The port's detector diagnostics (``fgn_torch/tools/diagnose_detector.py``)
against the JAX package's ``tools/diagnose_detector.py``, on the CPU.

One batch of two episodes of the tiny MNISTISEG split of
``tests/test_torch_evaluator.py`` goes through the JAX model and, with the
same weights (flax ``model.init`` → ``fgn_torch.bridge``), through the port's.
The JAX tool's ``main`` runs on its own outputs (its config, dataset,
checkpoint and loader stood in for); the port's ``add_batch``/``report`` run
on the port's. Both in f32. Tolerances: the counts (gt, proposal hits,
detection hits with and without the class, detections a query) equal; the
score percentiles the JAX tool prints to 3 decimals within 6e-4 of the
port's (half its last digit plus the model's 1e-4 on scores,
``tests/test_torch_model.py``); the port's score histogram equals
``np.histogram`` of the JAX outputs' valid scores. Then the port's ``main``
runs end to end on the CPU from a config file and a port checkpoint, and
writes its renders.
"""

import io
import os
import random
import re
import shutil
from contextlib import redirect_stdout
from types import SimpleNamespace
from unittest import mock

import jax
import numpy as np
import pytest
import torch

import tools.diagnose_detector as j_tool
from fgn_tpu.data.batching import collate_episodes as j_collate
from fgn_tpu.models.fgn import FGN as JFGN
from fgn_tpu.models.fgn import FGNConfig as JConfig
from fgn_torch.bridge import load_flax_params
from fgn_torch.config import FGNConfig
from fgn_torch.data.batching import collate_episodes, from_numpy
from fgn_torch.data.digests import digest
from fgn_torch.models.fgn import FGN
from fgn_torch.tools import diagnose_detector as tool
from fgn_torch.train.checkpoints import CheckpointManager
from tests.test_torch_evaluator import (
    JTinyFewShot, TINY_MODEL, TinyFewShot, TinyMNISTISEG,
)

torch.set_num_threads(2)
MAX_GT = 8
DS_CFG = dict(
    n_ways=1, k_shots=1, ds_base_="MNISTISEG", ds_base__subset="train",
    ds_novel="MNISTISEG", ds_novel_subset="val",
    sampling_origin_ds="MNISTISEG", sampling_origin_ds_subset="val",
    sampling_cats="base_", sampling_scenario="parents", repeats=1,
    finetune="Ignore", shuffle=False, qry_cats_choice_random=True,
    delete_qry_insts_in_spp_insts_on_train=False,
)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("diagnose")
    raw = str(tmp / "raw")
    TinyMNISTISEG.create(root=raw, quantities={"train": 4, "val": 6,
                                               "test": 1}, seed=7)
    cfg = dict(DS_CFG, inner_root=raw)
    ds = TinyFewShot(dict(cfg, root=str(tmp / "fst")))
    jds = JTinyFewShot(dict(cfg, root=str(tmp / "jfst")))
    eps = []
    for d in (ds, jds):
        random.seed(0)
        eps.append([d[i] for i in range(2)])
    assert digest(eps[0]) == digest(eps[1])
    batch, meta = collate_episodes(eps[0], ds.mean, ds.std, max_gt=MAX_GT)
    jbatch, jmeta = j_collate(eps[1], jds.mean, jds.std, max_gt=MAX_GT)

    jm = JFGN(cfg=JConfig(**TINY_MODEL))
    params = jax.device_get(jax.jit(
        lambda k, b, r: jm.init(k, b, r, method=JFGN.train_forward)
    )(jax.random.PRNGKey(0), jbatch, jax.random.PRNGKey(1)))
    params = jax.tree_util.tree_map(np.array, params)
    for k in ("rpn_reg", "fc_reg"):  # as tests/test_torch_model.py
        params["params"][k]["kernel"] *= 0.1
    tm = FGN(FGNConfig(**TINY_MODEL)).eval()
    load_flax_params(tm, params)
    with torch.no_grad():
        tout = {k: v.numpy() for k, v in
                tm.test_forward(from_numpy(**batch._asdict())).items()}
    yield SimpleNamespace(tmp=tmp, raw=raw, ds=ds, jds=jds, batch=batch,
                          meta=meta, jbatch=jbatch, jmeta=jmeta, jm=jm,
                          params=params, tm=tm, tout=tout)
    shutil.rmtree(tmp, ignore_errors=True)


def _jax_tool_lines(s):
    """The JAX tool's printed lines on its own model's outputs."""
    fake_ckpt = mock.MagicMock()
    fake_ckpt.return_value.restore.return_value = (3, {"params": s.params})
    cfg = mock.MagicMock()
    cfg.get.side_effect = lambda k, d=None: d
    buf = io.StringIO()
    with mock.patch.object(j_tool.Config, "from_file", return_value=cfg), \
            mock.patch.object(j_tool, "model_config_from_cfg",
                              return_value=JConfig(**TINY_MODEL)), \
            mock.patch.object(j_tool, "init_ds_class_by_config",
                              return_value=s.jds), \
            mock.patch.object(j_tool, "_init_params",
                              return_value=(None, None)), \
            mock.patch.object(j_tool, "CheckpointManager", fake_ckpt), \
            mock.patch.object(j_tool, "EpisodeLoader",
                              return_value=[(s.jbatch, s.jmeta)]), \
            redirect_stdout(buf):
        j_tool.main("unused.py", 1)
    return buf.getvalue().splitlines()


def _jax_out(s):
    out = s.jm.apply(s.params, s.jbatch, method=JFGN.test_forward)
    return jax.tree_util.tree_map(np.asarray, out)


def test_counts_equal_jax_tool(setup):
    s = setup
    lines = _jax_tool_lines(s)
    assert lines[0] == "loaded checkpoint step 3"
    stats = tool.new_stats()
    tool.add_batch(stats, s.tout, s.meta)
    mine = tool.report(stats)
    # recall lines: counts equal, so the printed lines are equal
    assert mine[:3] == lines[1:4]
    assert stats["prop_total"] == stats["det_total"] > 0
    assert stats["prop_hits"] > 0


def test_score_distribution_equals_jax_tool(setup):
    s = setup
    lines = _jax_tool_lines(s)
    m = re.search(r"dets/img: mean ([\d.]+); score dist p50/p90/max: "
                  r"([\d.]+)/([\d.]+)/([\d.]+)", lines[4])
    stats = tool.new_stats()
    tool.add_batch(stats, s.tout, s.meta)
    got = tool.summary(stats)
    assert f"{got['dets_per_img']:.1f}" == m.group(1)
    for key, want in zip(("score_p50", "score_p90", "score_max"),
                         m.groups()[1:]):
        assert abs(got[key] - float(want)) <= 6e-4, key
    jout = _jax_out(s)
    scores = np.concatenate([jout["dt_scores"][b][jout["dt_valid"][b]]
                             for b in range(2)]).astype(np.float64)
    hist, _ = np.histogram(scores, bins=10, range=(0.0, 1.0))
    assert got["score_hist"] == hist.tolist()
    assert sum(got["score_hist"]) == sum(stats["n_dets"]) > 0


def test_per_stage_counts_equal_jax_outputs(setup):
    s = setup
    jout = _jax_out(s)
    stats = tool.new_stats()
    tool.add_batch(stats, s.tout, s.meta)
    assert stats["n_props"] == [int(v) for v in jout["prop_valid"].sum(1)]
    assert stats["n_dets"] == [int(v) for v in jout["dt_valid"].sum(1)]


def test_main_on_cpu_writes_renders(setup, capsys):
    s = setup
    work = str(s.tmp / "run")
    CheckpointManager(work).save(5, s.tm.state_dict(), {},
                                 extra={"epoch": 0, "cursor": 0})
    cfg_fp = str(s.tmp / "cfg.py")
    with open(cfg_fp, "w") as f:
        f.write(f"model = {TINY_MODEL!r}\n")
        f.write(f"eval_ds_cfg0 = {dict(DS_CFG, inner_root=s.raw)!r}\n")
        f.write(f"work_dir = {work!r}\nmax_gt = {MAX_GT}\n")
    with mock.patch("fgn_torch.data.fst_bindings.init_ds_class_by_config",
                    return_value=s.ds):
        stats, renders = tool.main(cfg_fp, 2, device="cpu")
    out = capsys.readouterr().out
    assert "loaded checkpoint step 5" in out and "proposal recall@0.5" in out
    assert stats["prop_total"] > 0 and len(stats["n_dets"]) == 4
    assert len(renders) == 2 and all(os.path.getsize(r) > 0 for r in renders)
    summary = tool.summary(stats)
    assert 0.0 <= summary["prop_recall"] <= 1.0
    assert all(np.isfinite(summary[k]) for k in ("prop_recall", "det_recall"))


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA device is here")
def test_default_device_raises_without_cuda(setup):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(str(setup.tmp / "cfg.py"), 1)
