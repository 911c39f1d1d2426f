"""The slice end to end on the CPU: a config file, the episode engine, the
loader and one train step, in the port and in the JAX package.

Both packages load ``fgn_train_mnistiseg_n1k1.py`` from their own config
directories and take the same toy overrides (model sizes, float64 compute,
batch 2). ``init_ds_class_by_config`` builds each package's train dataset
over one tiny MNISTISEG split (128 px, generated on the host; the
``MNISTISEG`` name dispatches to a 128 px binding on both sides). Each
package's ``EpisodeLoader`` gives its first batch after the same reseed of
the global generators, and the batches and metas are equal byte for byte.
Both packages' ``Augmenter`` keep their noise banks on the class and grow
them (with other contents) for the largest image seen in the process, so
the fixture empties both before it draws: the batch is the same whatever
ran before it in the process.
The train step runs on that batch with weights bridged from flax
``model.init``'s tree (leaves from a seed) and the JAX package's random
draws, in float64 with SGD, as
``tests/test_torch_optim.py`` does: losses within 1e-5 relative, updated
parameters within 1e-6 of each leaf's scale.
"""

import os
import random

import jax
import numpy as np
import pytest
import torch

from fgn_tpu.config import Config as JConfig
from fgn_tpu.data import augment as j_augment
from fgn_tpu.data import fst_bindings as j_bind
from fgn_tpu.data.batching import EpisodeLoader as JEpisodeLoader
from fgn_tpu.main import model_config_from_cfg as j_model_cfg
from fgn_tpu.models.fgn import FGN as JFGN
from fgn_tpu.parallel.mesh import make_mesh, shard_batch
from fgn_tpu.train import optim as j_optim
from fgn_tpu.train.train_step import make_train_step as j_make_train_step
from fgn_torch.bridge import flax_to_state_dict, load_flax_params
from fgn_torch.config import Config
from fgn_torch.data import augment as t_augment
from fgn_torch.data import fst_bindings as t_bind
from fgn_torch.data.batching import EpisodeLoader, from_numpy
from fgn_torch.data.digests import digest
from fgn_torch.main import model_config_from_cfg
from fgn_torch.models.fgn import FGN
from fgn_torch.train import optim as t_optim
from fgn_torch.train.train_step import make_train_step
from tests.test_torch_evaluator import JTinyFewShot, TinyFewShot, TinyMNISTISEG
from tests.test_torch_train import _jbatch, draws_fn, jax_draws

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = "fgn_train_mnistiseg_n1k1.py"
TOY_MODEL = dict(
    rpn_train_nms_pre=256, rpn_train_max_per_img=32, rpn_num_samples=16,
    rcnn_num_samples=16, compute_dtype="float64",
)
B = 2


def _first_batch(loader):
    """The loader's first batch; its prefetch thread is stopped before the
    other package draws from the same global generators."""
    random.seed(0)
    np.random.seed(0)
    it = iter(loader)
    out = next(it)
    it.close()
    return out


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("slice")
    raw = str(tmp / "raw")
    TinyMNISTISEG.create(root=raw, quantities={"train": 8, "val": 2},
                         seed=3)
    cfg = Config.from_file(os.path.join(ROOT, "fgn_torch", "configs", CONFIG))
    jcfg = JConfig.from_file(os.path.join(ROOT, "fgn_tpu", "configs", CONFIG))
    assert cfg == jcfg
    for aug in (t_augment.Augmenter, j_augment.Augmenter):
        aug._NOISE_BANK = aug._UNIF_BANK = None
    out = {}
    for side, c, bind, tiny, loader_cls in (
            ("t", cfg, t_bind, TinyFewShot, EpisodeLoader),
            ("j", jcfg, j_bind, JTinyFewShot, JEpisodeLoader)):
        c.model.update(TOY_MODEL)
        bind._DS_CLASSES["MNISTISEG"], keep = tiny, bind._DS_CLASSES["MNISTISEG"]
        try:
            ds = bind.init_ds_class_by_config(dict(
                c.train_ds_cfg, inner_root=raw, root=str(tmp / side)))
        finally:
            bind._DS_CLASSES["MNISTISEG"] = keep
        assert type(ds) is tiny
        ds.reshuffle(0)
        loader = loader_cls(ds, B, max_gt=int(c.max_gt), prefetch=1)
        out[side] = (c, ds, _first_batch(loader))
    return out


def test_config_datasets_and_batches_equal(chain):
    (cfg, t, (batch, meta)), (_, j, (jbatch, jmeta)) = chain["t"], chain["j"]
    assert (t.n_ways, t.k_shots, t.augment_qry, t.qry_mask_scale) == (
        j.n_ways, j.k_shots, j.augment_qry, j.qry_mask_scale) == (
        1, 1, True, 4)
    np.testing.assert_array_equal(t.order, j.order)
    assert batch._fields == jbatch._fields
    for f, a, b in zip(batch._fields, batch, jbatch):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    assert digest(meta._asdict()) == digest(jmeta._asdict())
    assert batch.qry_img.shape == (B, 128, 128, 3)
    assert bool(batch.qry_valid.any())


def test_train_step_on_the_batch_equals_jax(chain):
    (cfg, _, (batch, _)), (jcfg, _, (jbatch, _)) = chain["t"], chain["j"]
    mcfg = model_config_from_cfg(cfg)
    jmcfg = j_model_cfg(jcfg)
    rng = jax.random.PRNGKey(2)
    sched = dict(steps_per_epoch=100, warmup_iters=1)
    lr = float(cfg.optimizer.lr)
    with jax.enable_x64(True):
        jm = JFGN(cfg=jmcfg)
        jb = _jbatch(jbatch._asdict())
        # the tree of model.init, traced, not run; leaves from a seed at
        # flax's default scales (as tests/test_torch_optim.py)
        shapes = jax.eval_shape(
            lambda k, b, r: jm.init(k, b, r, method=JFGN.train_forward),
            jax.random.PRNGKey(0), jb, jax.random.PRNGKey(1))
        r = np.random.RandomState(2)
        params = jax.tree_util.tree_map_with_path(
            lambda path, s: (
                (r.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1])))
                if "kernel" in jax.tree_util.keystr(path[-1:])
                else np.full(s.shape, "scale" in jax.tree_util.keystr(path[-1:]))
            ).astype(np.float32), shapes)
        tx = j_optim.build_optimizer(
            params, optimizer="sgd",
            schedule=j_optim.make_lr_schedule(lr, **sched))
        mesh = make_mesh(jax.devices("cpu")[:1])
        step, mesh = j_make_train_step(jm, tx, mesh)
        new, _, metrics = step(params, jax.jit(tx.init)(params),
                               shard_batch(jb, mesh), rng)
        ref_p = flax_to_state_dict(jax.device_get(new))
        ref_m = {k: float(v) for k, v in metrics.items()}
        m = (128 // mcfg.stride) ** 2 * mcfg.num_anchors
        draws = jax_draws(rng, B, mcfg.n_ways, m,
                          int(cfg.max_gt) + mcfg.rpn_train_max_per_img)

    tm = FGN(mcfg)
    load_flax_params(tm, params)
    before = {k: v.numpy().copy() for k, v in tm.state_dict().items()}
    opt = t_optim.build_optimizer(
        tm, optimizer="sgd", schedule=t_optim.make_lr_schedule(lr, **sched))
    got_m = {k: float(v) for k, v in make_train_step(tm, opt)(
        from_numpy(**batch._asdict()), draws=draws_fn(draws)).items()}
    got_p = {k: v.numpy() for k, v in tm.state_dict().items()}

    assert set(got_m) == set(ref_m)
    for k in ref_m:
        assert got_m[k] == pytest.approx(ref_m[k], rel=1e-5, abs=1e-9), k
    assert ref_m["loss_bbox"] > 0 and ref_m["loss_mask"] > 0
    for n, ref in ref_p.items():
        scale = float(np.abs(ref).max())
        assert float(np.abs(got_p[n] - ref).max()) <= 1e-6 * scale, n
    assert all(not np.array_equal(got_p[n], before[n]) for n in ref_p)
