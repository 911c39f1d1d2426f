"""The port's CheckpointManager (``fgn_torch/train/checkpoints.py``) on the
CPU, against the JAX package's (orbax) where they share a format.

  * the cases of ``tests/test_checkpoints.py`` that the port keeps: the
    ``ds_state`` sidecar round-trip through a fresh manager, pruning under
    retention, string ``group_hw`` keys;
  * the sidecar file is byte-identical to the one the JAX manager writes
    for the same ``ds_state``;
  * a save killed before its directory is moved into place leaves nothing
    that ``latest_step`` picks up; a second save at a step is skipped but
    for its sidecar, as the JAX manager (orbax) skips it: both managers,
    given the same two saves, hold the same ``extra`` and sidecar;
  * ``FGNOptimizer`` (adagrad, adam, sgd, adadelta; ``cumulative_iters`` 1
    and 2): saved after 3 steps and restored into a fresh model and
    optimizer, the 4th step equals the uninterrupted run's bit for bit;
  * a stage-1 checkpoint written by the JAX package (orbax), read with JAX
    here and written in the port's format, gives the port through its
    ``init_from`` path (``main.init_from_checkpoint``) exactly the weights
    of the flax tree.

Each test's directory is removed after it: a checkpoint of the toy model
takes hundreds of MB.
"""

import os
import shutil

import jax
import numpy as np
import optax
import pytest
import torch
from torch import nn

from __graft_entry__ import _toy_batch
from fgn_tpu.models.fgn import FGN as JFGN
from fgn_tpu.models.fgn import FGNConfig as JConfig
from fgn_tpu.train.checkpoints import CheckpointManager as JCheckpointManager
from fgn_torch.bridge import flax_to_state_dict
from fgn_torch.config import FGNConfig
from fgn_torch.main import init_from_checkpoint
from fgn_torch.models.fgn import FGN
from fgn_torch.train.checkpoints import CheckpointManager
from fgn_torch.train.optim import OPTIMIZERS, build_optimizer, make_lr_schedule

torch.set_num_threads(2)


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, removed after the test."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _ds_state(n=7, groups=5):
    return {
        "order": np.arange(n, dtype=np.int64),
        "group_hw": {i: (480 + 16 * i, 640) for i in range(groups)},
    }


class _Net(nn.Module):
    """Top-level names the optimizer labels 'main' (backbone) and 'roi'
    (fc_cls)."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.backbone = nn.Linear(4, 3)
        self.fc_cls = nn.Linear(3, 2)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=g))

    def forward(self, x):
        return self.fc_cls(torch.tanh(self.backbone(x)))


def _opt(model, kind, cum):
    return build_optimizer(
        model, optimizer=kind, cumulative_iters=cum, weight_decay=1e-3,
        schedule=make_lr_schedule(5e-2, steps_per_epoch=2, warmup_iters=3))


def _step(model, opt, i):
    x = torch.from_numpy(np.random.RandomState(i).randn(5, 4).astype(np.float32))
    opt.zero_grad(set_to_none=True)
    (model(x) ** 2).sum().backward()
    opt.step()


def test_ds_state_sidecar_roundtrip(tmp_path):
    work = str(tmp_path / "run")
    model = _Net()
    opt = _opt(model, "adam", 1)
    _step(model, opt, 0)
    mgr = CheckpointManager(work, max_keep=2)
    mgr.save(3, model.state_dict(), opt.state_dict(),
             extra={"epoch": 1, "cursor": 9, "ds_state": _ds_state()})
    mgr.wait()

    mgr2 = CheckpointManager(work, max_keep=2)
    step, state = mgr2.restore()
    assert step == 3 and mgr2.latest_step() == 3
    assert state["extra"]["epoch"] == 1 and state["extra"]["cursor"] == 9
    ds = state["extra"]["ds_state"]
    np.testing.assert_array_equal(ds["order"], np.arange(7))
    assert ds["group_hw"][4] == (544, 640)
    assert sorted(os.listdir(os.path.join(mgr2.dir, "3"))) == [
        "extra.json", "model.pt", "optimizer.pt"]
    fresh = _Net()
    fresh.load_state_dict(state["model"])
    fresh_opt = _opt(fresh, "adam", 1)
    fresh_opt.load_state_dict(state["optimizer"])
    assert fresh_opt.state["count"] == 1
    mgr.close()
    mgr2.close()


def test_sidecar_pruned_with_retention(tmp_path):
    work = str(tmp_path / "prune")
    model = _Net()
    opt = _opt(model, "sgd", 1)
    mgr = CheckpointManager(work, max_keep=2)
    for s in (1, 2, 3):
        mgr.save(s, model.state_dict(), opt.state_dict(),
                 extra={"epoch": 0, "cursor": 0, "ds_state": _ds_state()})
        mgr.wait()
    assert mgr.all_steps() == [2, 3]
    assert mgr.load_ds_state(3) is not None
    assert mgr.load_ds_state(1) is None, "sidecar for evicted step must be pruned"
    mgr.close()


def test_load_state_dict_accepts_string_keys():
    """group_hw keys may arrive as str (JSON sidecar)."""
    from fgn_torch.data.episodic import FewShotISEG

    class _Stub(FewShotISEG):
        def __init__(self):  # bypass full construction
            self.order = np.arange(3)
            self._group_hw = {}

    ds = _Stub()
    ds.load_state_dict({"order": np.arange(3), "group_hw": {"2": [480, 640]}})
    assert ds._group_hw == {2: (480, 640)}


@pytest.mark.parametrize("ds_state", [
    _ds_state(),
    {"order": np.array([4, 0, 3, 1, 2], np.int64), "group_hw": {}},
    {"order": np.arange(12, dtype=np.int32)[::-1],
     "group_hw": {np.int64(7): (np.int64(800), np.int64(1088)), 0: [480, 640]}},
], ids=["groups", "no-groups", "numpy-keys"])
def test_sidecar_bytes_equal_jax(tmp_path, ds_state):
    params = {"dense": {"w": np.ones((4, 3), np.float32)}}
    jm = JCheckpointManager(str(tmp_path / "jax"), max_keep=2)
    jm.save(5, params, optax.adam(1e-3).init(params),
            extra={"epoch": 0, "cursor": 2, "ds_state": ds_state})
    jm.wait()
    model = _Net()
    tm = CheckpointManager(str(tmp_path / "torch"), max_keep=2)
    tm.save(5, model.state_dict(), _opt(model, "sgd", 1).state_dict(),
            extra={"epoch": 0, "cursor": 2, "ds_state": ds_state})
    with open(jm._sidecar_path(5), "rb") as f:
        want = f.read()
    with open(tm._sidecar_path(5), "rb") as f:
        got = f.read()
    assert got == want
    assert os.path.basename(tm._sidecar_path(5)) == os.path.basename(
        jm._sidecar_path(5)) == "ds_state_5.json"
    jm.close()


def test_killed_save_and_resave(tmp_path, monkeypatch):
    model = _Net()
    opt = _opt(model, "adagrad", 1)
    mgr = CheckpointManager(str(tmp_path / "kill"), max_keep=3)
    mgr.save(4, model.state_dict(), opt.state_dict(),
             extra={"epoch": 0, "cursor": 4})

    # killed while writing step 8: the optimizer's file never lands
    def boom(*a, **k):
        raise KeyboardInterrupt

    real_save = torch.save
    calls = []
    monkeypatch.setattr(torch, "save", lambda obj, fp: (
        calls.append(fp), real_save(obj, fp) if len(calls) == 1 else boom()))
    with pytest.raises(KeyboardInterrupt):
        mgr.save(8, model.state_dict(), opt.state_dict(),
                 extra={"epoch": 0, "cursor": 8})
    monkeypatch.setattr(torch, "save", real_save)
    assert mgr.latest_step() == 4
    # a new process's manager clears the temporary directory
    mgr2 = CheckpointManager(str(tmp_path / "kill"), max_keep=3)
    assert sorted(os.listdir(mgr2.dir)) == ["4"]
    # a second save at one step (the end-of-epoch save after a mid-epoch
    # check at the same step) is skipped, as orbax skips it
    mgr2.save(4, model.state_dict(), opt.state_dict(),
              extra={"epoch": 1, "cursor": 0})
    assert mgr2.all_steps() == [4]
    assert mgr2.restore()[1]["extra"] == {"epoch": 0, "cursor": 4}


def test_second_save_at_a_step_as_jax(tmp_path):
    """The same saves through both managers: a step saved twice, then a
    step before the latest. Each keeps the first save's ``extra`` and
    writes each save's sidecar; the files on disk agree."""
    params = {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}
    saves = [(4, {"epoch": 0, "cursor": 4}, _ds_state(7)),
             (4, {"epoch": 1, "cursor": 0}, _ds_state(9, 2)),
             (6, {"epoch": 1, "cursor": 2}, _ds_state(9, 2)),
             (5, {"epoch": 1, "cursor": 1}, _ds_state(8, 1))]
    jm = JCheckpointManager(str(tmp_path / "jax"), max_keep=3)
    tm = CheckpointManager(str(tmp_path / "port"), max_keep=3)
    model = {"w": torch.from_numpy(params["w"])}
    for step, extra, ds in saves:
        jm.save(step, params, {}, extra=dict(extra, ds_state=ds))
        jm.wait()
        tm.save(step, model, {}, extra=dict(extra, ds_state=ds))
    steps = jm.mngr.all_steps()
    assert tm.all_steps() == list(steps) == [4, 6]
    for step in steps:
        jextra = jm.mngr.restore(step)["extra"]
        _, st = tm.restore(step)
        assert {k: int(v) for k, v in jextra.items()} == {
            k: v for k, v in st["extra"].items() if k != "ds_state"}
    names = sorted(f for f in os.listdir(jm.dir) if f.endswith(".json"))
    assert names == sorted(f for f in os.listdir(tm.dir)
                           if f.endswith(".json"))
    assert names == ["ds_state_4.json", "ds_state_6.json"]
    for name in names:
        with open(os.path.join(jm.dir, name), "rb") as a, \
                open(os.path.join(tm.dir, name), "rb") as b:
            assert a.read() == b.read(), name
    jm.close()


@pytest.mark.parametrize("cum", [1, 2])
@pytest.mark.parametrize("kind", OPTIMIZERS)
def test_optimizer_roundtrip_bit_for_bit(tmp_path, kind, cum):
    ref = _Net()
    ref_opt = _opt(ref, kind, cum)
    for i in range(4):
        _step(ref, ref_opt, i)

    model = _Net()
    opt = _opt(model, kind, cum)
    for i in range(3):
        _step(model, opt, i)
    mgr = CheckpointManager(str(tmp_path / "rt"), max_keep=1)
    mgr.save(3, model.state_dict(), opt.state_dict(),
             extra={"epoch": 0, "cursor": 3})

    fresh = _Net()
    fresh_opt = _opt(fresh, kind, cum)
    _, state = CheckpointManager(str(tmp_path / "rt")).restore(
        map_location="cpu")
    fresh.load_state_dict(state["model"])
    fresh_opt.load_state_dict(state["optimizer"])
    assert fresh_opt.state["count"] == opt.state["count"] == (3 // cum)
    assert fresh_opt.state["mini_step"] == opt.state["mini_step"] == 3 % cum
    for p, q in zip(fresh.parameters(), model.parameters()):
        st, sq = fresh_opt.state[p], opt.state[q]
        assert sorted(st) == sorted(sq)
        assert ("acc_grad" in st) == (cum > 1)
        for k in sq:
            if isinstance(sq[k], torch.Tensor):
                assert st[k].dtype == sq[k].dtype and torch.equal(st[k], sq[k])
            else:
                assert type(st[k]) is type(sq[k]) and st[k] == sq[k], k
    _step(fresh, fresh_opt, 3)
    for (n, a), b in zip(fresh.named_parameters(), ref.parameters()):
        assert torch.equal(a, b), n


def test_jax_stage1_checkpoint_through_init_from(tmp_path):
    """The stage-1 run is the JAX package's: its orbax checkpoint is read
    here with JAX and written as the port's checkpoint, which the port's
    finetune init path loads."""
    small = dict(n_ways=3, k_shots=1, backbone_norm="gn",
                 rpn_train_nms_pre=64, rpn_train_max_per_img=16,
                 rpn_num_samples=8, rcnn_num_samples=8)
    jm = JFGN(cfg=JConfig(**small))
    params = jax.jit(lambda k, b, r: jm.init(k, b, r, method=JFGN.train_forward))(
        jax.random.PRNGKey(0), _toy_batch(B=1, H=64, W=64, N=3, K=1, S=32),
        jax.random.PRNGKey(1))
    stage1 = str(tmp_path / "stage1_jax")
    jmgr = JCheckpointManager(stage1, max_keep=2)
    jmgr.save(12, params, optax.sgd(1e-3).init(params),
              extra={"epoch": 1, "cursor": 0})
    jmgr.close()

    step, state = JCheckpointManager(stage1).restore()
    sd = flax_to_state_dict(jax.device_get(state["params"]))
    port_run = str(tmp_path / "stage1_port")
    CheckpointManager(port_run).save(
        step, {k: torch.from_numpy(v) for k, v in sd.items()}, {},
        extra={k: int(v) for k, v in state["extra"].items()})

    model = FGN(FGNConfig(**small))
    assert init_from_checkpoint(model, port_run) == 12
    want = flax_to_state_dict(jax.device_get(params))
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert np.array_equal(got[k].numpy(), v), k

    with pytest.raises(FileNotFoundError):
        init_from_checkpoint(model, str(tmp_path / "no_stage1"))
