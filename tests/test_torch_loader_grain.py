"""The port's ``GrainEpisodeLoader`` (``fgn_torch/data/loader_grain.py``)
against the JAX package's, on the CPU.

Both packages build the same episodes from the same global ``random``
state (``tests/test_torch_episodic.py``). In the fork pool
(``worker_count`` > 0 without grain: the tests hide ``grain.python``, so
that both loaders take it wherever grain is installed) which worker builds
which episode, and so from which state of its copy of the generators,
varies from run to run; the datasets here are wrapped so that each episode
reseeds Python's and numpy's generators from its index first (``Seeded``).
Each pool runs in a thread joined with a timeout: the pool forks this
process, which holds JAX's threads. Then:

  * at ``worker_count`` 0 and 2 the two packages' loaders yield the same
    batches, every array byte for byte, and the same metas, and the pool's
    batches equal the in-process ones;
  * two shards (``shard_count=2``) partition the epoch, in both packages
    alike (``tests/test_multihost_shard.py``'s case);
  * the dataset pickles (the pool sends it to its workers) and the copy
    builds the same episode.
"""

import pickle
import random
import sys
import threading

import numpy as np
import pytest

from fgn_tpu.data.loader_grain import GrainEpisodeLoader as JLoader
from fgn_torch.data.loader_grain import GrainEpisodeLoader
from tests.test_torch_runner import (
    JTiny64FewShot, Tiny64, Tiny64FewShot, _ds_cfg,
)

BS, MAX_GT = 2, 8


class Seeded:
    """``ds`` with Python's and numpy's global generators reseeded from the
    index before each episode."""

    def __init__(self, ds):
        self.ds, self.mean, self.std = ds, ds.mean, ds.std

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        random.seed(i)
        np.random.seed(i)
        return self.ds[i]


@pytest.fixture(scope="module")
def dss(tmp_path_factory):
    """(the port's dataset, the JAX package's) over one tiny split, 9
    episodes: 4 batches of 2 and one left over."""
    tmp = tmp_path_factory.mktemp("loader_grain")
    root = str(tmp / "raw")
    Tiny64.create(root=root, quantities={"train": 10, "val": 2}, seed=4)
    cfg = dict(_ds_cfg(root), shuffle=False)
    t = Tiny64FewShot(dict(cfg, root=str(tmp / "t_fst")))
    j = JTiny64FewShot(dict(cfg, root=str(tmp / "j_fst")))
    assert len(t) == len(j) == 9
    return t, j


@pytest.fixture
def no_grain(monkeypatch):
    """``import grain.python`` fails: the loaders take their fork pool."""
    monkeypatch.setitem(sys.modules, "grain.python", None)


def _batches(loader, timeout=120.0):
    """The loader's (batch, meta) pairs, iterated in a thread that must
    finish within ``timeout`` seconds."""
    out, err = [], []

    def run():
        try:
            out.extend(loader)
        except BaseException as e:  # re-raised in the test's thread
            err.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"the loader took more than {timeout} s"
    if err:
        raise err[0]
    return out


def _assert_same(a, b):
    assert len(a) == len(b)
    for (ba, ma), (bb, mb) in zip(a, b):
        assert ba._fields == bb._fields
        for f in ba._fields:
            x, y = np.asarray(getattr(ba, f)), np.asarray(getattr(bb, f))
            assert x.dtype == y.dtype and x.shape == y.shape, f
            assert x.tobytes() == y.tobytes(), f
        assert ma.n_real == mb.n_real
        for f in ("idx", "qry_child_idx", "cats_ids_to_sample_real",
                  "spp_insts_ids"):
            assert np.array_equal(getattr(ma, f), getattr(mb, f)), f
        for f in ("qry_bboxes_yxyx", "qry_cat_ids", "qry_cat_ids_real"):
            for x, y in zip(getattr(ma, f), getattr(mb, f)):
                assert np.array_equal(x, y), f


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("worker_count", [0, 2])
def test_batches_equal_jax_loader(dss, no_grain, worker_count, drop_last):
    t, j = dss
    kw = dict(max_gt=MAX_GT, worker_count=worker_count, drop_last=drop_last)
    got = _batches(GrainEpisodeLoader(Seeded(t), BS, **kw))
    want = _batches(JLoader(Seeded(j), BS, **kw))
    assert len(got) == (4 if drop_last else 5)
    _assert_same(got, want)
    if worker_count:
        _assert_same(got, _batches(GrainEpisodeLoader(
            Seeded(t), BS, max_gt=MAX_GT, drop_last=drop_last)))


def _consumed(loader):
    out = []
    for _, meta in _batches(loader):
        out.extend(int(v) for v in np.asarray(meta.idx)[: meta.n_real])
    return out


@pytest.mark.parametrize("worker_count", [0, 2])
def test_two_shards_partition_the_epoch(dss, no_grain, worker_count):
    t, j = dss
    full = _consumed(GrainEpisodeLoader(Seeded(t), BS, max_gt=MAX_GT))
    shards = [_consumed(GrainEpisodeLoader(
        Seeded(t), BS, max_gt=MAX_GT, worker_count=worker_count,
        shard_index=i, shard_count=2)) for i in range(2)]
    s0, s1 = (set(s) for s in shards)
    assert s0 and s1 and not (s0 & s1)
    assert sorted(shards[0] + shards[1]) == sorted(full)
    for i in range(2):
        loader = GrainEpisodeLoader(Seeded(t), BS, max_gt=MAX_GT,
                                    shard_index=i, shard_count=2)
        jloader = JLoader(Seeded(j), BS, max_gt=MAX_GT, shard_index=i,
                          shard_count=2)
        assert len(loader) == len(jloader) == 2
        assert shards[i] == _consumed(jloader)


def test_dataset_pickles(dss):
    t, _ = dss
    copy = pickle.loads(pickle.dumps(Seeded(t)))
    a, b = Seeded(t)[3], copy[3]
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


class Serial(Seeded):
    """``Seeded`` building one episode at a time in each process. Grain's
    ``DataLoader`` reads records from 16 threads in each worker (its
    ``ReadOptions.num_threads``), and an episode draws from the process's
    global ``random`` and ``np.random``, so two episodes built at once
    interleave their draws: with ``Seeded`` alone both packages' grain paths
    give other batches from run to run (ROADMAP Queue 3). Behind this lock
    each episode is its index's, whatever thread builds it."""

    def __init__(self, ds):
        super().__init__(ds)
        self.lock = threading.Lock()

    def __getstate__(self):
        state = dict(self.__dict__)
        del state["lock"]
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.lock = threading.Lock()

    def __getitem__(self, i):
        with self.lock:
            return super().__getitem__(i)


def _grain_imports():
    try:
        import grain.python  # noqa: F401
    except ImportError:
        return False
    return True


@pytest.mark.skipif(not _grain_imports(),
                    reason="grain.python does not import here, so both "
                           "loaders take the fork pool tested above")
def test_grain_batches_equal_jax_loader(dss):
    """The grain path (``_iter_grain_impl``, 2 workers) of both packages,
    three times each: every batch equals the JAX class's byte for byte and
    the in-process loader's."""
    t, j = dss
    kw = dict(max_gt=MAX_GT, worker_count=2, drop_last=False)
    want = _batches(GrainEpisodeLoader(Serial(t), BS, max_gt=MAX_GT,
                                       drop_last=False))
    assert len(want) == 5
    for _ in range(3):
        got = _batches(GrainEpisodeLoader(Serial(t), BS, **kw), timeout=300)
        _assert_same(got, _batches(JLoader(Serial(j), BS, **kw), timeout=300))
        _assert_same(got, want)
