"""Multi-process episode loader with per-host batch sharding.

Port of the JAX package's ``data/loader_grain.py``. The reference
parallelizes episode construction with torch DataLoader worker processes
(main.py:50-52); the JAX package's loader shards whole batches over hosts
(``shard_index``/``shard_count``: host i takes batches i, i+H, i+2H, …)
and builds episodes in one of three ways:

  * ``worker_count == 0``: in process, through ``EpisodeLoader``'s prefetch
    thread, bit-identical to it;
  * a grain pipeline when ``grain.python`` imports;
  * otherwise a fork pool (``_iter_mp``) of ``worker_count`` processes.

Without grain installed both packages take the fork pool; the grain
branch is kept as the JAX class has it. The pool's workers build
episodes with numpy and cv2 only (``ds.__getitem__``): they never touch
CUDA, which a forked child of a CUDA process could not use. Each batch's
episodes are sent to the workers as a ``pool.map`` over its indices,
pickling the dataset's bound ``__getitem__``: the dataset must pickle.
"""

from __future__ import annotations

from fgn_torch.data.batching import EpisodeLoader, collate_episodes


class GrainEpisodeLoader:
    def __init__(
        self,
        ds,
        batch_size: int,
        max_gt: int = 30,
        pad_hw=None,
        drop_last: bool = True,
        keep_gt_masks: bool = False,
        worker_count: int = 0,
        shard_index: int = 0,
        shard_count: int = 1,
    ):
        self.ds = ds
        self.batch_size = batch_size
        self.max_gt = max_gt
        self.pad_hw = pad_hw
        self.drop_last = drop_last
        self.keep_gt_masks = keep_gt_masks
        self.worker_count = worker_count
        self.shard_index = shard_index
        self.shard_count = shard_count

    def _indices(self):
        n = len(self.ds)
        bs = self.batch_size
        stop = (n // bs) * bs if self.drop_last else n
        batches = [
            list(range(s, min(s + bs, stop)))
            for s in range(0, stop, bs)
        ]
        # per-host sharding: host i takes batches i, i+H, i+2H, …
        return batches[self.shard_index:: self.shard_count]

    def __len__(self):
        return len(self._indices())

    def __iter__(self):
        if self.worker_count <= 0:
            loader = EpisodeLoader(
                self.ds, self.batch_size, max_gt=self.max_gt,
                pad_hw=self.pad_hw, drop_last=self.drop_last,
                keep_gt_masks=self.keep_gt_masks,
            )
            if self.shard_count == 1:
                yield from loader
                return
            for i, item in enumerate(loader):
                if i % self.shard_count == self.shard_index:
                    yield item
            return

        yield from self._iter_grain()

    def _iter_grain(self):
        try:
            import grain.python as grain  # noqa: F401

            yield from self._iter_grain_impl()
        except ImportError:
            yield from self._iter_mp()

    def _iter_grain_impl(self):
        import grain.python as grain

        ds = self.ds
        max_gt, pad_hw, keep = self.max_gt, self.pad_hw, self.keep_gt_masks
        # Shard BATCHES, not records (same split as the in-process and
        # mp paths): grain's record-level ShardOptions followed by local
        # batching dropped each shard's leftover records, so the shard
        # union lost episodes.
        flat = [i for b in self._indices() for i in b]

        class _Source(grain.RandomAccessDataSource):
            def __len__(self_inner):
                return len(flat)

            def __getitem__(self_inner, i):
                return ds[int(flat[int(i)])]

        sampler = grain.IndexSampler(
            num_records=len(flat),
            shard_options=grain.NoSharding(),
            shuffle=False,
            num_epochs=1,
        )
        loader = grain.DataLoader(
            data_source=_Source(),
            sampler=sampler,
            worker_count=self.worker_count,
        )
        buf = []
        for sample in loader:
            buf.append(sample)
            if len(buf) == self.batch_size:
                yield collate_episodes(
                    buf, ds.mean, ds.std, max_gt=max_gt, pad_hw=pad_hw,
                    keep_gt_masks=keep,
                )
                buf = []
        if buf:  # only possible when drop_last=False (short final batch)
            n_real = len(buf)
            while len(buf) < self.batch_size:
                buf.append(buf[-1])
            yield collate_episodes(
                buf, ds.mean, ds.std, max_gt=max_gt, pad_hw=pad_hw,
                keep_gt_masks=keep, n_real=n_real,
            )

    def _iter_mp(self):
        """Plain multiprocessing fallback when grain is absent."""
        import multiprocessing as mp

        ctx = mp.get_context("fork")
        with ctx.Pool(self.worker_count) as pool:
            for indices in self._indices():
                samples = pool.map(self.ds.__getitem__, indices)
                n_real = len(samples)
                while len(samples) < self.batch_size:
                    samples.append(samples[-1])
                yield collate_episodes(
                    samples, self.ds.mean, self.ds.std, max_gt=self.max_gt,
                    pad_hw=self.pad_hw, keep_gt_masks=self.keep_gt_masks,
                    n_real=n_real,
                )
