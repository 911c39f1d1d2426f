"""Category-order-shuffle evaluation protocol.

The port's counterpart of the JAX package's ``tools/eval_cat_shuffle.py``.
The reference validates that episodic evaluation is invariant to the
order of the N sampled categories by re-running eval with shuffled
category order (reference README.md:122-139, relying on the
deterministic replay ids stored in each result). This tool:

  1. evaluates normally, storing per-episode replay ids;
  2. replays the SAME episodes with a permuted category order (support
     blocks permuted accordingly, episode cat ids remapped);
  3. re-evaluates and reports both metric sets — they should agree to
     within NMS tie-breaking noise.

    python -m fgn_torch.tools.eval_cat_shuffle <config.py> [n_episodes] \\
        [--device cpu]

Both passes run through the port's ``Evaluator``, which writes their
pickles under the config's ``work_dir``, in
``results_pkl/cat_shuffle_{normal,shuffled}_*``.
The checkpoint is the latest in the config's ``work_dir``. Runs on ``cuda``
unless given ``--device cpu``; without a GPU the default raises.
"""

from __future__ import annotations

import argparse
import random
from typing import Dict, List

import numpy as np

BATCH = 4


class Episodes:
    """A fixed list of episodes, with the attributes of ``ds`` that the
    Evaluator and its loader read."""

    ATTRS = ("mean", "std", "n_ways", "sampling_origin_ds",
             "sampling_origin_ds_subset", "finetune", "sampling_cats",
             "sampling_scenario")

    def __init__(self, ds, samples: List[Dict]):
        self.samples = samples
        for a in self.ATTRS:
            setattr(self, a, getattr(ds, a))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


def permuted_replays(ds, episodes: List[Dict], rng) -> List[Dict]:
    """Each episode replayed from its ids with its N categories in the
    order of ``rng.permutation(N)``: the support blocks follow their
    categories and the episode's category ids are remapped."""
    shuffled = []
    for s in episodes:
        N, K = ds.n_ways, ds.k_shots
        perm = rng.permutation(N)
        cats_perm = s["cats_ids_to_sample_real"][perm]
        spp_perm = s["spp_insts_ids"].reshape(N, K)[perm].reshape(-1)
        shuffled.append(ds.__getitem__(
            int(s["idx"]),
            _qry_child_idx=int(s["qry_child_idx"]),
            _cats_ids_to_sample_real=cats_perm,
            _spp_insts_ids=spp_perm,
        ))
    return shuffled


def evaluate(model, ds, episodes: List[Dict], max_gt: int, mask_thr: float,
             work_dir: str, tag: str) -> Dict[str, float]:
    """bbox and segm mAP/mAR of ``model`` over ``episodes``: one pass of the
    port's Evaluator in batches of 4 (the last one padded), its pickles
    under ``work_dir/results_pkl/<tag>_*``."""
    from fgn_torch.train.evaluator import Evaluator
    from fgn_torch.train.train_step import make_eval_step

    ev = Evaluator(model, Episodes(ds, episodes), BATCH, make_eval_step(model),
                   work_dir, max_gt=max_gt, mask_thr=mask_thr, tag=tag,
                   n_plots=0, cache_episodes=False)
    # "<tag>/isegm_mAP_<cats>_<scenario>" → "segm_mAP"
    return {k.split("/")[1].replace("isegm", "segm").rsplit("_", 2)[0]: v
            for k, v in ev.run().items()}


def run(cfg_fp: str, n_episodes: int = 24, seed: int = 0, device="cuda"):
    """→ (the metrics in the normal order, those in the shuffled order)."""
    from fgn_torch.config import Config
    from fgn_torch.data.fst_bindings import init_ds_class_by_config
    from fgn_torch.main import _device, model_config_from_cfg
    from fgn_torch.models.fgn import build_model
    from fgn_torch.train.checkpoints import CheckpointManager

    dev = _device(device)
    cfg = Config.from_file(cfg_fp)
    mcfg = model_config_from_cfg(cfg)
    ds = init_ds_class_by_config(cfg.eval_ds_cfg0)
    max_gt = int(cfg.get("max_gt", 30))

    model = build_model(mcfg, dev, seed=0).eval()
    restored = CheckpointManager(str(cfg.work_dir)).load_model(
        map_location=dev)
    assert restored, "no checkpoint"
    model.load_state_dict(restored[1])

    random.seed(seed)
    episodes = [ds[i] for i in range(min(n_episodes, len(ds)))]
    rng = np.random.RandomState(seed)

    work = str(cfg.work_dir)
    base = evaluate(model, ds, episodes, max_gt, mcfg.mask_thr, work,
                    "cat_shuffle_normal")
    print("normal order:   ", {k: round(v, 4) for k, v in base.items()})

    shuf = evaluate(model, ds, permuted_replays(ds, episodes, rng), max_gt,
                    mcfg.mask_thr, work, "cat_shuffle_shuffled")
    print("shuffled order: ", {k: round(v, 4) for k, v in shuf.items()})
    for k in base:
        d = abs(base[k] - shuf[k])
        flag = "OK" if d < 0.05 else "MISMATCH"
        print(f"  {k}: Δ={d:.4f} {flag}")
    return base, shuf


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config")
    ap.add_argument("n_episodes", nargs="?", type=int, default=24)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu to run on the CPU)")
    args = ap.parse_args()
    run(args.config, args.n_episodes, device=args.device)
