"""Checkpoint save/restore with ``torch.save``.

Port of the JAX package's ``train/checkpoints.py`` (orbax there). Reference
behaviour kept (SURVEY.md §5.4): checkpoints with optimizer state and
bounded retention (``max_keep``), resume restoring (model, optimizer, step,
epoch, cursor), plus the dataset iterator state (which the reference
stubbed).

Each checkpoint is a directory ``checkpoints/<step>/`` holding
``model.pt`` (the model's ``state_dict``), ``optimizer.pt`` (the
optimizer's ``state_dict``) and ``extra.json`` (``epoch``, ``cursor``). It
is written whole into a temporary directory and moved into place with
``os.replace``, so a run killed during a save leaves no half checkpoint
that ``latest_step`` could pick up. As orbax does, a save at a step no
later than the latest saved one writes nothing but its ``ds_state``
sidecar: when a mid-epoch check falls on an epoch's last step, the
checkpoint keeps the mid-epoch save's ``(epoch, cursor)`` and the
end-of-epoch save after it is skipped.

The dataset iterator state (``ds_state``: the epoch order and the
per-position AR-group target shapes) is a JSON sidecar
``checkpoints/ds_state_<step>.json`` in the JAX package's format, byte for
byte, pruned with the checkpoints it belongs to. The JAX package's fallback
for legacy checkpoints that carry ``ds_state`` inside the orbax tree is
not ported: it reads orbax's ``_METADATA`` of checkpoints this package
never writes.

Saving is synchronous: ``wait`` and ``close`` have nothing to wait for.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

def _ds_state_to_jsonable(ds_state: Dict) -> Dict:
    """order (int array) + group_hw ({pos: (h, w)}) -> pure JSON types."""
    out: Dict[str, Any] = {}
    if "order" in ds_state:
        out["order"] = [int(v) for v in np.asarray(ds_state["order"]).ravel()]
    if "group_hw" in ds_state:
        out["group_hw"] = {
            str(int(k)): [int(v[0]), int(v[1])]
            for k, v in dict(ds_state["group_hw"]).items()
        }
    return out


def _ds_state_from_jsonable(blob: Dict) -> Dict:
    out: Dict[str, Any] = {}
    if "order" in blob:
        out["order"] = np.asarray(blob["order"], np.int64)
    if "group_hw" in blob:
        out["group_hw"] = {
            int(k): (int(v[0]), int(v[1])) for k, v in blob["group_hw"].items()
        }
    return out


class CheckpointManager:
    def __init__(self, work_dir: str, max_keep: int = 3):
        self.dir = os.path.abspath(os.path.join(work_dir, "checkpoints"))
        self.max_keep = int(max_keep)
        os.makedirs(self.dir, exist_ok=True)
        # a save cut by a kill leaves only its temporary directory
        for path in glob.glob(os.path.join(self.dir, ".tmp-*")):
            shutil.rmtree(path, ignore_errors=True)

    # -- ds_state sidecar ---------------------------------------------------

    def _sidecar_path(self, step: int) -> str:
        return os.path.join(self.dir, f"ds_state_{int(step)}.json")

    def save_ds_state(self, step: int, ds_state: Dict):
        path = self._sidecar_path(step)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(_ds_state_to_jsonable(ds_state), f)
        os.replace(tmp, path)
        self._prune_sidecars()

    def load_ds_state(self, step: int) -> Optional[Dict]:
        path = self._sidecar_path(step)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return _ds_state_from_jsonable(json.load(f))

    def _prune_sidecars(self):
        """Keep sidecars only for steps the manager still retains."""
        keep = set(self.all_steps())
        for path in glob.glob(os.path.join(self.dir, "ds_state_*.json")):
            try:
                step = int(os.path.basename(path)[len("ds_state_"):-len(".json")])
            except ValueError:
                continue
            if keep and step not in keep:
                try:
                    os.remove(path)
                except OSError:
                    pass

    # -- model / optimizer state --------------------------------------------

    def _remove(self, step: int):
        """Delete ``checkpoints/<step>/``, first moving it out of the
        steps' namespace, so a kill mid-delete leaves no partial step."""
        trash = os.path.join(self.dir, f".tmp-del-{step}-{os.getpid()}")
        os.replace(os.path.join(self.dir, str(step)), trash)
        shutil.rmtree(trash, ignore_errors=True)

    def all_steps(self) -> List[int]:
        """The saved steps, ascending."""
        return sorted(int(name) for name in os.listdir(self.dir)
                      if name.isdigit()
                      and os.path.isdir(os.path.join(self.dir, name)))

    def save(self, step: int, model_state: Dict, optimizer_state: Dict,
             extra: Optional[Dict[str, Any]] = None):
        """Write ``checkpoints/<step>/`` from the two ``state_dict``s and
        ``extra`` (JSON types; its ``ds_state`` goes to the sidecar). A
        step no later than the latest saved one is skipped, as orbax skips
        it; its sidecar is written all the same, as the JAX package's
        manager writes it."""
        extra = dict(extra or {})
        ds_state = extra.pop("ds_state", None)
        step = int(step)
        latest = self.latest_step()
        if latest is not None and step <= latest:
            if ds_state is not None:
                self.save_ds_state(step, ds_state)
            return
        tmp = os.path.join(self.dir, f".tmp-{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(model_state, os.path.join(tmp, "model.pt"))
        torch.save(optimizer_state, os.path.join(tmp, "optimizer.pt"))
        with open(os.path.join(tmp, "extra.json"), "w") as f:
            json.dump(extra, f)
        os.replace(tmp, os.path.join(self.dir, str(step)))
        if self.max_keep > 0:
            for s in self.all_steps()[:-self.max_keep]:
                self._remove(s)
        if ds_state is not None:
            self.save_ds_state(step, ds_state)
        else:
            self._prune_sidecars()

    def restore(self, step: Optional[int] = None, map_location="cpu"
                ) -> Optional[Tuple[int, Dict[str, Any]]]:
        """→ (step, {"model", "optimizer", "extra"}) of ``step`` (default the
        latest), tensors on ``map_location``; ``extra`` carries the
        ``ds_state`` sidecar when there is one. None when nothing is
        saved."""
        loaded = self.load_model(step, map_location)
        if loaded is None:
            return None
        step, model = loaded
        path = os.path.join(self.dir, str(step))
        state = {
            "model": model,
            "optimizer": torch.load(os.path.join(path, "optimizer.pt"),
                                    map_location=map_location,
                                    weights_only=True),
        }
        with open(os.path.join(path, "extra.json")) as f:
            state["extra"] = json.load(f)
        sidecar = self.load_ds_state(step)
        if sidecar is not None:
            state["extra"]["ds_state"] = sidecar
        return int(step), state

    def load_model(self, step: Optional[int] = None, map_location="cpu"
                   ) -> Optional[Tuple[int, Dict[str, Any]]]:
        """→ (step, the model's ``state_dict``) of ``step`` (default the
        latest), tensors on ``map_location``; None when nothing is saved.
        Reads neither the optimizer's state nor ``extra``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        return int(step), torch.load(
            os.path.join(self.dir, str(int(step)), "model.pt"),
            map_location=map_location, weights_only=True)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait(self):
        """Nothing to wait for: ``save`` returns once its files are in
        place."""

    def close(self):
        """Nothing to release (saves are synchronous)."""
