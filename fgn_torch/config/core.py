"""Config system: a copy of the JAX package's ``config/core.py``.

Two pieces, mirroring the reference's two config mechanisms:

1. ``Config`` — python-file configs with ``_base_`` composition, the
   equivalent of mmcv ``Config.fromfile`` as the reference uses it
   (reference: subprojects/sp02_omniiseg_fgn_mmdet/fgn_train.py:1-5,
   main.py:489). A config file is a plain python module; every
   non-underscore module-level name becomes a key. ``_base_`` is a list of
   paths (relative to the file) merged depth-first, later files and the
   file itself overriding earlier ones. Dict values merge recursively;
   a special key ``_delete_: True`` inside a dict replaces instead of
   merging.

2. ``apply_typed_config`` — the typed setattr loop used by the episodic
   dataset engine (reference: datasets/fewshotiseg/base_fst.py:176-189):
   each config key must match the type of an existing class attribute when
   one is defined; unknown keys are set as-is with a note.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict


class Config(dict):
    """A dict with attribute access, recursive over nested dicts."""

    def __getattr__(self, name: str) -> Any:
        try:
            v = self[name]
        except KeyError as e:
            raise AttributeError(name) from e
        if isinstance(v, dict) and not isinstance(v, Config):
            v = Config(v)
            self[name] = v
        return v

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        del self[name]

    def __deepcopy__(self, memo):
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def copy(self) -> "Config":
        return copy.deepcopy(self)

    # -- file loading -------------------------------------------------------

    @staticmethod
    def from_file(file_fp: str) -> "Config":
        file_fp = os.path.abspath(file_fp)
        merged = _load_py_config(file_fp)
        return Config(_wrap(merged))

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Config":
        return Config(_wrap(copy.deepcopy(d)))


def _wrap(v: Any) -> Any:
    if isinstance(v, dict):
        return Config({k: _wrap(x) for k, x in v.items()})
    if isinstance(v, (list, tuple)):
        return type(v)(_wrap(x) for x in v)
    return v


def _load_py_config(file_fp: str) -> Dict[str, Any]:
    ns: Dict[str, Any] = {"__file__": file_fp}
    with open(file_fp, "r") as f:
        code = f.read()
    exec(compile(code, file_fp, "exec"), ns)
    own = {
        k: v
        for k, v in ns.items()
        if not k.startswith("_") and not callable(v) and not _is_module(v)
    }
    base = {}
    for base_sp in ns.get("_base_", []) or []:
        base_fp = os.path.join(os.path.dirname(file_fp), base_sp)
        base = merge_dicts(base, _load_py_config(base_fp))
    return merge_dicts(base, own)


def _is_module(v: Any) -> bool:
    import types

    return isinstance(v, types.ModuleType)


def merge_dicts(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    out = copy.deepcopy(base)
    for k, v in override.items():
        if (
            isinstance(v, dict)
            and isinstance(out.get(k), dict)
            and not v.get("_delete_", False)
        ):
            out[k] = merge_dicts(out[k], v)
        else:
            v = copy.deepcopy(v)
            if isinstance(v, dict):
                v.pop("_delete_", None)
            out[k] = v
    return out


def apply_typed_config(obj: Any, config: Dict[str, Any], strict: bool = True) -> None:
    """Typed setattr loop (reference: datasets/fewshotiseg/base_fst.py:176-189).

    For every key in ``config``, if the object (class or instance) already
    defines the attribute, the new value must be an instance of the existing
    value's type; otherwise a TypeError is raised (when ``strict``).
    Keys without a pre-existing attribute are set as-is.
    """
    for key, value in config.items():
        try:
            required = type(getattr(obj, key))
            ok = isinstance(value, required)
            # Numpy ints/floats flow in from configs; accept numeric kin.
            if not ok and required in (int, float) and isinstance(value, (int, float)):
                ok = True
            if not ok and strict:
                raise TypeError(
                    f"Config key {key!r}: expected {required.__name__}, "
                    f"got {type(value).__name__}"
                )
        except AttributeError:
            pass
        setattr(obj, key, value)
