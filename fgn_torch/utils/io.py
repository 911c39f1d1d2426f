"""Safe directory / file IO helpers.

A copy of the JAX package's ``utils/io.py`` (the reference's
``cp_utils/cp_dir_file_ops.py:74-186`` minus ``define_env``), without
``image_size``, which needs PIL and which nothing of the port calls.

Conventions kept from the reference:
  * ``*_safe`` creators refuse to act when the target already exists
    (or, for writers, when the file exists — no silent overwrite);
  * ``*_unsafe`` variants clobber.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
from typing import Any

import numpy as np


# --------------------------------------------------------------------------
# Directories
# --------------------------------------------------------------------------

def check_dir_if_exists(dir_fp: str) -> bool:
    return os.path.isdir(dir_fp)


def check_file_if_exists(file_fp: str) -> bool:
    return os.path.isfile(file_fp)


def create_empty_dir_safe(dir_fp: str) -> None:
    """Create a directory; error if a *file* occupies the path. Existing
    directories are left untouched (contents preserved)."""
    if os.path.isfile(dir_fp):
        raise FileExistsError(f"A file exists at {dir_fp}")
    os.makedirs(dir_fp, exist_ok=True)


def create_empty_dir_unsafe(dir_fp: str) -> None:
    """Create a directory, wiping any previous contents."""
    if os.path.isdir(dir_fp):
        shutil.rmtree(dir_fp)
    os.makedirs(dir_fp)


def remove_dir_safe(dir_fp: str) -> bool:
    """Remove a directory only if it is empty. Returns True on removal."""
    if not os.path.isdir(dir_fp):
        return False
    if os.listdir(dir_fp):
        return False
    os.rmdir(dir_fp)
    return True


def remove_dir_unsafe(dir_fp: str) -> bool:
    if not os.path.isdir(dir_fp):
        return False
    shutil.rmtree(dir_fp)
    return True


# --------------------------------------------------------------------------
# JSON
# --------------------------------------------------------------------------

def read_json(file_fp: str) -> Any:
    with open(file_fp, "r") as f:
        return json.load(f)


def write_json_unsafe(file_fp: str, data: Any) -> None:
    with open(file_fp, "w") as f:
        json.dump(data, f)


def write_json_safe(file_fp: str, data: Any) -> None:
    if os.path.exists(file_fp):
        raise FileExistsError(f"Refusing to overwrite {file_fp}")
    write_json_unsafe(file_fp, data)


# --------------------------------------------------------------------------
# Pickle
# --------------------------------------------------------------------------

def read_pkl(file_fp: str) -> Any:
    with open(file_fp, "rb") as f:
        return pickle.load(f)


def write_pkl_unsafe(file_fp: str, data: Any) -> None:
    with open(file_fp, "wb") as f:
        pickle.dump(data, f, protocol=pickle.HIGHEST_PROTOCOL)


def write_pkl_safe(file_fp: str, data: Any) -> None:
    if os.path.exists(file_fp):
        raise FileExistsError(f"Refusing to overwrite {file_fp}")
    write_pkl_unsafe(file_fp, data)


# --------------------------------------------------------------------------
# NumPy
# --------------------------------------------------------------------------

def read_np(file_fp: str) -> np.ndarray:
    return np.load(file_fp, allow_pickle=False)


def write_np_safe(file_fp: str, arr: np.ndarray) -> None:
    if os.path.exists(file_fp):
        raise FileExistsError(f"Refusing to overwrite {file_fp}")
    np.save(file_fp, arr, allow_pickle=False)


# --------------------------------------------------------------------------
# Misc
# --------------------------------------------------------------------------

def give_mem() -> float:
    """Resident memory of this process as a percent of total RAM
    (reference: cp_utils/cp_dir_file_ops.py:20-23)."""
    try:
        import psutil

        return psutil.Process(os.getpid()).memory_percent()
    except Exception:  # pragma: no cover - psutil should exist
        return float("nan")

