"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
use by ``nvcc`` for Hopper (sm_90a) into a shared library under
``fgn_torch/_build/`` (listed in ``.gitignore``), named by a hash of its
source and flags, then loaded with ``ctypes``. Pointers and the CUDA stream
go to the C functions as ``c_void_p``. Nothing is compiled or loaded at
import time. ``load_all`` loads every source; the ones still to compile
get one ``nvcc`` process each, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Tuple

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# C signatures of the exported functions, per source.
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    "roi_align": {
        "fgn_roi_align_forward": (
            [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P], _I),
        "fgn_roi_align_forward_staged": (
            [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I, _P],
            _I),
        "fgn_roi_align_backward_staged": (
            [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I, _P],
            _I),
        "fgn_roi_align_backward": (
            [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P], _I),
        "fgn_roi_align_error_string": ([_I], ctypes.c_char_p),
    },
    "nms": {
        "fgn_nms_keep": ([_P, _P, _P, _I, _I, _F, _I, _I, _P], _I),
        "fgn_nms_walk_clusters": ([_I, _I, _I], _I),
        "fgn_nms_error_string": ([_I], ctypes.c_char_p),
    },
    "group_norm": {
        "fgn_group_norm": (
            [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _I,
             _I, _P], _I),
        "fgn_group_norm_backward": (
            [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
             _I, _I, _I, _I, _P], _I),
        "fgn_group_norm_error_string": ([_I], ctypes.c_char_p),
    },
    "vit_attention": {
        "fgn_vit_attention": (
            [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _L, _L, _L,
             _L, _L, _L, _I, _F, _P], _I),
        "fgn_vit_attention_error_string": ([_I], ctypes.c_char_p),
    },
    "optim": {
        "fgn_optim_step": ([_I, _P, _I, _P, _I, _P], _I),
        "fgn_optim_error_string": ([_I], ctypes.c_char_p),
    },
}

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# nvcc's output (ptxas register and spill counts) of each source compiled
# by this process.
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are compiled on first use and "
            "need the CUDA toolkit"
        )
    return path


def _target(name: str) -> Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def _start(name: str) -> Tuple[subprocess.Popen, Path, Path]:
    out = _target(name)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish(name: str, proc: subprocess.Popen, tmp: Path, out: Path) -> str:
    """Wait for nvcc; "" on success (its log goes to build_logs), else the
    error."""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return f"nvcc failed on csrc/{name}.cu:\n{log}"
    os.replace(tmp, out)  # atomic: concurrent builders never see a partial file
    build_logs[name] = log
    return ""


def load_all(names: Iterable[str] = tuple(_SIGNATURES)) -> Dict[str, ctypes.CDLL]:
    """The loaded library of each ``csrc/<name>.cu``. Sources whose library
    is missing are compiled first, all at once."""
    names = tuple(names)
    with _lock:
        todo = [n for n in names if n not in _loaded]
        jobs = {n: _start(n) for n in todo if not _target(n).exists()}
        # wait for every nvcc before raising, so none is left running
        errors = [e for e in (_finish(n, *job) for n, job in jobs.items()) if e]
        if errors:
            raise RuntimeError("\n".join(errors))
        for n in todo:
            lib = ctypes.CDLL(str(_target(n)))
            for fn, (argtypes, restype) in _SIGNATURES[n].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = restype
            _loaded[n] = lib
        return {n: _loaded[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, compiled first if missing."""
    return load_all((name,))[name]


def check(lib: ctypes.CDLL, err_fn: str, rc: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if rc != 0:
        msg = getattr(lib, err_fn)(rc).decode()
        raise RuntimeError(f"{what} failed to launch: CUDA error {rc} ({msg})")
