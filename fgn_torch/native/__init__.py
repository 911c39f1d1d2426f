"""Native (C++) host-side RLE, built on first use and loaded via ctypes.

``load()`` compiles ``rle.cc`` with the host C++ compiler (``g++``, else
``c++``; ``-O3 -fPIC -std=c++17 -shared``) into ``fgn_torch/_build/``
(listed in ``.gitignore``), under a name hashed from the source and the
flags, and loads it; later calls return the loaded library. Nothing is
compiled or loaded at import time. On a host without a C++ compiler it
returns None and ``fgn_torch/data/rle.py`` takes its numpy path; a source
that does not compile raises. The .so is never committed.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_DIR = Path(__file__).resolve().parent
SRC = _DIR / "rle.cc"
BUILD_DIR = _DIR.parent / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")

_LL, _P, _F = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_float
_SIGNATURES = {
    "rle_encode": ([_P, _LL, _LL, ctypes.c_char_p, _LL], _LL),
    "rle_decode": ([ctypes.c_char_p, _LL, _LL, _LL, _P], _LL),
    "rle_area": ([ctypes.c_char_p, _LL], _LL),
    "rle_paste_encode": (
        [_P, _LL, _F, _F, _F, _F, _LL, _LL, _F, ctypes.c_char_p, _LL], _LL),
}

_lock = threading.Lock()
_loaded: dict = {}


def _target() -> Path:
    digest = hashlib.sha256(
        SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"librle_{digest[:16]}.so"


def _compile(cxx: str, out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SRC)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed on native/rle.cc:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builders never see a partial file


def load() -> Optional["RleNative"]:
    """The native RLE library, compiled first if missing; None on a host
    without a C++ compiler."""
    with _lock:
        if "lib" not in _loaded:
            out = _target()
            cxx = shutil.which("g++") or shutil.which("c++")
            if not out.exists() and cxx is None:
                _loaded["lib"] = None
            else:
                if not out.exists():
                    _compile(cxx, out)
                lib = ctypes.CDLL(str(out))
                for fn, (argtypes, restype) in _SIGNATURES.items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = restype
                _loaded["lib"] = RleNative(lib)
        return _loaded["lib"]


def _capacity(h: int, w: int) -> int:
    """Bytes enough for the compressed counts of any h×w mask."""
    return 16 + 8 * (h * w // 2 + 2)


class RleNative:
    """The subset of ``fgn_torch.data.rle`` that the library accelerates."""

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib

    def encode(self, mask: np.ndarray):
        h, w = mask.shape
        mask = np.ascontiguousarray(mask, dtype=np.uint8)
        cap = _capacity(h, w)
        buf = ctypes.create_string_buffer(cap)
        n = self._lib.rle_encode(
            mask.ctypes.data_as(ctypes.c_void_p), h, w, buf, cap)
        if n < 0:  # pragma: no cover - the capacity covers every mask
            raise RuntimeError("rle_encode buffer overflow")
        return {"size": [int(h), int(w)], "counts": buf.raw[:n]}

    def decode(self, counts: bytes, h: int, w: int) -> np.ndarray:
        out = np.empty((h, w), dtype=np.uint8)
        rc = self._lib.rle_decode(
            counts, len(counts), h, w, out.ctypes.data_as(ctypes.c_void_p))
        if rc != 0:
            raise ValueError("invalid RLE: run total != h*w")
        return out

    def area(self, counts: bytes) -> int:
        return int(self._lib.rle_area(counts, len(counts)))

    def paste_encode(self, probs: np.ndarray, box, img_h: int, img_w: int,
                     thr: float = 0.5):
        """Fused bilinear paste + threshold + RLE encode of one detection:
        (m, m) float probs + XYXY box → compressed RLE dict. Never
        materializes the (img_h, img_w) canvas."""
        probs = np.ascontiguousarray(probs, dtype=np.float32)
        m = probs.shape[0]
        if probs.shape != (m, m):
            raise ValueError(f"paste_encode: probs shape {probs.shape}")
        x0, y0, x1, y1 = (float(v) for v in box)
        cap = _capacity(img_h, img_w)
        buf = ctypes.create_string_buffer(cap)
        n = self._lib.rle_paste_encode(
            probs.ctypes.data_as(ctypes.c_void_p), m,
            x0, y0, x1, y1, img_h, img_w, thr, buf, cap)
        if n < 0:  # pragma: no cover - the capacity covers every mask
            raise RuntimeError("rle_paste_encode buffer overflow")
        return {"size": [int(img_h), int(img_w)], "counts": buf.raw[:n]}
