"""The optimizer's update in one launch (K5): wrapper of the hand-written
multi-tensor CUDA kernel ``csrc/optim.cu``.

``FGNOptimizer.step`` (``train/optim.py``) hands this module every tensor of
a step that ``takes`` accepts: a CUDA float32 parameter under Adagrad or
Adam. ``record`` checks that it fills its memory in order and that its
gradient (or None, read as zero) and its state are float32 in its layout,
and raises where they are not; ``run`` applies the scaler, the decoupled
weight decay and the update to all of a device's tensors in
``csrc/optim.cu``'s launches, on the current stream, without synchronising
and without copying anything to the card: a launch's tensors and its block
→ (tensor, chunk) table travel in its kernel parameters. Every other tensor (the CPU, float64, SGD, Adadelta)
stays on the optimizer's plain route.

``plan`` cuts the tensors into launches (at most ``MAX_TENSORS`` tensors
and ``MAX_BLOCKS`` blocks of ``CHUNK`` elements each) and ``pack`` writes
their records. Counters (``utils/profiling.py``'s ``count``):
``k5.launches`` here, ``k5.tensors`` in the optimizer.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from fgn_torch.ops import _build
from fgn_torch.utils.profiling import count

# csrc/optim.cu's kMaxTensors, kMaxBlocks, kChunk: a launch's parameter
# block holds MAX_TENSORS records of 56 bytes and MAX_BLOCKS table entries
# of 4 (32,544 of the 32,764 bytes a kernel's parameters may take).
MAX_TENSORS = 224
MAX_BLOCKS = 5000
CHUNK = 16384
RULES = {"adagrad": 0, "adam": 1}

# csrc/optim.cu's TensorRec: pointers as integers, 0 for a null gradient.
TENSOR = np.dtype([("p", "<u8"), ("g", "<u8"), ("s0", "<u8"), ("s1", "<u8"),
                   ("n", "<i8"), ("step", "<f4"), ("wd", "<f4"),
                   ("r1", "<f4"), ("r2", "<f4")])


class Launch(NamedTuple):
    """One launch: the step's tensors it updates (indices, in its record
    order) and its blocks, each ``slot | chunk << 8`` with ``slot`` the
    tensor's place in ``tensors``."""

    tensors: np.ndarray  # int64
    blocks: np.ndarray  # uint32


def takes(kind: str, p: torch.Tensor) -> bool:
    """Whether K5 updates ``p``: a CUDA float32 tensor under Adagrad or
    Adam."""
    return p.is_cuda and p.dtype == torch.float32 and kind in RULES


def _layout(t: torch.Tensor):
    """The memory format in which ``t``'s elements fill its memory in order
    (contiguous, or a 4-d tensor's channels_last), or None."""
    if t.is_contiguous():
        return torch.contiguous_format
    if t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last):
        return torch.channels_last
    return None


def record(p: torch.Tensor, g, states: Sequence[torch.Tensor], step: float,
           wd: float, r1: float = 0.0, r2: float = 0.0) -> tuple:
    """``p``'s row for ``pack``: its pointers (0 for a None gradient),
    length, step, decay and Adam's reciprocal bias corrections. The kernel
    walks the tensors' memory as one flat run, so ``p`` has to fill its
    memory in order, and its gradient and state have to be float32 in its
    layout; anything else raises. (Torch keeps a gradient on its
    parameter's device and shape, and the optimizer makes its state like
    ``p``, or casts loaded state to ``p``'s device.)"""
    fmt = _layout(p)
    if fmt is None:
        raise ValueError(f"optimizer kernel: parameter {tuple(p.shape)} with "
                         f"strides {p.stride()} does not fill its memory")
    for t in (g, *states):
        if t is not None and (t.dtype != torch.float32
                              or not t.is_contiguous(memory_format=fmt)):
            raise ValueError(
                f"optimizer kernel: gradient or state {t.dtype} strides "
                f"{t.stride()}, parameter {tuple(p.shape)} strides "
                f"{p.stride()}")
    return (p.data_ptr(), 0 if g is None else g.data_ptr(),
            states[0].data_ptr(), states[1].data_ptr() if len(states) > 1
            else 0, p.numel(), step, wd, r1, r2)


@functools.lru_cache(maxsize=16)
def plan(numels: Tuple[int, ...]) -> Tuple[Launch, ...]:
    """The launches of tensors of ``numels`` elements: each tensor's chunks
    in order, a new launch when one has ``MAX_TENSORS`` tensors or
    ``MAX_BLOCKS`` blocks (a tensor can then continue in the next). Empty
    tensors take no block."""
    launches, tensors, blocks, n_blocks = [], [], [], 0
    for i, n in enumerate(numels):
        done, chunks = 0, -(-n // CHUNK)
        while done < chunks:
            if len(tensors) == MAX_TENSORS or n_blocks == MAX_BLOCKS:
                launches.append(_launch(tensors, blocks))
                tensors, blocks, n_blocks = [], [], 0
            take = min(chunks - done, MAX_BLOCKS - n_blocks)
            chunk = np.arange(done, done + take, dtype=np.uint32)
            blocks.append(np.uint32(len(tensors)) | (chunk << np.uint32(8)))
            tensors.append(i)
            done += take
            n_blocks += take
    if tensors:
        launches.append(_launch(tensors, blocks))
    return tuple(launches)


def _launch(tensors: List[int], blocks: List[np.ndarray]) -> Launch:
    return Launch(np.asarray(tensors, dtype=np.int64), np.concatenate(blocks))


def pack(rows: Sequence[tuple]) -> np.ndarray:
    """The ``TENSOR`` records of a step's tensors, from ``record``'s
    rows."""
    return np.array(rows, dtype=TENSOR)


def run(kind: str, records: np.ndarray, launches: Sequence[Launch],
        device: torch.device) -> None:
    """Every launch of a step on ``device``'s current stream."""
    lib = _build.load("optim")
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        for launch in launches:
            recs = records[launch.tensors]
            rc = lib.fgn_optim_step(RULES[kind], recs.ctypes.data, len(recs),
                                    launch.blocks.ctypes.data,
                                    len(launch.blocks), stream)
            _build.check(lib, "fgn_optim_error_string", rc,
                         "optimizer kernel")
    count("k5.launches", len(launches))
