"""Greedy-NMS keep mask: hand-written CUDA kernel + plain version.

Counterpart of the JAX package's ``ops/nms_pallas.py::greedy_alive_pallas``
and the ``alive_fn`` that ``ops/nms.py::nms_padded`` takes.
``greedy_alive_cuda`` launches ``csrc/nms.cu``'s walk for CUDA tensors (one
launch per call: a cluster of blocks per image walks its candidates in
chunks of 32, testing only kept rows against later columns still alive)
and uses the blocked sweep ``ops/nms.py::_greedy_alive`` only for CPU
tensors. Both give the same bits; ``ops/nms.py::_greedy_alive_walk``
repeats the kernel's order in torch, for the tests.

The kernel holds the image's boxes and areas in shared memory where they
fit (``_staged``); a larger Mp takes the same walk reading them from device
memory, counted apart as ``k2.unstaged`` (``utils/profiling.py``'s
``count``; the staged walk's as ``k2.staged``).
``_cluster_size`` picks the blocks per image.
"""

from __future__ import annotations

import functools

import torch

from fgn_torch.ops import _build
from fgn_torch.ops.nms import _CHUNK, _greedy_alive
from fgn_torch.utils.profiling import count

# The walk kernel's dynamic shared memory (csrc/nms.cu::kWalkSmemMax): the
# SM's 227 KB less 1 KB for its static tables.
_WALK_SMEM_MAX = 232_448 - 1024
_MAX_CLUSTER = 16


def _walk_smem(Mp: int, staged: bool) -> int:
    """Dynamic shared memory of one walk block (``walk_smem_bytes``): per
    chunk a 64-bit mailbox slot and a 32-bit word of removed bits (rounded
    up to 16 bytes), and the image's boxes and areas, 20 bytes a candidate,
    when staged."""
    return -(-12 * -(-Mp // _CHUNK) // 16) * 16 + (20 * Mp if staged else 0)


def _staged(Mp: int) -> bool:
    """Whether the boxes and areas of an image of Mp candidates fit in a
    block's shared memory (up to Mp = 11,357)."""
    return _walk_smem(Mp, True) <= _WALK_SMEM_MAX


def _cluster_size(B: int, Mp: int, fits) -> int:
    """Blocks per image: the largest power of two up to ``_MAX_CLUSTER``
    that leaves each block two chunks or more and lets the card run the B
    clusters at once; ``fits(G)`` is the number of clusters of G blocks the
    card can hold (``_max_clusters``). A cluster that must wait for another
    to finish would double the walk's time."""
    g = _MAX_CLUSTER
    while g > 1 and (2 * g * _CHUNK > Mp or fits(g) < B):
        g //= 2
    return g


@functools.lru_cache(maxsize=256)
def _max_clusters(device: int, g: int, Mp: int, staged: bool) -> int:
    """Clusters of g walk blocks the card can run at once (the CUDA
    occupancy query), for an image of Mp candidates."""
    lib = _build.load("nms")
    with torch.cuda.device(device):
        n = lib.fgn_nms_walk_clusters(g, Mp, int(staged))
    if n < 0:
        _build.check(lib, "fgn_nms_error_string", -n, "nms occupancy query")
    return n


def greedy_alive_cuda(boxes_s, alive, iou_threshold: float, block: int = 128):
    """``alive_fn`` for ``nms_padded``: boxes_s (B, Mp, 4) f32 score-sorted
    XYXY, alive (B, Mp) bool, Mp a multiple of ``block``. → (B, Mp) bool."""
    if boxes_s.device.type == "cpu":
        return _greedy_alive(boxes_s, alive, iou_threshold, block)
    if boxes_s.device.type != "cuda":
        raise ValueError(f"greedy_alive_cuda: unsupported device {boxes_s.device}")
    if boxes_s.dim() != 3 or boxes_s.shape[-1] != 4:
        raise ValueError(f"greedy_alive_cuda: boxes_s must be (B,Mp,4), got "
                         f"{tuple(boxes_s.shape)}")
    B, Mp = boxes_s.shape[:2]
    if alive.shape != (B, Mp) or alive.dtype != torch.bool:
        raise ValueError("greedy_alive_cuda: alive must be (B, Mp) bool")
    if boxes_s.dtype != torch.float32:
        raise TypeError(f"greedy_alive_cuda: boxes must be float32, got "
                        f"{boxes_s.dtype}")
    if alive.device != boxes_s.device:
        raise ValueError("greedy_alive_cuda: boxes and alive on different devices")
    if not (boxes_s.is_contiguous() and alive.is_contiguous()):
        raise ValueError("greedy_alive_cuda: inputs must be contiguous")
    if Mp % block or boxes_s.data_ptr() % 16:
        raise ValueError(f"greedy_alive_cuda: Mp={Mp} must be a multiple of "
                         f"block={block}, boxes 16-byte aligned")
    staged = _staged(Mp)
    if _walk_smem(Mp, staged) > _WALK_SMEM_MAX or B > 65535:
        raise ValueError(f"greedy_alive_cuda: B={B}, Mp={Mp} too large")
    keep = torch.empty((B, Mp), dtype=torch.bool, device=boxes_s.device)
    if B == 0 or Mp == 0:
        return keep
    dev = boxes_s.device.index
    if dev is None:
        dev = torch.cuda.current_device()
    G = _cluster_size(B, Mp, lambda g: _max_clusters(dev, g, Mp, staged))
    lib = _build.load("nms")
    rc = lib.fgn_nms_keep(
        boxes_s.data_ptr(), alive.data_ptr(), keep.data_ptr(), B, Mp,
        float(iou_threshold), G, int(staged),
        torch.cuda.current_stream(boxes_s.device).cuda_stream,
    )
    _build.check(lib, "fgn_nms_error_string", rc, "nms kernel")
    count("k2.staged" if staged else "k2.unstaged")
    return keep
