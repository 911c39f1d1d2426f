"""Greedy-NMS keep mask: hand-written CUDA kernel + plain version.

Counterpart of the JAX package's ``ops/nms_pallas.py::greedy_alive_pallas``
and the ``alive_fn`` that ``ops/nms.py::nms_padded`` takes.
``greedy_alive_cuda`` launches ``csrc/nms.cu`` for CUDA tensors (a bitmask
pass over the upper triangle, then one serial walk per image) and uses the
blocked sweep ``ops/nms.py::_greedy_alive`` only for CPU tensors. Both give
the same bits.
"""

from __future__ import annotations

import torch

from fgn_torch.ops import _build
from fgn_torch.ops.boxes import box_area
from fgn_torch.ops.nms import _greedy_alive


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
    keep = torch.empty((B, Mp), dtype=torch.bool, device=boxes_s.device)
    if B == 0 or Mp == 0:
        return keep
    # Areas as the reference computes them: max(x2-x1,0) * max(y2-y1,0).
    areas = box_area(boxes_s).contiguous()
    nw = -(-Mp // 64)
    scratch = torch.empty((B, Mp, nw), dtype=torch.int64, device=boxes_s.device)
    lib = _build.load("nms")
    rc = lib.fgn_nms_keep(
        boxes_s.data_ptr(), areas.data_ptr(), alive.data_ptr(),
        scratch.data_ptr(), keep.data_ptr(), B, Mp, float(iou_threshold),
        torch.cuda.current_stream(boxes_s.device).cuda_stream,
    )
    _build.check(lib, "fgn_nms_error_string", rc, "nms kernel")
    greedy_alive_cuda.launches += 1
    return keep


greedy_alive_cuda.launches = 0
