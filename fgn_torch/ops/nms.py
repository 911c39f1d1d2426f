"""Padded NMS with static output shapes and exact greedy semantics.

Port of the JAX package's ``ops/nms.py``, with a leading batch dimension
in place of ``vmap`` so that the keep-mask kernel is launched once per NMS
call, not once per image:

  * candidates are sorted by score, descending and stable (ties keep the
    lower index, as ``lax.top_k`` does: ``torch.sort(..., stable=True)``,
    never ``torch.topk``, which breaks ties differently);
  * invalid entries get a score of -inf and are never kept;
  * the keep mask over the sorted, block-padded candidates comes from
    ``alive_fn(boxes_s, alive, iou_threshold, block)``: by default the
    kernel wrapper ``ops/nms_cuda.py::greedy_alive_cuda``, which launches
    the CUDA kernel on the card and takes the blocked sweep
    ``_greedy_alive`` below (its plain version) on the CPU;
  * the survivors fill ``max_out`` slots in score order, padded with
    zeros and ``valid=False``.
"""

from __future__ import annotations

import torch

from fgn_torch.ops.boxes import box_iou


def _sort_desc(x: torch.Tensor):
    return torch.sort(x, dim=-1, descending=True, stable=True)


def _self_suppress_block(iou_bb: torch.Tensor, valid: torch.Tensor):
    """Exact greedy keep-vector of one block per image.

    iou_bb (B, b, b) bool IoU > thr, valid (B, b) bool. The fixpoint of
    keep_j = valid_j & !any_{k<j}(keep_k & iou[k, j])."""
    b = valid.shape[-1]
    tri = torch.ones((b, b), dtype=torch.bool, device=valid.device).triu(1)
    adj = iou_bb & tri  # adj[k, j]: k can suppress j (k strictly earlier)
    keep, prev = valid, torch.zeros_like(valid)
    it = 0
    while it < b and bool((keep != prev).any()):
        suppressed = (adj & keep[:, :, None]).any(dim=1)
        keep, prev = valid & ~suppressed, keep
        it += 1
    return keep


def _greedy_alive(boxes_s, alive, iou_threshold: float, block: int = 128):
    """Blocked greedy sweep over score-sorted padded boxes: the plain
    version of the NMS kernel.

    boxes_s (B, Mp, 4) XYXY with Mp a multiple of ``block``; alive (B, Mp)
    bool. Returns the greedy keep mask (B, Mp) bool."""
    Mp = boxes_s.shape[1]
    thr = iou_threshold  # a Python float: compared in f32, as in JAX
    alive = alive.clone()
    for i in range(Mp // block):
        lo, hi = i * block, (i + 1) * block
        blk_boxes = boxes_s[:, lo:hi]
        blk_keep = _self_suppress_block(
            box_iou(blk_boxes, blk_boxes) > thr, alive[:, lo:hi]
        )
        alive[:, lo:hi] = blk_keep
        if hi < Mp:  # the finished block suppresses every later box
            cross = box_iou(blk_boxes, boxes_s[:, hi:]) > thr  # (B, b, rest)
            alive[:, hi:] &= ~(cross & blk_keep[:, :, None]).any(dim=1)
    return alive


_CHUNK = 32  # rows per greedy decision of the CUDA kernel: a warp's width


def _greedy_alive_walk(boxes_s, alive, iou_threshold: float,
                       chunk: int = _CHUNK):
    """The CUDA kernel's walk (``csrc/nms.cu::nms_walk``) in torch, for the
    tests: the same chunks, the same rows suppressing the same columns, the
    same chunks skipped. Iteration t decides chunk t (candidates: alive, not
    yet suppressed, and not suppressed by a kept row of chunk t-1; then the
    greedy fixpoint inside the chunk), while the kept rows of chunk t-1
    suppress the columns of chunks t+1 and later. Chunks after the last
    alive row are never walked. Same arguments and result as
    ``_greedy_alive``; any Mp."""
    B, Mp = alive.shape
    thr = iou_threshold
    removed = ~alive
    keep = torch.zeros_like(alive)
    rows_alive = alive.any(0).nonzero()
    n_end = -(-(int(rows_alive[-1]) + 1) // chunk) if len(rows_alive) else 0
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=alive.device).triu(1)
    kprev = None  # kept rows of chunk t-1, (B, chunk)
    for t in range(n_end):
        lo, hi = t * chunk, min((t + 1) * chunk, Mp)
        rows = boxes_s[:, lo:hi]
        n = hi - lo
        cand = ~removed[:, lo:hi]
        if kprev is not None:  # table T: chunk t-1's rows against chunk t
            prev = boxes_s[:, lo - chunk:lo]
            cand &= ~((box_iou(prev, rows) > thr) & kprev[:, :, None]).any(1)
        adj = (box_iou(rows, rows) > thr) & tri[:n, :n]  # table S, i < j
        kept = cand
        while True:
            nxt = cand & ~(adj & kept[:, :, None]).any(1)
            if torch.equal(nxt, kept):
                break
            kept = nxt
        keep[:, lo:hi] = kept
        if kprev is not None and hi < Mp:  # chunk t-1 suppresses t+1 on
            prev = boxes_s[:, lo - chunk:lo]
            hit = (box_iou(prev, boxes_s[:, hi:]) > thr) & kprev[:, :, None]
            removed[:, hi:] |= hit.any(1)
        kprev = kept
    return keep


def nms_padded(boxes, scores, valid, iou_threshold: float, max_out: int,
               block: int = 128, alive_fn=None):
    """Greedy NMS over the valid boxes of each image.

    boxes (B, M, 4) XYXY, scores (B, M), valid (B, M) bool. Returns
    (boxes (B, max_out, 4), scores (B, max_out), idx (B, max_out) int32
    indices into the input, out_valid (B, max_out) bool), score-sorted."""
    B, M = scores.shape
    neg_inf = torch.tensor(float("-inf"), dtype=scores.dtype, device=scores.device)
    s_sorted, order = _sort_desc(torch.where(valid, scores, neg_inf))
    boxes_s = torch.gather(boxes, 1, order[..., None].expand(B, M, 4))
    alive = torch.isfinite(s_sorted)

    pad = -(-M // block) * block - M
    if pad:
        boxes_s = torch.cat([boxes_s, boxes_s.new_zeros((B, pad, 4))], dim=1)
        alive = torch.cat([alive, alive.new_zeros((B, pad))], dim=1)
    if alive_fn is None:  # imported here: nms_cuda imports this module
        from fgn_torch.ops.nms_cuda import greedy_alive_cuda as alive_fn
    alive = alive_fn(
        boxes_s.contiguous(), alive.contiguous(), iou_threshold, block
    )[:, :M]

    keep_scores = torch.where(alive, s_sorted, neg_inf)
    k_out = min(max_out, M)
    out_scores, keep_pos = _sort_desc(keep_scores)
    out_scores, keep_pos = out_scores[:, :k_out], keep_pos[:, :k_out]
    if k_out < max_out:  # fewer candidates than requested slots
        fill = max_out - k_out
        out_scores = torch.cat([out_scores, neg_inf.expand(B, fill)], dim=1)
        keep_pos = torch.cat([keep_pos, keep_pos.new_zeros((B, fill))], dim=1)
    out_valid = torch.isfinite(out_scores)
    out_idx = torch.gather(order, 1, keep_pos)
    out_boxes = torch.gather(boxes_s, 1, keep_pos[..., None].expand(-1, -1, 4))
    zero = torch.zeros((), dtype=scores.dtype, device=scores.device)
    out_scores = torch.where(out_valid, out_scores, zero)
    out_boxes = torch.where(out_valid[..., None], out_boxes, zero)
    return out_boxes, out_scores, out_idx.to(torch.int32), out_valid


def batched_nms(boxes, scores, class_ids, valid, iou_threshold: float,
                max_out: int, coord_bound: float = 1e4, block: int = 128,
                alive_fn=None):
    """Per-class NMS via the coordinate-offset trick (classes never overlap).

    boxes (B, M, 4), scores (B, M), class_ids (B, M) int, valid (B, M).
    Returns (boxes, scores, classes, idx, valid), each with max_out slots."""
    shifted = boxes + class_ids.to(boxes.dtype)[..., None] * coord_bound
    _, out_scores, out_idx, out_valid = nms_padded(
        shifted, scores, valid, iou_threshold, max_out, block=block,
        alive_fn=alive_fn,
    )
    idx = out_idx.long()
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    out_boxes = torch.where(
        out_valid[..., None],
        torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4)), zero,
    )
    out_cls = torch.where(
        out_valid, torch.gather(class_ids, 1, idx),
        torch.zeros((), dtype=class_ids.dtype, device=class_ids.device),
    )
    return out_boxes, out_scores, out_cls, out_idx, out_valid
