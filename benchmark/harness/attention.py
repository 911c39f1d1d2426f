"""The least work of the ViT's attention with decomposed relative
positions, from its shapes: ``softmax(q·kᵀ/√d + bias)·v`` with
``bias[q, k] = q·Rh[row(q), row(k)] + q·Rw[col(q), col(k)]``, counted on
the mathematics, whatever computes it (the library's attention over a
bias built in memory, or one kernel that builds the bias itself).

FLOPs: a multiply-add for each of d entries of every score and of every
score's share of the output (4·d a score), and for each of d entries of
the kh + kw bias terms of a query row (2·d·(kh + kw) a row). Bytes: q, k
and v read once, the output written once, the two gathered tables read
once. The least time is the larger of FLOPs over the card's peak and
bytes over its bandwidth.
"""

from __future__ import annotations

from typing import Dict, Sequence


def _numel(shape: Sequence[int]) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def attn_flops(q: Sequence[int], k: Sequence[int], rh: Sequence[int],
               rw: Sequence[int]) -> int:
    """q (B, heads, Tq, d), k (B, heads, Tk, d); rh (h, kh, d), rw (w, kw, d)."""
    B, nh, Tq, d = q
    Tk = k[2]
    return 4 * d * B * nh * Tq * Tk + 2 * d * B * nh * Tq * (rh[1] + rw[1])


def attn_bytes(q, k, v, rh, rw, itemsize: int) -> int:
    return itemsize * (2 * _numel(q) + _numel(k) + _numel(v) + _numel(rh) + _numel(rw))


def roofline_s(call: Dict, peak_flops: float, hbm_bytes_s: float) -> float:
    """The least seconds of one ``Attention.attend`` call, from the span's
    record of its arguments (q, k, v, rh, rw)."""
    q, k, v, rh, rw = call["args"][:5]
    shapes = [a["shape"] for a in (q, k, v, rh, rw)]
    return max(attn_flops(shapes[0], shapes[1], shapes[3], shapes[4]) / peak_flops,
               attn_bytes(*shapes, q["itemsize"]) / hbm_bytes_s)
