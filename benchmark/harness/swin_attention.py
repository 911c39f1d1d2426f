"""The least work of Swin's window attention, from its shapes:
``softmax(q·kᵀ/√d + B[h] (+ M))·v`` within each window, B[h] gathered
from the learned relative-position table and M the shifted windows'
region mask, counted on the mathematics, whatever computes it (the
library's attention over a bias and a mask built in memory, or one kernel
that gathers the table and makes the mask inside its tiles).

FLOPs: a multiply-add for each of d entries of every score and of every
score's share of the output (4·d a score), padded tokens included. Bytes:
q, k and v read once, the output written once, the gathered table
(heads·N·Nk entries) read once and, in a shifted block, the mask
(windows·N·Nk entries) read once, all at q's item size. The least time is
the larger of FLOPs over the card's peak and bytes over its bandwidth.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence


def _numel(shape: Sequence[int]) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def attn_flops(q: Sequence[int], k: Sequence[int]) -> int:
    """q (B, nW, heads, N, d), k (B, nW, heads, Nk, d)."""
    B, nW, nh, N, d = q
    return 4 * d * B * nW * nh * N * k[3]


def attn_bytes(q, k, v, mask: Optional[Sequence[int]], itemsize: int) -> int:
    """q, k, v as in ``attn_flops``; ``mask`` (nW, N, Nk) or None."""
    nh, N, Nk = q[2], q[3], k[3]
    table = nh * N * Nk
    return itemsize * (2 * _numel(q) + _numel(k) + _numel(v) + table
                       + (_numel(mask) if mask is not None else 0))


def roofline_s(call: Dict, peak_flops: float, hbm_bytes_s: float) -> float:
    """The least seconds of one ``WindowAttention.swin_attend`` call, from
    the span's record of its arguments (q, k, v, table, mask)."""
    q, k, v, _, mask = call["args"][:5]
    return max(attn_flops(q["shape"], k["shape"]) / peak_flops,
               attn_bytes(q["shape"], k["shape"], v["shape"],
                          mask["shape"] if mask else None, q["itemsize"]) / hbm_bytes_s)
