"""Swin's window attention's share of its roofline in serving: the least
time of every ``WindowAttention.swin_attend`` call
(``harness/swin_attention.py``: FLOPs at the card's dense bf16 peak, or
q, k, v, the output, the gathered table and the mask moved once at its
HBM bandwidth, whichever is longer; shapes and dtypes taken from each
call), over the device time of the kernels under a span wrapped around
those calls. The count is the same whatever computes it."""

from benchmark.harness.swin_attention import roofline_s

LAYER = "Swin attention"
UNIT = "%"
MOVES = "serve_imgs_s"
SPANS = [("fgn_torch.models.swin", "WindowAttention", "swin_attend")]


def read(rec):
    calls = rec.calls.get("swin_attend", ())
    us = sum(rec.span_device_us.get("swin_attend", ()))
    if not calls or us <= 0 or not rec.peak_flops or not rec.hbm_bytes_s:
        return None
    least = sum(roofline_s(c, rec.peak_flops, rec.hbm_bytes_s) for c in calls)
    return 100.0 * least / (us / 1e6)
