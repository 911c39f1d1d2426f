"""InternImage's DCNv3 core's share of its roofline in serving: the least
time of every ``DCNv3.dcn_core`` call (``harness/dcn.py``: 10 FLOPs a
sample and channel at the card's dense bf16 peak, or the value map, the
offsets and the mask logits read once and the output written once at its
HBM bandwidth, whichever is longer; shapes and dtypes taken from each
call), over the device time of the kernels under a span wrapped around
those calls. The count is the same whatever computes it."""

from benchmark.harness.dcn import roofline_s

LAYER = "DCNv3 core"
UNIT = "%"
MOVES = "serve_imgs_s"
SPANS = [("fgn_torch.models.internimage", "DCNv3", "dcn_core")]


def read(rec):
    calls = rec.calls.get("dcn_core", ())
    us = sum(rec.span_device_us.get("dcn_core", ()))
    if not calls or us <= 0 or not rec.peak_flops or not rec.hbm_bytes_s:
        return None
    least = sum(roofline_s(c, rec.peak_flops, rec.hbm_bytes_s) for c in calls)
    return 100.0 * least / (us / 1e6)
