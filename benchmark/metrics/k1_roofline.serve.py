"""K1's share of its roofline in serving: the least time every RoIAlign
on the backbone's map needs (``FGN._roi_align_fmap``: the map and the
ROIs read once and the output written once, at the card's HBM bandwidth;
shapes and dtypes taken from each call), over the device time of the
spans around those calls. The count is the same whatever computes it."""

LAYER = "kernels"
UNIT = "%"
MOVES = "serve_imgs_s"
SPANS = [("fgn_torch.models.fgn", "FGN", "_roi_align_fmap")]


def nbytes(d):
    n = d["itemsize"]
    for s in d["shape"]:
        n *= s
    return n


def read(rec):
    calls = rec.calls.get("_roi_align_fmap", ())
    us = sum(rec.span_device_us.get("_roi_align_fmap", ()))
    if not calls or us <= 0 or not rec.hbm_bytes_s:
        return None
    total = sum(nbytes(c["args"][0]) + nbytes(c["args"][1]) + nbytes(c["out"])
                for c in calls)
    return 100.0 * (total / rec.hbm_bytes_s) / (us / 1e6)
