"""K1-bwd's share of its roofline in training: the least time the map
gradient of every RoIAlign on the backbone's map needs (the incoming
gradient and the ROIs read once, the map's gradient written once, at the
card's HBM bandwidth; shapes and dtypes from each forward call of
``FGN._roi_align_fmap``), over the device time of the autograd nodes of
those calls' backward."""

LAYER = "kernels"
UNIT = "%"
MOVES = "train_imgs_s"
SPANS = [("fgn_torch.models.fgn", "FGN", "_roi_align_fmap")]
NODE = "autograd::engine::evaluate_function: _RoIAlignBackward"
NODES = [NODE]


def nbytes(d):
    n = d["itemsize"]
    for s in d["shape"]:
        n *= s
    return n


def read(rec):
    calls = rec.calls.get("_roi_align_fmap", ())
    us = sum(rec.node_device_us.get(NODE, ()))
    if not calls or us <= 0 or not rec.hbm_bytes_s:
        return None
    total = sum(nbytes(c["out"]) + nbytes(c["args"][1]) + nbytes(c["args"][0])
                for c in calls)
    return 100.0 * (total / rec.hbm_bytes_s) / (us / 1e6)
