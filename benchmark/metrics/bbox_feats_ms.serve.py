"""Device ms a request inside ``FGN._bbox_feats`` (RoIAlign on the query
map, K1, and the shared res5 tower at the proposals and the detections),
from a span wrapped around it."""

LAYER = "RoI tower"
UNIT = "ms"
MOVES = "serve_imgs_s"
SPANS = [("fgn_torch.models.fgn", "FGN", "_bbox_feats")]


def read(rec):
    us = sum(rec.span_device_us.get("_bbox_feats", ()))
    return us / 1e3 / rec.units if us > 0 and rec.units else None
