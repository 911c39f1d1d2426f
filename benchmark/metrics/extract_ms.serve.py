"""Device ms a request inside ``FGN._extract`` (the ResNet-50-C4 backbone
over the queries and the supports), from a span wrapped around it."""

LAYER = "backbone"
UNIT = "ms"
MOVES = "serve_imgs_s"
SPANS = [("fgn_torch.models.fgn", "FGN", "_extract")]


def read(rec):
    us = sum(rec.span_device_us.get("_extract", ()))
    return us / 1e3 / rec.units if us > 0 and rec.units else None
