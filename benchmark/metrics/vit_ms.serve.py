"""Stream ms a request in the ViT backbone: the program's span
``request/extract`` (``FGN._extract``: the ViT over the queries and over
the supports), between the CUDA events the program records around it
while a profiler runs; the mean over the recorder's own requests."""

LAYER = "backbone"
UNIT = "ms"
MOVES = "serve_imgs_s"


def read(rec):
    try:
        from fgn_torch.utils.profiling import summary
    except ImportError:  # a program without the recorder
        return None
    span = summary("request")["spans"].get("request/extract")
    return span["stream_ms"] if span else None
