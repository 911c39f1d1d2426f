"""Synchronizing CUDA operations a request, at every site: those torch
flags in its sync debug mode while the program's unit ``request`` records;
the mean over the recorder's own requests."""

LAYER = "host"
UNIT = "syncs"
MOVES = "serve_imgs_s"


def read(rec):
    try:
        from fgn_torch.utils.profiling import summary
    except ImportError:  # a program without the recorder
        return None
    s = summary("request")
    unit = s["spans"].get("request")
    if not unit or unit["stream_ms"] is None:  # counted on a card only
        return None
    return float(sum(s["syncs"].values()))
