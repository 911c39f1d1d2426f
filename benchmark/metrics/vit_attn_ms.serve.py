"""Stream ms a request in the ViT's attention: the program's spans
``request/extract/attn_window`` and ``request/extract/attn_global``
(``Attention.attend`` in each block: the relative-position bias and the
attention, from q, k, v to the heads' output before ``proj``), summed;
the mean over the recorder's own requests."""

LAYER = "ViT attention"
UNIT = "ms"
MOVES = "serve_imgs_s"
PATHS = ("request/extract/attn_window", "request/extract/attn_global")


def read(rec):
    try:
        from fgn_torch.utils.profiling import summary
    except ImportError:  # a program without the recorder
        return None
    spans = summary("request")["spans"]
    ms = [spans[p]["stream_ms"] for p in PATHS if p in spans]
    return sum(ms) if ms and None not in ms else None
