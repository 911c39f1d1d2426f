"""Stream ms a request in the box head: the program's span
``request/box_head`` (the relation head, the softmax, the boxes' decode and
the per-class ``batched_nms`` with K2), between the CUDA events the program
records around it while a profiler runs; the mean over the recorder's own
requests."""

LAYER = "box head"
UNIT = "ms"
MOVES = "serve_imgs_s"


def read(rec):
    try:
        from fgn_torch.utils.profiling import summary
    except ImportError:  # a program without the recorder
        return None
    span = summary("request")["spans"].get("request/box_head")
    return span["stream_ms"] if span else None
