"""Stream ms a request in the RPN: the program's span ``request/rpn``
(``FGN.test_forward``: the AG-RPN convs, the ways' merge and
``get_proposals``, with its anchors, sort, decode and K2), between the CUDA
events the program records around it while a profiler runs; the mean over
the recorder's own requests (``fgn_torch/utils/profiling.py``)."""

LAYER = "RPN"
UNIT = "ms"
MOVES = "serve_imgs_s"


def read(rec):
    try:
        from fgn_torch.utils.profiling import summary
    except ImportError:  # a program without the recorder
        return None
    span = summary("request")["spans"].get("request/rpn")
    return span["stream_ms"] if span else None
