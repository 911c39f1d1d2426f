"""Host ms a request: the program's unit ``request`` (the body of
``FGN.test_forward``) on the host's clock, its waits at syncs included;
the mean over the recorder's own requests."""

LAYER = "host"
UNIT = "ms"
MOVES = "serve_imgs_s"


def read(rec):
    try:
        from fgn_torch.utils.profiling import summary
    except ImportError:  # a program without the recorder
        return None
    span = summary("request")["spans"].get("request")
    # on a card only: without one the host's time is the model's compute
    return span["host_ms"] if span and span["stream_ms"] is not None else None
