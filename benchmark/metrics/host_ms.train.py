"""Host ms a step: the program's unit ``step`` (the body of
``make_train_step``'s ``step``) on the host's clock, its waits at syncs
included; the mean over the recorder's own steps."""

LAYER = "host"
UNIT = "ms"
MOVES = "train_imgs_s"


def read(rec):
    try:
        from fgn_torch.utils.profiling import summary
    except ImportError:  # a program without the recorder
        return None
    span = summary("step")["spans"].get("step")
    # on a card only: without one the host's time is the model's compute
    return span["host_ms"] if span and span["stream_ms"] is not None else None
