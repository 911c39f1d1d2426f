"""Stream ms a step in the forward: the program's span ``step/forward``
(``FGN.train_forward`` and the loss's sum), between the CUDA events the
program records around it while a profiler runs; the mean over the
recorder's own steps."""

LAYER = "forward"
UNIT = "ms"
MOVES = "train_imgs_s"


def read(rec):
    try:
        from fgn_torch.utils.profiling import summary
    except ImportError:  # a program without the recorder
        return None
    span = summary("step")["spans"].get("step/forward")
    return span["stream_ms"] if span else None
