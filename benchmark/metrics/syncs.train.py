"""Synchronizing CUDA operations a step, at every site: those torch
flags in its sync debug mode while the program's unit ``step`` records;
the mean over the recorder's own steps."""

LAYER = "host"
UNIT = "syncs"
MOVES = "train_imgs_s"


def read(rec):
    try:
        from fgn_torch.utils.profiling import summary
    except ImportError:  # a program without the recorder
        return None
    s = summary("step")
    unit = s["spans"].get("step")
    if not unit or unit["stream_ms"] is None:  # counted on a card only
        return None
    return float(sum(s["syncs"].values()))
