"""Stream ms a request in the mask head: the program's span
``request/mask_head`` (the RoI tower at the detections, the support gate,
the FCN mask head and the logits' f32 cast), between the CUDA events the
program records around it while a profiler runs; the mean over the
recorder's own requests."""

LAYER = "mask head"
UNIT = "ms"
MOVES = "serve_imgs_s"


def read(rec):
    try:
        from fgn_torch.utils.profiling import summary
    except ImportError:  # a program without the recorder
        return None
    span = summary("request")["spans"].get("request/mask_head")
    return span["stream_ms"] if span else None
