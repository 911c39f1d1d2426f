"""Stream ms a request in InternImage's DCNv3 cores: the program's span
``dcn_core`` (``DCNv3.dcn_core`` in each block: the softmax, the sampling
locations, the corners' rows and weights and the weighted sum, from v, the
offsets and the mask logits to the output before ``output_proj``) under
``request/extract``, every stage's summed; the mean over the recorder's
own requests."""

LAYER = "DCNv3 core"
UNIT = "ms"
MOVES = "serve_imgs_s"
NAME = "dcn_core"


def read(rec):
    try:
        from fgn_torch.utils.profiling import summary
    except ImportError:  # a program without the recorder
        return None
    spans = summary("request")["spans"]
    ms = [s["stream_ms"] for p, s in spans.items()
          if p.startswith("request/extract/") and p.rsplit("/", 1)[1] == NAME]
    return sum(ms) if ms and None not in ms else None
