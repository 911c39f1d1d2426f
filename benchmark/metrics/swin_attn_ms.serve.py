"""Stream ms a request in Swin's window attention: the program's spans
``swin_attn_w`` and ``swin_attn_sw`` (``WindowAttention.swin_attend`` in
each block, plain and shifted windows: the gathered bias, the mask and
the attention, from q, k, v to the heads' output before ``proj``) under
``request/extract``, every stage's summed; the mean over the recorder's
own requests."""

LAYER = "Swin attention"
UNIT = "ms"
MOVES = "serve_imgs_s"
NAMES = ("swin_attn_w", "swin_attn_sw")


def read(rec):
    try:
        from fgn_torch.utils.profiling import summary
    except ImportError:  # a program without the recorder
        return None
    spans = summary("request")["spans"]
    ms = [s["stream_ms"] for p, s in spans.items()
          if p.startswith("request/extract/") and p.rsplit("/", 1)[1] in NAMES]
    return sum(ms) if ms and None not in ms else None
