"""Device ms a step of ``Tensor.backward`` (autograd, with K1-bwd),
between CUDA events recorded around it over a dozen steps."""

LAYER = "backward"
UNIT = "ms"
MOVES = "train_imgs_s"


def read(rec):
    ms = rec.timings_ms.get("backward")
    return sum(ms) / len(ms) if ms else None
