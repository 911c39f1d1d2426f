"""Device ms a step of the optimizer's ``step`` (``FGNOptimizer.step``),
between CUDA events recorded around it over a dozen steps."""

LAYER = "optimizer"
UNIT = "ms"
MOVES = "train_imgs_s"


def read(rec):
    ms = rec.timings_ms.get("optimizer")
    return sum(ms) / len(ms) if ms else None
