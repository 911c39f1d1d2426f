"""Share of the profiled stretch (a dozen requests or steps, host clock)
in which no device event (kernel, copy, fill) runs."""

LAYER = "device"
UNIT = "%"
MOVES = "serve_imgs_s"


def read(rec):
    if rec.window_s <= 0 or not rec.device_intervals:
        return None
    return 100.0 * (1.0 - rec.busy_s / rec.window_s)
