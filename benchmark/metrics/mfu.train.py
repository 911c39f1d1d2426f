"""Share of the card's dense bf16 peak that training reaches: the forward
and backward FLOPs of one step counted on the reference at the cell's
shapes, an image, times the images a second of this run's untraced
window, over the peak."""

LAYER = "train step"
UNIT = "%"
MOVES = "train_imgs_s"


def read(rec):
    if not (rec.rate_imgs_s and rec.flops_per_img and rec.peak_flops):
        return None
    return 100.0 * rec.rate_imgs_s * rec.flops_per_img / rec.peak_flops
