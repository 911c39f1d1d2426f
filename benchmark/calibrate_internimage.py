"""``calibrate.py`` for the cells of ``loops/serve_internimage.py``: the same
modes and output, with InternImage's program and reference in the
ResNet's place (``serve_internimage.in_place``) and six more faults,
planted in the program's DCNv3 cores:

  * ``no_offset``: the learned offsets dropped (Δ = 0);
  * ``uniform``: the softmax over the points replaced by a uniform 1/9;
  * ``undilated``: the base grid not dilated (the offset scale applied to
    Δ only);
  * ``swap_xy``: Δx and Δy swapped;
  * ``half_pixel``: every location shifted by half a pixel on each axis
    (pixel centres at half integers, ``align_corners=True``'s mistake);
  * ``bf16_loc``: the sampling locations rounded to bfloat16.

    python3 benchmark/calibrate_internimage.py --workload coco2voc-internimage-l-serve-b4 --mode <mode> --seeds 1,2,3 [--check 16]

``--check N`` compares N of a seed's requests in place of the traffic's
count: with N at the pool's size, every batch of the pool once.
"""

from __future__ import annotations

import contextlib
import sys
from pathlib import Path
from unittest import mock

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import calibrate_swin  # noqa: E402

DCN_FAULTS = ("no_offset", "uniform", "undilated", "swap_xy", "half_pixel", "bf16_loc")
_SWIN_IN_PLACE = calibrate_swin.in_place  # before ``main`` puts this module's in its place


@contextlib.contextmanager
def plant_dcn(kind: str):
    """The program's DCNv3 cores with fault ``kind`` while the context is
    open."""
    import torch

    from fgn_torch.models import internimage

    core = internimage.DCNv3.dcn_core
    base_grid = internimage.base_grid
    locations = internimage.locations

    def with_inputs(change):
        def faulty(self, value, offset, mask_logits):
            return core(self, value, *change(offset, mask_logits))
        return mock.patch.object(internimage.DCNv3, "dcn_core", faulty)

    if kind == "no_offset":
        patch = with_inputs(lambda o, m: (torch.zeros_like(o), m))
    elif kind == "uniform":
        patch = with_inputs(lambda o, m: (o, torch.zeros_like(m)))
    elif kind == "swap_xy":
        patch = with_inputs(lambda o, m: (o.unflatten(-1, (-1, 2)).flip(-1).flatten(-2), m))
    elif kind == "undilated":
        def undilated(H, W, k, s, device):
            grid = base_grid(H, W, k, s, device)
            at = base_grid(H, W, k, 0.0, device)  # every point at its pixel
            return at + (grid - at) / s
        patch = mock.patch.object(internimage, "base_grid", undilated)
    elif kind == "half_pixel":
        patch = mock.patch.object(internimage, "base_grid",
                                  lambda *a: base_grid(*a) + 0.5)
    elif kind == "bf16_loc":
        patch = mock.patch.object(internimage, "locations",
                                  lambda *a: locations(*a).to(torch.bfloat16).float())
    else:
        raise ValueError(f"no DCN fault {kind!r}")
    with patch:
        yield


@contextlib.contextmanager
def in_place(cfg, mode: str):
    """``serve_internimage.in_place`` for ``calibrate.py``'s ``mode``: the
    DCN faults among its own, planted for the whole run (the check runs the
    program's backbone again for ``internimage_err``), and the control's
    reference in the program's place for ``internimage_err`` and
    ``cover_gap_all`` too, as ``calibrate_swin.in_place`` puts it."""
    from benchmark.loops import serve_internimage, serve_swin

    with mock.patch.object(serve_swin, "in_place", serve_internimage.in_place), \
            mock.patch.object(serve_swin, "reference_model",
                              serve_internimage.reference_model), \
            mock.patch.object(calibrate_swin, "SWIN_FAULTS", DCN_FAULTS), \
            mock.patch.object(calibrate_swin, "plant_swin", plant_dcn), \
            _SWIN_IN_PLACE(cfg, mode):
        yield


def main(argv=None) -> int:
    with mock.patch.object(calibrate_swin, "in_place", in_place):
        return calibrate_swin.main(argv)


if __name__ == "__main__":
    sys.exit(main())
