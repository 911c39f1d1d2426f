"""Closed-loop serving of FGN on the InternImage backbone: ``loops/serve.py``'s
loop (its ``Server``, window, traced stretch and check through
``compare.serve_readings``) with InternImage in the ResNet-50-C4's place,
as ``loops/serve_swin.py`` puts the Swin there.

The configuration's ``backbone`` block holds InternImage's settings. The
program is ``FGN(cfg, backbone=InternImageConfig(**backbone))``, the
reference ``reference/internimage.py``'s ``RefInternImageFGN``; both load
one seeded state dict made by ``harness/weights.py``'s rules, the offset
and mask projections included (variance 1/fan_in, biases 0: under
InternImage's zero init every block is a fixed dilated box filter, and a
dropped offset could not fail the check). A request's FLOPs are
``flops.serve_flops_per_img`` counted on that reference, with RoIAlign
over the C4 map's 640 channels and the DCN cores' sampling, which the
counter does not see, counted from their grids (``harness/dcn.py``). While
a run lasts, ``in_place`` puts these where ``serve.py`` and ``flops.py``
take the ResNet's.

The check reads, beside ``compare.py``'s numbers, ``internimage_err``: the
program's C4 maps of the request's batch (the query's and the supports',
run again by the program after the window) against the reference's
float32 maps, as the relative L2 gap ||program − reference|| /
||reference||, the wider of the two (``serve_vit.backbone_err``); and
``cover_gap_all`` (``harness/forced_cover.py``), as the Swin cell does.

Traffic parameters and end-to-end metrics: ``serve.py``'s. A program
without InternImage fails at the first import below, before any set-up.
"""

from __future__ import annotations

import contextlib
from typing import Dict
from unittest import mock

from fgn_torch.config.internimage import InternImageConfig  # first: a program without it stops here

import torch  # noqa: E402

from benchmark.harness import common, compare, dcn, flops, weights  # noqa: E402
from benchmark.loops import serve, serve_swin  # noqa: E402
from benchmark.reference.fgn import ROI_OUT  # noqa: E402
from benchmark.reference.internimage import RefInternImageFGN  # noqa: E402

_FLOPS = flops.serve_flops_per_img  # ``flops.py``'s own count, before ``in_place`` replaces it


def backbone_config(cfg: Dict) -> InternImageConfig:
    return InternImageConfig(**{k: tuple(v) if isinstance(v, list) else v
                                for k, v in cfg["backbone"].items()})


def param_shapes(cfg: Dict) -> Dict:
    with torch.device("meta"):
        ref = RefInternImageFGN(cfg["model"], cfg["backbone"])
    return {n: p.shape for n, p in ref.named_parameters()}


def make_state_dict(cfg: Dict, seed: int, dev) -> Dict[str, torch.Tensor]:
    return weights.make_state_dict(param_shapes(cfg), seed, dev)


def program_model(cfg: Dict, seed: int, dev):
    from fgn_torch.models.fgn import FGN

    model = FGN(common.fgn_config(cfg), backbone=backbone_config(cfg)).to(dev)
    model.load_state_dict(make_state_dict(cfg, seed, dev), strict=True)
    return model


def reference_model(cfg: Dict, seed: int, dev, precision: str = "f32"):
    ref = RefInternImageFGN(cfg["model"], cfg["backbone"], precision).to(dev)
    ref.load_state_dict(make_state_dict(cfg, seed, dev), strict=True)
    return ref


class BackboneCheck(serve_swin.BackboneCheck):
    """``serve_swin``'s check (its backbone reading and ``cover_gap_all``)
    with the backbone reading named ``internimage_err``: the renaming
    wraps the Swin's, innermost, around ``serve.check`` itself."""

    def __init__(self):
        check = serve.check

        def named_check(*a, **k):
            swin_readings = compare.serve_readings  # serve_swin's renaming, at call time

            def renamed(*ra):
                r = swin_readings(*ra)
                r["internimage_err"] = r.pop("swin_err")
                return r

            with mock.patch.object(compare, "serve_readings", renamed):
                return check(*a, **k)

        with mock.patch.object(serve, "check", named_check):
            super().__init__()


def serve_flops_per_img(cfg: Dict, nb: int) -> float:
    """``flops.serve_flops_per_img`` with RoIAlign counted over the C4
    map's own width (640 for InternImage-L), where ``flops.py`` takes the
    heads' ``feat_channels``, and the DCN cores' sampling added: every
    block's over a query and over its N·K supports
    (``dcn.backbone_flops``)."""
    m, geo = cfg["model"], cfg["geometry"]
    wider = m["feat_channels"] - backbone_config(cfg).out_channels
    NK = m["n_ways"] * m["k_shots"]
    rois = NK + m["rpn_test_max_per_img"] + m["rcnn_max_per_img"]
    roi = flops.ROI_ALIGN_FLOPS * ROI_OUT * ROI_OUT * rois * wider
    sampling = (dcn.backbone_flops(cfg["backbone"], geo["H"], geo["W"])
                + NK * dcn.backbone_flops(cfg["backbone"], geo["S"], geo["S"]))
    return _FLOPS(cfg, nb) - roi + sampling


@contextlib.contextmanager
def in_place(cfg: Dict):
    """InternImage's program, reference, FLOP count and check where
    ``serve.py``, ``calibrate.py`` and ``flops.py`` build the ResNet's.
    → the ``BackboneCheck`` in place."""
    bc = BackboneCheck()
    with mock.patch.object(common, "program_model", program_model), \
            mock.patch.object(common, "reference_model", reference_model), \
            mock.patch.object(flops, "RefFGN",
                              lambda m: RefInternImageFGN(m, cfg["backbone"])), \
            mock.patch.object(flops, "serve_flops_per_img", serve_flops_per_img), \
            mock.patch.object(serve, "program_server", bc.program_server), \
            mock.patch.object(serve, "check", bc.check):
        yield bc


def run(ctx) -> common.Outcome:
    with in_place(ctx.cell.config):
        return serve.run(ctx)
