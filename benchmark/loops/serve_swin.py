"""Closed-loop serving of FGN on the Swin Transformer backbone:
``loops/serve.py``'s loop (its ``Server``, window, traced stretch and
check through ``compare.serve_readings``) with the Swin in the
ResNet-50-C4's place, as ``loops/serve_vit.py`` puts the ViT there.

The configuration's ``backbone`` block holds the Swin's settings. The
program is ``FGN(cfg, backbone=SwinConfig(**backbone))``, the reference
``reference/swin.py``'s ``RefSwinFGN``; both load one seeded state dict
made by ``harness/weights.py``'s rules, the relative-position tables
included (variance 1/heads: Swin's init of std 0.02 leaves the bias below
the program's own rounding, so a dropped bias would pass). A request's
FLOPs are ``flops.serve_flops_per_img`` counted on that reference, with
RoIAlign over the C4 map's 768 channels. While a run lasts, ``in_place``
puts these where ``serve.py`` and ``flops.py`` take the ResNet's
(``common.program_model``, ``common.reference_model``, ``flops.RefFGN``,
``flops.serve_flops_per_img``).

The check reads two more numbers a request. ``swin_err``: the program's
C4 maps of the request's batch (the query's and the supports', run again
by the program after the window) against the reference's float32 maps,
as the relative L2 gap ||program − reference|| / ||reference||, the wider
of the two (``serve_vit.backbone_err``). ``cover_gap_all``: ``cover_gap``
with the detections' score margin taken from the program's own score of
every candidate (``harness/forced_cover.py``); the cell compares it in
place of ``cover_gap``, which a candidate rounded under the lowest kept
score moves. The heads' other numbers follow ``compare.py``.

Traffic parameters and end-to-end metrics: ``serve.py``'s. A program
without the Swin fails at the first import below, before any set-up.
"""

from __future__ import annotations

import contextlib
from typing import Dict
from unittest import mock

from fgn_torch.config.swin import SwinConfig  # first: a program without the Swin stops here

import torch  # noqa: E402

from benchmark.harness import common, compare, flops, forced_cover, weights  # noqa: E402
from benchmark.loops import serve, serve_vit  # noqa: E402
from benchmark.reference.fgn import ROI_OUT  # noqa: E402
from benchmark.reference.swin import RefSwinFGN  # noqa: E402


_FLOPS = flops.serve_flops_per_img  # ``flops.py``'s own count, before ``in_place`` replaces it


def backbone_config(cfg: Dict) -> SwinConfig:
    return SwinConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in cfg["backbone"].items()})


def param_shapes(cfg: Dict) -> Dict:
    with torch.device("meta"):
        ref = RefSwinFGN(cfg["model"], cfg["backbone"])
    return {n: p.shape for n, p in ref.named_parameters()}


def make_state_dict(cfg: Dict, seed: int, dev) -> Dict[str, torch.Tensor]:
    return weights.make_state_dict(param_shapes(cfg), seed, dev)


def program_model(cfg: Dict, seed: int, dev):
    from fgn_torch.models.fgn import FGN

    model = FGN(common.fgn_config(cfg), backbone=backbone_config(cfg)).to(dev)
    model.load_state_dict(make_state_dict(cfg, seed, dev), strict=True)
    return model


def reference_model(cfg: Dict, seed: int, dev, precision: str = "f32"):
    ref = RefSwinFGN(cfg["model"], cfg["backbone"], precision).to(dev)
    ref.load_state_dict(make_state_dict(cfg, seed, dev), strict=True)
    return ref


def program_scores(model):
    """The program's class scores (B, P, N) of every given proposal and
    way: ``FGN.test_forward``'s box head, on its own maps."""
    def scores(batch, proposals):
        with torch.no_grad():
            qry, spp = model._extract(batch)
            spp_maps, _ = model._count_spp(spp, batch.spp_boxes, batch.spp_masks)
            cls, _ = model._relation_impl(model._bbox_feats(qry, proposals), spp_maps)
            return torch.softmax(cls.to(torch.float32), dim=-1)[..., :model.cfg.n_ways]
    return scores


class BackboneCheck(serve_vit.BackboneCheck):
    """``serve_vit``'s check with its backbone reading named ``swin_err``,
    and ``cover_gap_all`` (``harness/forced_cover.py``), which the cell
    compares in place of ``cover_gap``: ``scores`` is the program's box
    head (``program_scores``; for the calibration's control, the
    reference put in its place)."""

    def __init__(self):
        super().__init__()
        self.scores = None
        readings, check = self._readings, self._check

        def swin_readings(ref, cfg, batch, out):
            r = readings(ref, cfg, batch, out)
            r["cover_gap_all"] = forced_cover.cover_gap_all(ref, cfg, batch, out, self.scores)
            return r

        def named_check(*a, **k):
            # inside serve_vit's check, compare.serve_readings adds vit_err
            vit_readings = compare.serve_readings

            def renamed(*ra):
                r = vit_readings(*ra)
                r["swin_err"] = r.pop("vit_err")
                return r

            with mock.patch.object(compare, "serve_readings", renamed):
                return check(*a, **k)

        self._readings, self._check = swin_readings, named_check

    def program_server(self, ctx):
        model, server = super().program_server(ctx)
        self.scores = program_scores(model)
        return model, server

    def check(self, ctx, pool, outs, n_check: int, forget=None):
        try:
            return super().check(ctx, pool, outs, n_check, forget)
        finally:
            self.scores = None


def serve_flops_per_img(cfg: Dict, nb: int) -> float:
    """``flops.serve_flops_per_img`` with RoIAlign counted over the C4
    map's own width (768 for Swin-L), where ``flops.py`` takes the heads'
    ``feat_channels``: the supports' maps, the proposals and the
    detections, 7×7 bins each."""
    m = cfg["model"]
    wider = m["feat_channels"] - backbone_config(cfg).out_channels
    rois = m["n_ways"] * m["k_shots"] + m["rpn_test_max_per_img"] + m["rcnn_max_per_img"]
    return _FLOPS(cfg, nb) - flops.ROI_ALIGN_FLOPS * ROI_OUT * ROI_OUT * rois * wider


@contextlib.contextmanager
def in_place(cfg: Dict):
    """The Swin's program, reference, FLOP count and check where
    ``serve.py``, ``calibrate.py`` and ``flops.py`` build the ResNet's.
    → the ``BackboneCheck`` in place."""
    bc = BackboneCheck()
    with mock.patch.object(common, "program_model", program_model), \
            mock.patch.object(common, "reference_model", reference_model), \
            mock.patch.object(flops, "RefFGN", lambda m: RefSwinFGN(m, cfg["backbone"])), \
            mock.patch.object(flops, "serve_flops_per_img", serve_flops_per_img), \
            mock.patch.object(serve, "program_server", bc.program_server), \
            mock.patch.object(serve, "check", bc.check):
        yield bc


def run(ctx) -> common.Outcome:
    with in_place(ctx.cell.config):
        return serve.run(ctx)
