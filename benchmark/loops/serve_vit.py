"""Closed-loop serving of FGN on ViTDet's plain ViT backbone:
``loops/serve.py``'s loop (its ``Server``, window, traced stretch and
check through ``compare.serve_readings``) with the ViT in the
ResNet-50-C4's place.

The configuration's ``backbone`` block holds the ViT's settings. The
program is ``FGN(cfg, backbone=ViTDetConfig(**backbone))``, the reference
``reference/vitdet.py``'s ``RefViTDetFGN``; both load one seeded state
dict (``make_state_dict``: ``harness/weights.py``'s rules, the relative
position tables included, and the absolute position table at ViTDet's
std 0.02). A request's FLOPs are ``flops.serve_flops_per_img`` counted on
that reference. While a run lasts, ``in_place`` puts these where
``serve.py`` and ``flops.py`` take the ResNet's (``common.program_model``,
``common.reference_model``, ``flops.RefFGN``).

The check reads one more number a request, ``vit_err``: the program's ViT
maps of the request's batch (the query's and the supports', run again by
the program after the window) against the reference's float32 maps, as
the relative L2 gap ||program − reference|| / ||reference||, the wider of
the two. The ViT makes no discrete choice, so its maps are compared
directly; the heads' numbers follow ``compare.py``.

Traffic parameters and end-to-end metrics: ``serve.py``'s. A program
without the ViT fails at the first import below, before any set-up.
"""

from __future__ import annotations

import contextlib
from typing import Dict
from unittest import mock

from fgn_torch.config.vit import ViTDetConfig  # first: a program without the ViT stops here

import torch  # noqa: E402

from benchmark.harness import common, compare, flops, weights  # noqa: E402
from benchmark.harness.data import mix  # noqa: E402
from benchmark.loops import serve  # noqa: E402
from benchmark.reference.precision import strict_f32  # noqa: E402
from benchmark.reference.vitdet import RefViTDetFGN  # noqa: E402

POS_STD = 0.02  # ViTDet's init of the absolute position table


def backbone_config(cfg: Dict) -> ViTDetConfig:
    return ViTDetConfig(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in cfg["backbone"].items()})


def param_shapes(cfg: Dict) -> Dict:
    with torch.device("meta"):
        ref = RefViTDetFGN(cfg["model"], cfg["backbone"])
    return {n: p.shape for n, p in ref.named_parameters()}


def make_state_dict(cfg: Dict, seed: int, dev) -> Dict[str, torch.Tensor]:
    sd = weights.make_state_dict(param_shapes(cfg), seed, dev)
    g = torch.Generator(device=dev).manual_seed(mix(seed, "pos_embed"))
    pos = sd["backbone.pos_embed"]
    torch.nn.init.trunc_normal_(pos, 0.0, 1.0, -2.0, 2.0, generator=g)
    pos.mul_(POS_STD / weights._TRUNC_STD)
    return sd


def program_model(cfg: Dict, seed: int, dev):
    from fgn_torch.models.fgn import FGN

    model = FGN(common.fgn_config(cfg), backbone=backbone_config(cfg)).to(dev)
    model.load_state_dict(make_state_dict(cfg, seed, dev), strict=True)
    return model


def reference_model(cfg: Dict, seed: int, dev, precision: str = "f32"):
    ref = RefViTDetFGN(cfg["model"], cfg["backbone"], precision).to(dev)
    ref.load_state_dict(make_state_dict(cfg, seed, dev), strict=True)
    return ref


def backbone_err(extract, ref, batch) -> float:
    """``vit_err`` of one batch: ``extract(batch)`` → (query maps, support
    maps) of the program against ``ref.extract``'s, each as
    ||program − reference|| / ||reference||; the wider."""
    with torch.no_grad():
        got = extract(batch)
    with torch.no_grad(), strict_f32():
        want = ref.extract(batch)
    return max(float((g.float() - w).norm() / w.norm()) for g, w in zip(got, want))


class BackboneCheck:
    """``serve.py``'s ``program_server`` and ``check`` with ``vit_err``
    among the readings: ``extract`` is the program's ``FGN._extract`` (or,
    for the calibration's control, the reference put in its place)."""

    def __init__(self):
        self.extract = None
        self._server = serve.program_server
        self._check = serve.check
        self._readings = compare.serve_readings

    def program_server(self, ctx):
        model, server = self._server(ctx)
        self.extract = model._extract
        return model, server

    def check(self, ctx, pool, outs, n_check: int, forget=None):
        """``serve.check`` with the program kept until the readings are
        taken, then forgotten."""
        extract, self.extract = self.extract, None

        def readings(ref, cfg, batch, out):
            r = self._readings(ref, cfg, batch, out)
            r["vit_err"] = backbone_err(extract, ref, batch)
            return r

        with mock.patch.object(compare, "serve_readings", readings):
            worst = self._check(ctx, pool, outs, n_check)
        del extract, readings
        if forget is not None:
            forget()
        return worst


@contextlib.contextmanager
def in_place(cfg: Dict):
    """The ViT's program, reference, FLOP count and check where
    ``serve.py``, ``calibrate.py`` and ``flops.py`` build the ResNet's.
    → the ``BackboneCheck`` in place."""
    bc = BackboneCheck()
    with mock.patch.object(common, "program_model", program_model), \
            mock.patch.object(common, "reference_model", reference_model), \
            mock.patch.object(flops, "RefFGN", lambda m: RefViTDetFGN(m, cfg["backbone"])), \
            mock.patch.object(serve, "program_server", bc.program_server), \
            mock.patch.object(serve, "check", bc.check):
        yield bc


def run(ctx) -> common.Outcome:
    with in_place(ctx.cell.config):
        return serve.run(ctx)
