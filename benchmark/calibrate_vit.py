"""``calibrate.py`` for the cells of ``loops/serve_vit.py``: the same modes
and output, with the ViT's program and reference in the ResNet's place
(``serve_vit.in_place``) and two more faults, planted in the program's
ViT:

  * ``rel_global``: the relative-position bias dropped in the global
    blocks;
  * ``pad_masked``: the padded keys of the window blocks masked out
    instead of attended.

    python3 benchmark/calibrate_vit.py --workload coco2voc-vitdet-l-serve-b4 --mode <mode> --seeds 1,2,3
"""

from __future__ import annotations

import argparse
import contextlib
import sys
from pathlib import Path
from unittest import mock

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import calibrate  # noqa: E402
from benchmark.harness import common  # noqa: E402

VIT_FAULTS = ("rel_global", "pad_masked")


@contextlib.contextmanager
def plant_vit(kind: str):
    """The program's ViT with fault ``kind`` while the context is open."""
    import torch

    from fgn_torch.models import vit

    rel_bias = vit.Attention.rel_bias
    if kind == "rel_global":
        def faulty(self, q, rh, rw):
            bias = rel_bias(self, q, rh, rw)
            return bias if self.window else torch.zeros_like(bias)

        with mock.patch.object(vit.Attention, "rel_bias", faulty):
            yield
        return
    if kind != "pad_masked":
        raise ValueError(f"no ViT fault {kind!r}")
    grids = {}  # each window block's attention → the (B, H, W) it partitions
    forward = vit.Block.forward

    def block_forward(self, x):
        grids[id(self.attn)] = x.shape[:3]
        return forward(self, x)

    def masked(self, q, rh, rw):
        bias = rel_bias(self, q, rh, rw)
        if not self.window:
            return bias
        real = vit.window_partition(q.new_ones(*grids[id(self)], 1), self.window)[0]
        return bias.masked_fill(real.reshape(q.shape[0], 1, 1, -1) == 0, float("-inf"))

    with mock.patch.object(vit.Block, "forward", block_forward), \
            mock.patch.object(vit.Attention, "rel_bias", masked):
        yield


@contextlib.contextmanager
def in_place(cfg, mode: str):
    """``serve_vit.in_place`` for ``calibrate.py``'s ``mode``: the ViT's
    faults among its own, planted for the whole run (the check runs the
    program's ViT again for ``vit_err``), and the control's reference in
    the program's place for ``vit_err`` too."""
    from benchmark.loops import serve_vit
    from benchmark.reference.precision import strict_f32

    plant = calibrate.plant

    def reference_model(cfg, seed, dev, precision="f32"):
        ref = serve_vit.reference_model(cfg, seed, dev, precision)
        if precision != "f32":
            def extract(batch):
                with strict_f32():
                    return ref.extract(batch)
            bc.extract = extract
        return ref

    @contextlib.contextmanager
    def plant_any(kind: str, loop: str):
        if kind in VIT_FAULTS:  # planted already
            yield
            return
        with plant(kind, loop):
            yield

    with serve_vit.in_place(cfg) as bc, \
            mock.patch.object(common, "reference_model", reference_model), \
            mock.patch.object(calibrate, "FAULTS", calibrate.FAULTS + VIT_FAULTS), \
            mock.patch.object(calibrate, "plant", plant_any), \
            (plant_vit(mode) if mode in VIT_FAULTS else contextlib.nullcontext()):
        yield


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", required=True)
    args = ap.parse_known_args(argv)[0]
    with in_place(common.Cell.load(args.workload).config, args.mode):
        return calibrate.main(argv)


if __name__ == "__main__":
    sys.exit(main())
