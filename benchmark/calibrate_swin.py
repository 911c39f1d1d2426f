"""``calibrate.py`` for the cells of ``loops/serve_swin.py``: the same modes
and output, with the Swin's program and reference in the ResNet's place
(``serve_swin.in_place``) and four more faults, planted in the program's
Swin:

  * ``no_mask``: the shifted windows' region mask dropped;
  * ``no_bias``: the relative-position bias dropped;
  * ``no_shift``: the shift left out (odd blocks attend unshifted
    windows, unmasked);
  * ``pad_masked``: the padded tokens masked out as keys instead of
    attended.

    python3 benchmark/calibrate_swin.py --workload coco2voc-swin-l-serve-b4 --mode <mode> --seeds 1,2,3 [--check 16]

``--check N`` compares N of a seed's requests in place of the traffic's
count: with N at the pool's size, every batch of the pool once.
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

SWIN_FAULTS = ("no_mask", "no_bias", "no_shift", "pad_masked")


@contextlib.contextmanager
def plant_swin(kind: str):
    """The program's Swin with fault ``kind`` while the context is open."""
    import torch

    from fgn_torch.models import swin

    attend = swin.WindowAttention.swin_attend
    forward = swin.SwinBlock.forward
    if kind == "no_mask":
        mask = swin.shift_mask
        with mock.patch.object(swin, "shift_mask",
                               lambda *a: torch.zeros_like(mask(*a))):
            yield
    elif kind == "no_bias":
        with mock.patch.object(swin.WindowAttention, "swin_attend",
                               lambda self, q, k, v, table, m: attend(
                                   self, q, k, v, torch.zeros_like(table), m)):
            yield
    elif kind == "no_shift":
        def unshifted(self, x):
            shift, self.shift = self.shift, 0
            try:
                return forward(self, x)
            finally:
                self.shift = shift

        with mock.patch.object(swin.SwinBlock, "forward", unshifted):
            yield
    elif kind == "pad_masked":
        grids = {}  # each block's attention → its (H, W, shift)

        def block_forward(self, x):
            grids[id(self.attn)] = (x.shape[1], x.shape[2], self.shift)
            return forward(self, x)

        def masked(self, q, k, v, table, m):
            H, W, s = grids[id(self)]
            w = self.window
            real = torch.ones(1, H, W, 1, device=q.device)
            real = torch.nn.functional.pad(real, (0, 0, 0, -W % w, 0, -H % w))
            real = torch.roll(real, (-s, -s), (1, 2)) if s else real
            keys = swin.window_partition(real, w)[0].reshape(-1, 1, w * w)
            pad = torch.where(keys > 0, 0.0, float("-inf"))
            return attend(self, q, k, v, table, pad if m is None else m + pad)

        with mock.patch.object(swin.SwinBlock, "forward", block_forward), \
                mock.patch.object(swin.WindowAttention, "swin_attend", masked):
            yield
    else:
        raise ValueError(f"no Swin fault {kind!r}")


@contextlib.contextmanager
def in_place(cfg, mode: str):
    """``serve_swin.in_place`` for ``calibrate.py``'s ``mode``: the Swin's
    faults among its own, planted for the whole run (the check runs the
    program's Swin again for ``swin_err``), and the control's reference in
    the program's place for ``swin_err`` and ``cover_gap_all`` too."""
    import torch

    from benchmark.loops import serve_swin
    from benchmark.reference.precision import strict_f32

    plant = calibrate.plant

    def reference_model(cfg, seed, dev, precision="f32"):
        ref = serve_swin.reference_model(cfg, seed, dev, precision)
        if precision != "f32":
            def extract(batch):
                with strict_f32():
                    return ref.extract(batch)

            def scores(batch, proposals):
                with torch.no_grad(), strict_f32():
                    qry, spp = ref.extract(batch)
                    spp_maps, _ = ref.count_spp(spp, batch.spp_boxes, batch.spp_masks)
                    return ref.det_candidates(batch, qry, spp_maps, proposals)[0]

            bc.extract, bc.scores = extract, scores
        return ref

    @contextlib.contextmanager
    def plant_any(kind: str, loop: str):
        if kind in SWIN_FAULTS:  # planted already
            yield
            return
        with plant(kind, loop):
            yield

    with serve_swin.in_place(cfg) as bc, \
            mock.patch.object(common, "reference_model", reference_model), \
            mock.patch.object(calibrate, "FAULTS", calibrate.FAULTS + SWIN_FAULTS), \
            mock.patch.object(calibrate, "plant", plant_any), \
            (plant_swin(mode) if mode in SWIN_FAULTS else contextlib.nullcontext()):
        yield


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", required=True)
    ap.add_argument("--check", type=int, default=0)
    args, rest = ap.parse_known_args(argv)
    load = common.Cell.load

    def load_checked(*a, **k):
        cell = load(*a, **k)
        if args.check:
            cell.traffic = dict(cell.traffic, check=args.check)
        return cell

    with in_place(load(args.workload).config, args.mode), \
            mock.patch.object(common.Cell, "load", load_checked):
        return calibrate.main(rest + ["--workload", args.workload, "--mode", args.mode])


if __name__ == "__main__":
    sys.exit(main())
