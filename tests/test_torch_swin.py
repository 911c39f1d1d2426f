"""FGN on the Swin Transformer backbone (``fgn_torch/models/swin.py``)
against the float32 reference (``benchmark/reference/swin.py``), on the
CPU at toy size, with weights seeded by ``benchmark/harness/weights.py``.

The toy Swin has embed 32, depths (2, 2, 2), heads (1, 2, 4) and a window
of 4 (shift 2), so its stride-16 map has 128 channels. Its inputs give
grids that are not multiples of the window (every block pads) and an odd
grid at the second merge (72×88 px: 18×22, 9×11, 5×6). The whole model's
test runs the new cell's own run (``benchmark/run.py``'s ``run_cell``) at
toy geometry, where the map's 128 channels take K1's route to RoIAlign.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import pytest
import torch

from benchmark import calibrate_swin
from benchmark.harness import common, weights
from benchmark.reference import swin as ref_swin
from benchmark.reference.fgn import RefFGN
from benchmark.reference.precision import strict_f32
from benchmark.reference.vitdet import RefViTDetFGN
from fgn_torch.config import FGNConfig
from fgn_torch.config.swin import SwinConfig
from fgn_torch.config.vit import ViTDetConfig
from fgn_torch.models import swin
from fgn_torch.models.fgn import FGN
from fgn_torch.models.resnet import SharedRes5
from fgn_torch.utils import profiling

TOY = SwinConfig(embed_dim=32, depths=(2, 2, 2), num_heads=(1, 2, 4), window_size=4)
SEED = 2**31 + 23
# Program and reference compute the same float32 sums (the plain route's
# explicit matmuls against the published code's), the index and the mask
# built by other formulas: they agree to float32 rounding of the map's
# largest entry (0 when written).
TOL = 1e-5
CELL = "coco2voc-swin-l-serve-b4"


def _images(hw, seed=0, n=2):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, *hw, 3, generator=g)


def _state(module):
    return weights.make_state_dict({n: p.shape for n, p in module.named_parameters()},
                                   SEED, "cpu")


@pytest.fixture(scope="module")
def pair():
    """The toy program and reference backbones with one seeded state dict."""
    ref = ref_swin.SwinTransformer(dataclasses.asdict(TOY))
    sd = _state(ref)
    ref.load_state_dict(sd, strict=True)
    prog = swin.Swin(TOY)
    prog.load_state_dict(sd, strict=True)
    return prog.eval(), ref.eval()


def _gap(a, b):
    assert a.shape == b.shape
    return float((a - b).abs().max() / b.abs().max())


def _backbone_gap(prog, ref, x):
    with torch.no_grad(), strict_f32():
        return _gap(prog(x), ref(x))


@pytest.mark.parametrize("shift", [0, 1])
@pytest.mark.parametrize("hw", [(8, 8), (10, 14), (3, 5), (13, 4)])
def test_block_equals_the_reference(shift, hw):
    """One W-MSA (shift 0) or SW-MSA block, on grids that are multiples of
    the window and grids that pad, smaller than a window included."""
    H, W = hw
    dim, heads, w = 32, 2, 4
    ref = ref_swin.SwinBlock(dim, heads, 4 * dim, w, bool(shift), 1e-5, lambda x: x)
    prog = swin.SwinBlock(dim, heads, w, w // 2 if shift else 0, TOY)
    sd = _state(ref)
    sd = {n: (t.normal_(0, 0.5) if n.endswith("table") else t) for n, t in sd.items()}
    ref.load_state_dict(sd, strict=True)
    prog.load_state_dict(sd, strict=True)
    x = torch.randn(2, H, W, dim, generator=torch.Generator().manual_seed(H * W))
    with torch.no_grad():
        want = ref(x.reshape(2, H * W, dim), (H, W)).reshape(2, H, W, dim)
        assert _gap(prog(x), want) <= TOL


@pytest.mark.parametrize("hw", [(8, 8), (7, 9), (1, 2)])
def test_merge_equals_the_reference(hw):
    """PatchMerging on even and odd grids (an odd side padded by one)."""
    H, W = hw
    ref = ref_swin.PatchMerging(16, 1e-5, lambda x: x)
    prog = swin.PatchMerging(16, 1e-5)
    sd = _state(ref)
    ref.load_state_dict(sd, strict=True)
    prog.load_state_dict(sd, strict=True)
    x = torch.randn(3, H, W, 16, generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        want, out_hw = ref(x.reshape(3, H * W, 16), (H, W))
        got = prog(x)
    assert got.shape[1:3] == out_hw == (-(-H // 2), -(-W // 2))
    assert _gap(got, want.reshape(got.shape)) <= TOL


@pytest.mark.parametrize("hw", [(64, 64), (72, 88), (32, 32), (36, 52)])
def test_backbone_equals_the_reference(pair, hw):
    prog, ref = pair
    assert _backbone_gap(prog, ref, _images(hw)) <= TOL


def test_relative_index_by_hand():
    """A 2×2 window: tokens (0,0), (0,1), (1,0), (1,1); row i − j + 1 times
    3 plus column i − j + 1 of the 3×3 offsets."""
    assert swin.rel_index(2, "cpu").tolist() == [[4, 3, 1, 0], [5, 4, 2, 1],
                                                 [7, 6, 4, 3], [8, 7, 5, 4]]
    for w in (2, 4, 7, 12):
        assert torch.equal(swin.rel_index(w, "cpu"), ref_swin.relative_position_index(w))


def test_regions_and_mask_by_hand():
    """A 4×4 padded grid, window 2, shift 1: rows and columns cut at 2 and
    3 into three bands each; the top-left window lies in one region (no
    mask), the bottom-right window's four tokens in four."""
    assert swin.region_labels(4, 4, 2, 1, "cpu").tolist() == [
        [0, 0, 1, 2], [0, 0, 1, 2], [3, 3, 4, 5], [6, 6, 7, 8]]
    m = swin.shift_mask(4, 4, 2, 1, "cpu")
    assert m.shape == (4, 4, 4)
    assert torch.equal(m[0], torch.zeros(4, 4))
    assert torch.equal(m[3], torch.full((4, 4), swin.MASK).fill_diagonal_(0.0))
    # top-right window: columns 2 and 3 are bands 1 and 2
    assert m[1].tolist() == [[0, -100, 0, -100], [-100, 0, -100, 0],
                             [0, -100, 0, -100], [-100, 0, -100, 0]]
    for Hp, Wp, w in ((12, 16, 4), (204, 276, 12), (60, 72, 12)):
        assert torch.equal(swin.shift_mask(Hp, Wp, w, w // 2, "cpu"),
                           ref_swin.shifted_window_mask(Hp, Wp, w, w // 2, "cpu"))


@pytest.mark.parametrize("fault", calibrate_swin.SWIN_FAULTS)
def test_each_fault_breaks_the_agreement(pair, fault):
    """The mask, the bias or the shift left out, or the padded keys masked:
    the map moves by orders of magnitude more than the tolerance."""
    prog, ref = pair
    x = _images((72, 88))
    with calibrate_swin.plant_swin(fault):
        assert _backbone_gap(prog, ref, x) > 1e3 * TOL
    assert _backbone_gap(prog, ref, x) <= TOL


def test_counters_count_the_attention_and_the_padding(pair):
    """One 2-image 72×88 px forward: stage grids 18×22, 9×11, 5×6, padded
    to 20×24 (30 windows), 12×12 (9), 8×8 (4); one plain and one shifted
    block a stage; no bias copied on the CPU."""
    prog, _ = pair
    before = profiling.counts()
    with torch.no_grad():
        prog(_images((72, 88)))
    got = {k: v - before.get(k, 0) for k, v in profiling.counts().items()
           if k.startswith("swin.")}
    windows, heads = (30, 9, 4), TOY.num_heads
    scores = sum(2 * 2 * n * h * 16 * 16 for n, h in zip(windows, heads))
    pad = 2 * 2 * ((480 - 396) + (144 - 99) + (64 - 30))
    assert got == {"swin.attn_scores": scores, "swin.pad_tokens": pad,
                   "swin.shift_calls": 3, "swin.bias_bytes": 4 * sum(
                       2 * h * 16 * 16 for h in heads)}


def _fgn_cfg():
    return FGNConfig(rpn_test_nms_pre=64, rpn_test_max_per_img=8, rcnn_max_per_img=4,
                     backbone_frozen=False)


def test_the_heads_take_the_backbones_width():
    """``FGN(cfg, backbone=SwinConfig(...))`` has the reference's parameter
    names and shapes: ``rpn_conv`` and res5's first block read the C4
    map's width, the first block with a projection shortcut to 1024."""
    cfg = _fgn_cfg()
    model = FGN(cfg, backbone=TOY)
    with torch.device("meta"):
        ref = ref_swin.RefSwinFGN(dataclasses.asdict(cfg), dataclasses.asdict(TOY))
    shapes = {n: p.shape for n, p in model.named_parameters()}
    assert shapes == {n: p.shape for n, p in ref.named_parameters()}
    assert shapes["rpn_conv.weight"][1] == TOY.out_channels == 128
    assert shapes["shared5.res5.block0.ds_conv.weight"][:2] == (1024, 128)
    assert shapes["rel_conv_roi.weight"][:2] == (1024, 1024)
    assert SwinConfig().out_channels == 768 and SwinConfig().stride == 16


def test_the_r50_and_vit_heads_are_unchanged():
    """The default width keeps res5 as it was (no projection shortcut) and
    the R50 and ViT models' names and shapes equal the frozen references'."""
    assert dict(SharedRes5().named_parameters()).keys() == dict(
        SharedRes5(in_channels=1024).named_parameters()).keys()
    assert not any("ds_" in n for n, _ in SharedRes5().named_parameters())
    cfg = _fgn_cfg()
    vit_cfg = ViTDetConfig(depth=1, global_blocks=(0,))
    with torch.device("meta"):
        refs = {"r50": RefFGN(dataclasses.asdict(cfg)),
                "vit": RefViTDetFGN(dataclasses.asdict(cfg), dataclasses.asdict(vit_cfg))}
        models = {"r50": FGN(cfg), "vit": FGN(cfg, backbone=vit_cfg)}
    for k, ref in refs.items():
        assert ({n: p.shape for n, p in models[k].named_parameters()}
                == {n: p.shape for n, p in ref.named_parameters()}), k


def test_a_swin_must_match_the_stride():
    with pytest.raises(ValueError):
        FGN(FGNConfig(stride=8), backbone=SwinConfig())
    with pytest.raises(ValueError):
        FGN(FGNConfig(), backbone=dataclasses.replace(TOY, out_stage=2))


def _toy_tree(tmp_path):
    from benchmark.tests import toy

    spec = toy.make(tmp_path)
    path = tmp_path / common.find(spec["configs"], "coco2voc-swin-l-n3k3-800", "config")["file"]
    cfg = json.loads(path.read_text())
    cfg["backbone"].update(embed_dim=32, depths=[2, 2, 2], num_heads=[1, 2, 4],
                           window_size=4)
    path.write_text(json.dumps(cfg))
    return spec, cfg


def test_the_cell_runs_fgn_on_the_swin_within_its_limits(tmp_path):
    """The new cell's own run at toy geometry (64×96 queries, 32 px
    supports, f32): the program is ``FGN(cfg, backbone=SwinConfig(...))``'s
    ``test_forward``, checked through ``compare.serve_readings`` and
    ``swin_err`` against the reference, within the cell's limits; traced,
    the stage, merge and attention spans record under ``request/extract``
    and the readers of the card's numbers report nothing on the CPU."""
    from benchmark import run as bench_run

    spec, _ = _toy_tree(tmp_path)
    profiling.reset()
    line, _, _ = bench_run.run_cell(CELL, SEED, 0.3, True, "cpu", time.time(), spec,
                                    tmp_path, tmp_path / "benchmark")
    assert line["correct"], line["checks"]
    limits = json.loads((common.BENCH_DIR / "limits" / f"{CELL}.json").read_text())
    assert {k: c["limit"] for k, c in line["checks"].items()} == limits
    assert line["checks"]["swin_err"]["value"] <= TOL
    spans = profiling.summary("request")["spans"]
    want = {f"request/extract/swin_stage{i}/swin_attn_{k}" for i in (1, 2, 3) for k in "w sw".split()}
    assert want | {"request/extract/swin_merge"} <= set(spans)
    assert not {"swin_ms.serve", "swin_attn_ms.serve", "swin_attn_roofline.serve",
                "mfu.serve"} & set(line["metrics"])


def test_the_cells_flop_count_is_the_swins(tmp_path):
    """``in_place`` counts a request on the Swin's reference, attention
    scores included: more than its GEMMs alone."""
    from benchmark.harness import flops
    from benchmark.loops import serve_swin

    _, cfg = _toy_tree(tmp_path)
    with serve_swin.in_place(cfg):
        swin_flops = flops.serve_flops_per_img(cfg, 2)
    assert flops.RefFGN is RefFGN
    b = cfg["backbone"]
    # qkv, proj and the MLP: 12·C² multiply-adds a token, C = 32·2^s over
    # (H/4·2^-s)·(W/4·2^-s) tokens: the same 2·12·32²·2·(H·W/16) a stage
    gemms = sum(2 * 12 * (b["embed_dim"] * 2 ** s) ** 2 * d * (64 * 96 + 9 * 32 * 32)
                / 16 / 4 ** s for s, d in enumerate(b["depths"][:3]))
    assert swin_flops > gemms


def test_a_program_without_the_swin_fails_the_cell_at_import(monkeypatch):
    monkeypatch.setitem(sys.modules, "fgn_torch.config.swin", None)
    monkeypatch.delitem(sys.modules, "benchmark.loops.serve_swin", raising=False)
    with pytest.raises(ImportError):
        import benchmark.loops.serve_swin  # noqa: F401


def test_no_jax_is_imported():
    code = (
        "import sys, dataclasses, torch\n"
        "from fgn_torch.config.swin import SwinConfig\n"
        "from fgn_torch.models import swin\n"
        "from benchmark.reference import swin as ref_swin\n"
        "from benchmark.loops import serve_swin\n"
        "import benchmark.calibrate_swin\n"
        "c = SwinConfig(embed_dim=16, depths=(2, 2), num_heads=(1, 2), window_size=4,"
        " out_stage=2)\n"
        "x = torch.zeros(1, 40, 40, 3)\n"
        "swin.Swin(c)(x); ref_swin.SwinTransformer(dataclasses.asdict(c))(x)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', 'fgn_tpu'}))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       cwd=common.ROOT, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("mode", ("control",) + calibrate_swin.SWIN_FAULTS)
def test_the_cells_limits_fail_the_control_and_each_fault(tmp_path, mode):
    """``calibrate_swin``'s readings at toy size: the reference in float8
    in the program's place, and each Swin fault planted in the program,
    fail at least one of the cell's limits."""
    from benchmark import calibrate

    spec, cfg = _toy_tree(tmp_path)
    cell = common.Cell.load(CELL, spec, tmp_path, tmp_path / "benchmark")
    with calibrate_swin.in_place(cfg, mode):
        r = calibrate.readings(cell, SEED, mode, 0.3, "cpu")
    assert [k for k, v in cell.limits.items() if r[k] > v], r
