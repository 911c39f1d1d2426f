"""FGN on ViTDet's plain ViT backbone (``fgn_torch/models/vit.py``) against
the float32 reference (``benchmark/reference/vitdet.py``), on the CPU at
toy size, with weights seeded by ``benchmark/harness/weights.py``.

The toy ViT has embed 64, depth 4 with 2 global blocks, 4 heads and a
window of 3, on 128 px queries (an 8×8 grid) and 32 px supports (2×2):
neither grid is a multiple of the window, so the window blocks pad, and
the position table's 4×4 pretraining grid and the global blocks' 15-row
tables (``img_size`` 128) differ from the supports' grid, so both
resizings run. FGN's heads take 1024 channels, so the whole model's test
runs a ViT of embed 1024 (ViT-L's width) and depth 2 through the new
cell's own run (``benchmark/run.py``'s ``run_cell``) at toy geometry.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import pytest
import torch

from benchmark import calibrate_vit
from benchmark.harness import attention, common, weights
from benchmark.reference import vitdet
from benchmark.reference.fgn import RefFGN
from benchmark.reference.precision import strict_f32
from fgn_torch.config import FGNConfig
from fgn_torch.config.vit import ViTDetConfig
from fgn_torch.models import vit
from fgn_torch.models.fgn import FGN
from fgn_torch.models.resnet import ResNetC4
from fgn_torch.utils import profiling

TOY = ViTDetConfig(embed_dim=64, depth=4, num_heads=4, window_size=3,
                   global_blocks=(1, 3), pretrain_grid=4, img_size=128)
SEED = 2**31 + 19
# Program and reference compute the same float32 sums in other orders
# (SDPA against explicit matmuls, einsum's contractions): they agree to a
# few float32 ulps of the map's largest entry, 3.8e-7 of it when written.
BACKBONE_TOL = 1e-5
CELL = "coco2voc-vitdet-l-serve-b4"


def _images(hw, seed=0, n=2):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, *hw, 3, generator=g)


@pytest.fixture(scope="module")
def pair():
    """The toy program and reference backbones with one seeded state dict."""
    ref = vitdet.ViT(dataclasses.asdict(TOY))
    sd = weights.make_state_dict({n: p.shape for n, p in ref.named_parameters()},
                                 SEED, "cpu")
    ref.load_state_dict(sd, strict=True)
    prog = vit.ViT(TOY)
    prog.load_state_dict(sd, strict=True)
    return prog.eval(), ref.eval()


def _gap(prog, ref, x):
    with torch.no_grad(), strict_f32():
        a, b = prog(x), ref(x)
    assert a.shape == b.shape
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("hw", [(128, 128), (32, 32), (64, 96)])
def test_backbone_equals_the_reference(pair, hw):
    prog, ref = pair
    assert _gap(prog, ref, _images(hw)) <= BACKBONE_TOL


@pytest.mark.parametrize("fault", calibrate_vit.VIT_FAULTS)
@pytest.mark.parametrize("hw", [(128, 128), (32, 32)])
def test_each_fault_breaks_the_agreement(pair, fault, hw):
    """Relative positions dropped in the global blocks, or the padded
    window keys masked out: the map moves by orders of magnitude more than
    the tolerance, queries and supports alike."""
    prog, ref = pair
    with calibrate_vit.plant_vit(fault):
        assert _gap(prog, ref, _images(hw)) > 1e3 * BACKBONE_TOL
    assert _gap(prog, ref, _images(hw)) <= BACKBONE_TOL


def test_tables_resize_as_detectron2():
    g = torch.Generator().manual_seed(3)
    table = torch.randn(15, 16, generator=g)
    for size in (8, 2, 5):  # native, shrunk, shrunk to an odd length
        assert torch.equal(vit.rel_table(table, size), vitdet.get_rel_pos(size, size, table))
    pos = torch.randn(1, 17, 16, generator=g)
    for h, w in ((4, 4), (8, 8), (2, 6)):
        assert torch.allclose(vit.abs_pos(pos, 4, h, w),
                              vitdet.get_abs_pos(pos, True, (h, w)), atol=1e-6)


def test_counters_count_the_attention_and_the_padding(pair):
    """One 2-image 128 px forward: windows of 3×3 over the 8×8 grid padded
    to 9×9 (18 windows, 17 pad tokens an image) in blocks 0 and 2, the
    whole 64-token map in blocks 1 and 3; f32 bias."""
    prog, _ = pair
    before = profiling.counts()
    with torch.no_grad():
        prog(_images((128, 128)))
    got = {k: v - before.get(k, 0) for k, v in profiling.counts().items()
           if k.startswith("vit.")}
    heads = TOY.num_heads
    scores = 2 * (18 * heads * 9 * 9) + 2 * (2 * heads * 64 * 64)
    assert got == {"vit.attn_scores": scores,
                   "vit.attn_tokens": 2 * (18 * heads * 9) + 2 * (2 * heads * 64),
                   "vit.bias_bytes": 4 * scores,
                   "vit.pad_tokens": 2 * (2 * 17)}


def test_attention_roofline_counts_the_work():
    """A global block of the cell's b4 query: 4·16 heads over 4096 tokens
    of 64, tables 64×64×64."""
    q = (4, 16, 4096, 64)
    rh = rw = (64, 64, 64)
    flops = attention.attn_flops(q, q, rh, rw)
    assert flops == 4 * 64 * 4 * 16 * 4096 ** 2 + 2 * 64 * 4 * 16 * 4096 * 128
    assert attention.attn_bytes(q, q, q, rh, rw, 2) == 2 * (4 * 4 * 16 * 4096 * 64 + 2 * 64 ** 3)
    d = {"shape": q, "itemsize": 2}
    call = {"args": [d, d, d, {"shape": rh, "itemsize": 2}, {"shape": rw, "itemsize": 2}]}
    assert attention.roofline_s(call, 989.4e12, 3.35e12) == pytest.approx(flops / 989.4e12)
    reader = common.load_metric("vit_attn_roofline.serve")

    class Rec:
        calls = {"attend": [call, call]}
        span_device_us = {"attend": [2e3, 2e3]}
        peak_flops, hbm_bytes_s = 989.4e12, 3.35e12

    assert reader.read(Rec) == pytest.approx(100 * 2 * flops / 989.4e12 / 4e-3)
    Rec.peak_flops = None  # no card: nothing to read
    assert reader.read(Rec) is None


def test_default_backbone_is_the_resnet_unchanged():
    """``backbone=None`` builds today's ResNet-50-C4: the frozen
    reference's parameter names and shapes, and the same outputs as
    ``FGN(cfg)``."""
    cfg = FGNConfig(rpn_test_nms_pre=64, rpn_test_max_per_img=8, rcnn_max_per_img=4)
    a, b = FGN(cfg), FGN(cfg, backbone=None)
    assert isinstance(b.backbone, ResNetC4)
    with torch.device("meta"):
        ref = RefFGN(dataclasses.asdict(cfg))
    want = {n: p.shape for n, p in ref.named_parameters()}
    assert {n: p.shape for n, p in a.named_parameters()} == want
    assert {n: p.shape for n, p in b.named_parameters()} == want
    sd = weights.make_state_dict(want, SEED, "cpu")
    a.load_state_dict(sd, strict=True)
    b.load_state_dict(sd, strict=True)
    from fgn_torch.data.batching import toy_batch

    batch = toy_batch(2, 64, 64, cfg.n_ways, cfg.k_shots, 32)
    oa, ob = a.eval().test_forward(batch), b.eval().test_forward(batch)
    assert all(torch.equal(oa[k], ob[k]) for k in oa)


def test_a_vit_must_match_the_heads():
    with pytest.raises(ValueError):
        FGN(FGNConfig(), backbone=TOY)  # 64 channels, not 1024
    with pytest.raises(ValueError):
        FGN(FGNConfig(stride=8), backbone=ViTDetConfig())


def _toy_tree(tmp_path):
    from benchmark.tests import toy

    spec = toy.make(tmp_path)
    path = tmp_path / common.find(spec["configs"], "coco2voc-vitdet-l-n3k3-1024", "config")["file"]
    cfg = json.loads(path.read_text())
    cfg["backbone"].update(depth=2, window_size=3, global_blocks=[1], pretrain_grid=4,
                           img_size=64)
    path.write_text(json.dumps(cfg))
    return spec, cfg


def test_the_cell_runs_fgn_on_the_vit_within_its_limits(tmp_path):
    """The new cell's own run at toy geometry (64×96 queries, 32 px
    supports, f32) and a ViT of ViT-L's width at depth 2: the program is
    ``FGN(cfg, backbone=ViTDetConfig(...))``'s ``test_forward``, checked
    through ``compare.serve_readings`` against the reference, within the
    cell's limits; traced, the attention spans record under
    ``request/extract`` and the readers of the card's numbers report
    nothing on the CPU."""
    from benchmark import run as bench_run

    spec, cfg = _toy_tree(tmp_path)
    profiling.reset()
    line, _, _ = bench_run.run_cell(CELL, SEED, 0.3, True, "cpu", time.time(), spec,
                                    tmp_path, tmp_path / "benchmark")
    assert line["correct"], line["checks"]
    limits = json.loads((common.BENCH_DIR / "limits" / f"{CELL}.json").read_text())
    assert {k: c["limit"] for k, c in line["checks"].items()} == limits
    spans = profiling.summary("request")["spans"]
    assert {"request/extract/attn_window", "request/extract/attn_global"} <= set(spans)
    assert not {"vit_ms.serve", "vit_attn_ms.serve", "vit_attn_roofline.serve",
                "mfu.serve"} & set(line["metrics"])


def test_the_cells_flop_count_is_the_vits(tmp_path):
    """``in_place`` counts a request on the ViT's reference: more than the
    ResNet's at the same geometry by the ViT's GEMMs."""
    from benchmark.harness import flops
    from benchmark.loops import serve_vit

    _, cfg = _toy_tree(tmp_path)
    r50 = flops.serve_flops_per_img(cfg, 2)
    with serve_vit.in_place(cfg):
        vit_flops = flops.serve_flops_per_img(cfg, 2)
    assert flops.RefFGN is RefFGN
    b = cfg["backbone"]
    # qkv, proj and the MLP of each block: 12·D² multiply-adds a token
    per_token = 2 * 12 * b["embed_dim"] ** 2 * b["depth"]
    assert vit_flops > per_token * (64 * 96 + 9 * 32 * 32) / 256


def test_a_program_without_the_vit_fails_the_cell_at_import(monkeypatch):
    monkeypatch.setitem(sys.modules, "fgn_torch.config.vit", None)
    monkeypatch.delitem(sys.modules, "benchmark.loops.serve_vit", raising=False)
    with pytest.raises(ImportError):
        import benchmark.loops.serve_vit  # noqa: F401


def test_no_jax_is_imported():
    code = (
        "import sys, dataclasses, torch\n"
        "from fgn_torch.config.vit import ViTDetConfig\n"
        "from fgn_torch.models import vit\n"
        "from benchmark.reference import vitdet\n"
        "from benchmark.loops import serve_vit\n"
        "import benchmark.calibrate_vit\n"
        "c = ViTDetConfig(embed_dim=32, depth=2, num_heads=2, window_size=3,"
        " global_blocks=(1,), pretrain_grid=2, img_size=64)\n"
        "x = torch.zeros(1, 64, 64, 3)\n"
        "vit.ViT(c)(x); vitdet.ViT(dataclasses.asdict(c))(x)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', 'fgn_tpu'}))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       cwd=common.ROOT, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("mode", ("control",) + calibrate_vit.VIT_FAULTS)
def test_the_cells_limits_fail_the_control_and_each_fault(tmp_path, mode):
    """``calibrate_vit``'s readings at toy size: the reference in float8
    in the program's place, and each ViT fault planted in the program,
    fail at least one of the cell's limits."""
    from benchmark import calibrate

    spec, cfg = _toy_tree(tmp_path)
    cell = common.Cell.load(CELL, spec, tmp_path, tmp_path / "benchmark")
    with calibrate_vit.in_place(cfg, mode):
        r = calibrate.readings(cell, SEED, mode, 0.3, "cpu")
    assert [k for k, v in cell.limits.items() if r[k] > v], r
