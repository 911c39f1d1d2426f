"""FGN on the InternImage backbone (``fgn_torch/models/internimage.py``)
against the float32 reference (``benchmark/reference/internimage.py``), on
the CPU at toy size, with weights seeded by ``benchmark/harness/weights.py``.

The toy InternImage has channels 32, depths (2, 2, 2), groups (2, 4, 8)
(16 channels a group, as InternImage-L) and offset scale 2, so its
stride-16 map has 128 channels. The DCNv3 core is held to hand-worked
cases, the reference's explicit gather to a literal transcription of the
published ``dcnv3_core_pytorch`` (``F.grid_sample``), and the program to
the reference block by block and whole; the whole model's test runs the
new cell's own run (``benchmark/run.py``'s ``run_cell``) at toy geometry
(64×96 queries, 32 px supports).
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import pytest
import torch
import torch.nn.functional as F

from benchmark import calibrate_internimage
from benchmark.harness import common, weights
from benchmark.reference import internimage as ref_ii
from benchmark.reference import swin as ref_swin
from benchmark.reference.fgn import RefFGN
from benchmark.reference.precision import strict_f32
from benchmark.reference.vitdet import RefViTDetFGN
from fgn_torch.config import FGNConfig
from fgn_torch.config.internimage import InternImageConfig
from fgn_torch.config.swin import SwinConfig
from fgn_torch.config.vit import ViTDetConfig
from fgn_torch.models import internimage
from fgn_torch.models.fgn import FGN
from fgn_torch.utils import profiling

TOY = InternImageConfig(channels=32, depths=(2, 2, 2), groups=(2, 4, 8))
SEED = 2**31 + 25
# Program and reference compute the same float32 sums in another order
# (one embedding_bag over 36 weighted rows against 36 gathers summed): they
# agree to float32 rounding of the map's largest entry.
TOL = 1e-5
CELL = "coco2voc-internimage-l-serve-b4"


def _images(hw, seed=0, n=2):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, *hw, 3, generator=g)


def _state(module):
    return weights.make_state_dict({n: p.shape for n, p in module.named_parameters()},
                                   SEED, "cpu")


def _gap(a, b):
    assert a.shape == b.shape
    return float((a - b).abs().max() / b.abs().max())


@pytest.fixture(scope="module")
def pair():
    """The toy program and reference backbones with one seeded state dict."""
    ref = ref_ii.InternImage(dataclasses.asdict(TOY))
    sd = _state(ref)
    ref.load_state_dict(sd, strict=True)
    prog = internimage.InternImage(TOY)
    prog.load_state_dict(sd, strict=True)
    return prog.eval(), ref.eval()


def _backbone_gap(prog, ref, x):
    with torch.no_grad(), strict_f32():
        return _gap(prog(x), ref(x))


# -- the DCN core by hand ------------------------------------------------------


def _core(G=1, k=3, s=2.0):
    return internimage.DCNv3(16 * G, G, k, s, 1e-6)


def _lit(B=1, H=8, W=8, G=1, at=(3, 4), channel=5):
    """A map of zeros with one pixel (y, x) lit at ``channel`` of each group."""
    v = torch.zeros(B, H, W, 16 * G)
    for g in range(G):
        v[:, at[0], at[1], 16 * g + channel] = 1.0 + g
    return v


def _one_point(B, H, W, G, p, dx, dy):
    """Offsets (Δx, Δy) at point ``p`` of every pixel and group, and mask
    logits that put all the weight on ``p``."""
    off = torch.zeros(B, H, W, G, 9, 2)
    off[..., p, 0], off[..., p, 1] = dx, dy
    logits = torch.full((B, H, W, G, 9), -1e4)
    logits[..., p] = 0.0
    return off.view(B, H, W, -1), logits.view(B, H, W, -1)


def test_integer_offsets_move_a_lit_pixel_exactly():
    """An 8×8 map (its normalised grid exact in float32). Point p = 3i + j of pixel (y₀, x₀) reads (x₀ + 2(i − 1 + Δx),
    y₀ + 2(j − 1 + Δy)): with Δ = (1, −1) at p = 5 (i 1, j 2) it reads
    (x₀ + 2, y₀), so the lit (3, 4) shows at (3, 2) alone, in its own
    channel, bit for bit."""
    v = _lit()
    off, logits = _one_point(1, 8, 8, 1, 5, 1.0, -1.0)
    out = _core().dcn_core(v, off, logits)
    want = torch.zeros_like(out)
    want[0, 3, 2, 5] = 1.0
    assert torch.equal(out, want)


def test_the_base_grid_is_dilated_by_the_offset_scale():
    """No offsets, all the weight on p = 0 (i 0, j 0): pixel (y₀, x₀) reads
    (x₀ − 2, y₀ − 2); at offset scale 1, (x₀ − 1, y₀ − 1)."""
    v = _lit()
    off, logits = _one_point(1, 8, 8, 1, 0, 0.0, 0.0)
    for s, (y, x) in ((2.0, (5, 6)), (1.0, (4, 5))):
        out = _core(s=s).dcn_core(v, off, logits)
        assert out[0, y, x, 5] == 1.0 and out.sum() == 1.0, s


def test_fractional_offsets_give_the_bilinear_mix():
    """At the centre point (p = 4) with Δ = (0.25, 0.5) pixel (y₀, x₀) reads
    (x₀ + 0.5, y₀ + 1): the lit (3, 4) is half of the reading at (2, 4)
    and half at (2, 3), weights 1 − 0.5 and 0.5 along x, 1 along y."""
    v = _lit()
    off, logits = _one_point(1, 8, 8, 1, 4, 0.25, 0.5)
    out = _core().dcn_core(v, off, logits)
    assert out[0, 2, 4, 5] == 0.5 and out[0, 2, 3, 5] == 0.5
    assert out.sum() == 1.0
    # a quarter pixel on each axis: weights 0.75·0.75, 0.25·0.75, ...
    off, _ = _one_point(1, 8, 8, 1, 4, 0.125, 0.125)  # 0.25 px after the scale
    out = _core().dcn_core(v, off, logits)
    assert out[0, 3, 4, 5] == 0.5625 and out[0, 2, 3, 5] == 0.0625
    assert out[0, 3, 3, 5] == 0.1875 and out[0, 2, 4, 5] == 0.1875


def test_samples_past_the_edge_read_zero():
    """A map of ones: a point half a pixel past the left edge reads half,
    one a pixel or more past any edge reads 0, however far; each group
    reads its own channels."""
    G = 2
    v = torch.ones(1, 4, 5, 16 * G)
    v[..., 16:] = 3.0
    core = _core(G=G)
    for dx, want in ((-0.25, 0.5), (-0.5, 0.0), (-40.0, 0.0), (0.0, 1.0)):
        off, logits = _one_point(1, 4, 5, G, 4, dx, 0.0)
        out = core.dcn_core(v, off, logits)
        assert torch.allclose(out[0, :, 0, :16], torch.full((4, 16), want)), dx
        assert torch.allclose(out[0, :, 0, 16:], torch.full((4, 16), 3 * want)), dx
    off, logits = _one_point(1, 4, 5, G, 4, 0.0, 10.0)  # past the bottom
    assert core.dcn_core(v, off, logits).abs().max() == 0.0


def test_the_weights_are_a_softmax_over_the_points():
    """Zero logits weigh the 9 points 1/9 each: a map of ones reads the
    share of its points inside the map (4/9 at a corner pixel)."""
    v = torch.ones(1, 5, 5, 16)
    out = _core(s=1.0).dcn_core(v, torch.zeros(1, 5, 5, 18), torch.zeros(1, 5, 5, 9))
    assert torch.allclose(out[0, 2, 2], torch.ones(16))
    assert torch.allclose(out[0, 0, 0], torch.full((16,), 4 / 9))


def test_counters_count_the_samples_and_the_bytes():
    """One call over (2, 6, 7, 32), 2 groups: 2·6·7·2·9 samples; the bytes
    built are every intermediate of the composition, by their shapes."""
    B, H, W, G = 2, 6, 7, 2
    before = profiling.counts()
    _core(G=G).dcn_core(torch.randn(B, H, W, 32), torch.randn(B, H, W, G * 18),
                        torch.randn(B, H, W, G * 9))
    got = {k: v - before.get(k, 0) for k, v in profiling.counts().items()
           if k.startswith("dcn.")}
    n = B * H * W * G * 9
    # locations, normalised, permuted: 2n each; the map widened and
    # permuted: B·H·W·32; the softmax and its transpose: n each; sampled
    # and weighted: 16n each; the sums before the output's permute: B·H·W·32
    assert got == {"dcn.calls": 1, "dcn.samples": n,
                   "dcn.tmp_bytes": 4 * (6 * n + 2 * n + 32 * n + 2 * B * H * W * 32)}


# -- the reference against the published composition ---------------------------


def _get_reference_points(spatial_shapes, device, kernel_h, kernel_w, dilation_h,
                          dilation_w, pad_h=0, pad_w=0, stride_h=1, stride_w=1):
    _, H_, W_, _ = spatial_shapes
    H_out = (H_ - (dilation_h * (kernel_h - 1) + 1)) // stride_h + 1
    W_out = (W_ - (dilation_w * (kernel_w - 1) + 1)) // stride_w + 1
    ref_y, ref_x = torch.meshgrid(
        torch.linspace(
            (dilation_h * (kernel_h - 1)) // 2 + 0.5,
            (dilation_h * (kernel_h - 1)) // 2 + 0.5 + (H_out - 1) * stride_h,
            H_out, dtype=torch.float32, device=device),
        torch.linspace(
            (dilation_w * (kernel_w - 1)) // 2 + 0.5,
            (dilation_w * (kernel_w - 1)) // 2 + 0.5 + (W_out - 1) * stride_w,
            W_out, dtype=torch.float32, device=device), indexing="ij")
    ref_y = ref_y.reshape(-1)[None] / H_
    ref_x = ref_x.reshape(-1)[None] / W_
    ref = torch.stack((ref_x, ref_y), -1).reshape(1, H_out, W_out, 1, 2)
    return ref


def _generate_dilation_grids(spatial_shapes, kernel_h, kernel_w, dilation_h,
                             dilation_w, group, device):
    _, H_, W_, _ = spatial_shapes
    points_list = []
    x, y = torch.meshgrid(
        torch.linspace(
            -((dilation_w * (kernel_w - 1)) // 2),
            -((dilation_w * (kernel_w - 1)) // 2) + (kernel_w - 1) * dilation_w,
            kernel_w, dtype=torch.float32, device=device),
        torch.linspace(
            -((dilation_h * (kernel_h - 1)) // 2),
            -((dilation_h * (kernel_h - 1)) // 2) + (kernel_h - 1) * dilation_h,
            kernel_h, dtype=torch.float32, device=device), indexing="ij")
    points_list.extend([x / W_, y / H_])
    grid = torch.stack(points_list, -1).reshape(-1, 1, 2).repeat(1, group, 1).permute(1, 0, 2)
    grid = grid.reshape(1, 1, 1, group * kernel_h * kernel_w, 2)
    return grid


def dcnv3_core_pytorch(input, offset, mask, kernel_h, kernel_w, stride_h, stride_w,
                       pad_h, pad_w, dilation_h, dilation_w, group, group_channels,
                       offset_scale):
    """OpenGVLab/InternImage ``ops_dcnv3/functions/dcnv3_func.py``, as
    published (``meshgrid``'s indexing made explicit)."""
    input = F.pad(input, [0, 0, pad_h, pad_h, pad_w, pad_w])
    N_, H_in, W_in, _ = input.shape
    _, H_out, W_out, _ = offset.shape
    ref = _get_reference_points(input.shape, input.device, kernel_h, kernel_w,
                                dilation_h, dilation_w, pad_h, pad_w, stride_h, stride_w)
    grid = _generate_dilation_grids(input.shape, kernel_h, kernel_w, dilation_h,
                                    dilation_w, group, input.device)
    spatial_norm = torch.tensor([W_in, H_in]).reshape(1, 1, 1, 2).repeat(
        1, 1, 1, group * kernel_h * kernel_w).to(input.device)
    sampling_locations = (ref + grid * offset_scale).repeat(N_, 1, 1, 1, 1).flatten(3, 4) + \
        offset * offset_scale / spatial_norm
    P_ = kernel_h * kernel_w
    sampling_grids = 2 * sampling_locations - 1
    input_ = input.view(N_, H_in * W_in, group * group_channels).transpose(1, 2).reshape(
        N_ * group, group_channels, H_in, W_in)
    sampling_grid_ = sampling_grids.view(N_, H_out * W_out, group, P_, 2).transpose(1, 2).flatten(0, 1)
    sampling_input_ = F.grid_sample(input_, sampling_grid_, mode="bilinear",
                                    padding_mode="zeros", align_corners=False)
    mask = mask.view(N_, H_out * W_out, group, P_).transpose(1, 2).reshape(
        N_ * group, 1, H_out * W_out, P_)
    output = (sampling_input_ * mask).sum(-1).view(N_, group * group_channels, H_out * W_out)
    return output.transpose(1, 2).reshape(N_, H_out, W_out, -1).contiguous()


@pytest.mark.parametrize("shape", [(2, 9, 13, 2), (1, 4, 3, 4), (3, 17, 6, 1)])
@pytest.mark.parametrize("spread", [0.4, 3.0])
def test_the_reference_gather_is_the_published_composition(shape, spread):
    """Random maps, offsets of a fraction of a pixel and of several (points
    past the edge), random mask logits: the reference's explicit gather and
    the published ``grid_sample`` composition (softmax taken as
    ``DCNv3_pytorch`` takes it) agree to float32 rounding, in float64 and
    in float32; the program's route too."""
    B, H, W, G = shape
    g = torch.Generator().manual_seed(H * W)
    v = torch.randn(B, H, W, 16 * G, generator=g, dtype=torch.float64)
    off = torch.randn(B, H, W, G * 18, generator=g, dtype=torch.float64) * spread
    logits = torch.randn(B, H, W, G * 9, generator=g, dtype=torch.float64)
    m = F.softmax(logits.view(B, H, W, G, 9), -1).view(B, H, W, -1)
    want = dcnv3_core_pytorch(v, off, m, 3, 3, 1, 1, 1, 1, 1, 1, G, 16, 2.0)
    got = ref_ii.dcn_core(v, off, logits, G, 3, 2.0)
    assert _gap(got, want) <= TOL  # the published grids are float32 whatever the input
    f32 = [t.float() for t in (v, off, logits)]
    assert _gap(ref_ii.dcn_core(*f32, G, 3, 2.0), want.float()) <= TOL
    assert _gap(_core(G=G).dcn_core(*f32), want.float()) <= TOL


# -- the program against the reference -----------------------------------------


@pytest.mark.parametrize("hw", [(8, 8), (5, 11), (1, 3)])
def test_block_equals_the_reference(hw):
    """One post-norm block (DCN, layer scales, MLP) on grids of several
    shapes, a one-pixel-high grid included; γ drawn away from 1."""
    H, W = hw
    dim, groups = 32, 2
    b = dict(dataclasses.asdict(TOY))
    ref = ref_ii.InternImageLayer(dim, groups, b, lambda x: x)
    prog = internimage.InternImageBlock(dim, groups, TOY)
    sd = _state(ref)
    sd = {n: (t.uniform_(0.5, 1.5) if "gamma" in n else t) for n, t in sd.items()}
    ref.load_state_dict(sd, strict=True)
    prog.load_state_dict(sd, strict=True)
    x = torch.randn(2, H, W, dim, generator=torch.Generator().manual_seed(H * W))
    with torch.no_grad():
        assert _gap(prog(x), ref(x)) <= TOL


@pytest.mark.parametrize("hw", [(8, 8), (7, 9), (1, 2)])
def test_stem_and_downsampling_equal_the_reference(hw):
    """The stem and a downsampling, even and odd sides (stride 2, pad 1:
    ⌈n/2⌉)."""
    H, W = hw
    ref_stem, stem = ref_ii.StemLayer(32, 1e-6, lambda x: x), torch.nn.Module()
    stem.conv1 = internimage.Conv3x3(3, 16, stride=2)
    stem.norm1 = internimage.LayerNorm(16, 1e-6)
    stem.conv2 = internimage.Conv3x3(16, 32, stride=2)
    stem.norm2 = internimage.LayerNorm(32, 1e-6)
    sd = _state(ref_stem)
    ref_stem.load_state_dict(sd, strict=True)
    stem.load_state_dict(sd, strict=True)
    x = torch.randn(2, 4 * H, 4 * W, 3, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        got = stem.norm2(stem.conv2(F.gelu(stem.norm1(stem.conv1(x)))))
        assert _gap(got, ref_stem(x.permute(0, 3, 1, 2))) <= TOL
    ref_down = ref_ii.DownsampleLayer(32, 1e-6, lambda x: x)
    down = internimage.Downsample(32, 1e-6)
    sd = _state(ref_down)
    ref_down.load_state_dict(sd, strict=True)
    down.load_state_dict(sd, strict=True)
    y = torch.randn(3, H, W, 32, generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        got = down(y)
        assert got.shape[1:] == (-(-H // 2), -(-W // 2), 64)
        assert _gap(got, ref_down(y)) <= TOL


@pytest.mark.parametrize("hw", [(64, 64), (64, 96), (32, 32), (36, 52)])
def test_backbone_equals_the_reference(pair, hw):
    prog, ref = pair
    assert _backbone_gap(prog, ref, _images(hw)) <= TOL


@pytest.mark.parametrize("fault", calibrate_internimage.DCN_FAULTS)
def test_each_fault_breaks_the_agreement(pair, fault):
    """The offsets dropped, a uniform softmax, an undilated base grid, Δx
    and Δy swapped, a half-pixel shift, the locations rounded to bf16: the
    map moves by orders of magnitude more than the tolerance, and the
    program agrees again once the fault is lifted."""
    prog, ref = pair
    x = _images((64, 96))
    with calibrate_internimage.plant_dcn(fault):
        assert _backbone_gap(prog, ref, x) > 1e3 * TOL
    assert _backbone_gap(prog, ref, x) <= TOL


def _fgn_cfg():
    return FGNConfig(rpn_test_nms_pre=64, rpn_test_max_per_img=8, rcnn_max_per_img=4,
                     backbone_frozen=False)


def test_the_heads_take_the_backbones_width():
    """``FGN(cfg, backbone=InternImageConfig(...))`` has the reference's
    parameter names and shapes: ``rpn_conv`` and res5's first block read
    the C4 map's width, the first block with a projection shortcut to
    1024. InternImage-L's C4 map: 640 channels at stride 16."""
    cfg = _fgn_cfg()
    model = FGN(cfg, backbone=TOY)
    with torch.device("meta"):
        ref = ref_ii.RefInternImageFGN(dataclasses.asdict(cfg), dataclasses.asdict(TOY))
    shapes = {n: p.shape for n, p in model.named_parameters()}
    assert shapes == {n: p.shape for n, p in ref.named_parameters()}
    assert shapes["rpn_conv.weight"][1] == TOY.out_channels == 128
    assert shapes["shared5.res5.block0.ds_conv.weight"][:2] == (1024, 128)
    big = InternImageConfig()
    assert (big.out_channels, big.stride) == (640, 16)
    assert [big.dim(i) // g for i, g in enumerate(big.groups[:3])] == [16, 16, 16]


@pytest.mark.parametrize("kind", ["r50", "vit", "swin"])
def test_the_other_backbones_are_unchanged(kind):
    """The R50, ViT and Swin models keep the frozen references' parameter
    names and shapes, and their backbones' maps equal the references' on
    one seeded state dict."""
    cfg = _fgn_cfg()
    c = dataclasses.asdict(cfg)
    vit_cfg = ViTDetConfig(embed_dim=1024, depth=1, num_heads=16, global_blocks=(0,),
                           window_size=4, img_size=64, pretrain_grid=4)
    swin_cfg = SwinConfig(embed_dim=32, depths=(2, 2, 2), num_heads=(1, 2, 4), window_size=4)
    make = {"r50": (lambda: RefFGN(c), None),
            "vit": (lambda: RefViTDetFGN(c, dataclasses.asdict(vit_cfg)), vit_cfg),
            "swin": (lambda: ref_swin.RefSwinFGN(c, dataclasses.asdict(swin_cfg)), swin_cfg)}
    ref_fn, backbone = make[kind]
    ref = ref_fn()
    model = FGN(cfg, backbone=backbone)
    shapes = {n: p.shape for n, p in model.named_parameters()}
    assert shapes == {n: p.shape for n, p in ref.named_parameters()}
    sd = _state(ref)
    ref.load_state_dict(sd, strict=True)
    model.load_state_dict(sd, strict=True)
    x = _images((64, 64), n=1)
    with torch.no_grad(), strict_f32():
        got = model.backbone(x)
        want = ref.backbone(x)
    assert _gap(got, want) <= 1e-4


def test_an_internimage_must_match_the_stride_and_its_groups():
    with pytest.raises(ValueError):
        FGN(FGNConfig(stride=8), backbone=InternImageConfig())
    with pytest.raises(ValueError):
        FGN(FGNConfig(), backbone=dataclasses.replace(TOY, out_stage=2))
    with pytest.raises(ValueError):
        internimage.InternImage(dataclasses.replace(TOY, groups=(4, 4, 8)))
    for bad in (dict(post_norm=False), dict(kernel_size=5)):
        with pytest.raises(ValueError):
            internimage.InternImage(dataclasses.replace(TOY, **bad))
        with pytest.raises(ValueError):
            ref_ii.InternImage(dataclasses.asdict(dataclasses.replace(TOY, **bad)))


def _toy_tree(tmp_path):
    from benchmark.tests import toy

    spec = toy.make(tmp_path)
    path = tmp_path / common.find(spec["configs"], "coco2voc-internimage-l-n3k3-800",
                                  "config")["file"]
    cfg = json.loads(path.read_text())
    cfg["backbone"].update(channels=32, depths=[2, 2, 2], groups=[2, 4, 8])
    path.write_text(json.dumps(cfg))
    return spec, cfg


def test_the_cell_runs_fgn_on_internimage_within_its_limits(tmp_path):
    """The new cell's own run at toy geometry (64×96 queries, 32 px
    supports, f32): the program is ``FGN(cfg, backbone=InternImageConfig(
    ...))``'s ``test_forward``, checked through ``compare.serve_readings``
    and ``internimage_err`` against the reference, within the cell's
    limits; traced, the stem, stage, downsampling and DCN core spans record
    under ``request/extract`` and the readers of the card's numbers report
    nothing on the CPU."""
    from benchmark import run as bench_run

    spec, _ = _toy_tree(tmp_path)
    profiling.reset()
    line, _, _ = bench_run.run_cell(CELL, SEED, 0.3, True, "cpu", time.time(), spec,
                                    tmp_path, tmp_path / "benchmark")
    assert line["correct"], line["checks"]
    limits = json.loads((common.BENCH_DIR / "limits" / f"{CELL}.json").read_text())
    assert {k: c["limit"] for k, c in line["checks"].items()} == limits
    assert line["checks"]["internimage_err"]["value"] <= TOL
    spans = profiling.summary("request")["spans"]
    want = {f"request/extract/ii_stage{i}/dcn_core" for i in (1, 2, 3)}
    assert want | {"request/extract/ii_stem", "request/extract/ii_down"} <= set(spans)
    assert not {"internimage_ms.serve", "dcn_ms.serve", "dcn_roofline.serve",
                "mfu.serve"} & set(line["metrics"])
    assert profiling.counts()["dcn.calls"] > 0


def test_a_program_without_internimage_fails_the_cell_at_import(monkeypatch):
    monkeypatch.setitem(sys.modules, "fgn_torch.config.internimage", None)
    monkeypatch.delitem(sys.modules, "benchmark.loops.serve_internimage", raising=False)
    with pytest.raises(ImportError):
        import benchmark.loops.serve_internimage  # noqa: F401


def test_no_jax_is_imported():
    code = (
        "import sys, dataclasses, torch\n"
        "from fgn_torch.config.internimage import InternImageConfig\n"
        "from fgn_torch.models import internimage\n"
        "from benchmark.reference import internimage as ref_ii\n"
        "from benchmark.loops import serve_internimage\n"
        "import benchmark.calibrate_internimage\n"
        "c = InternImageConfig(channels=16, depths=(1, 1), groups=(1, 2), out_stage=2)\n"
        "x = torch.zeros(1, 40, 40, 3)\n"
        "internimage.InternImage(c)(x); ref_ii.InternImage(dataclasses.asdict(c))(x)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', 'fgn_tpu'}))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       cwd=common.ROOT, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("mode", ("control",) + calibrate_internimage.DCN_FAULTS)
def test_the_cells_limits_fail_the_control_and_each_fault(tmp_path, mode):
    """``calibrate_internimage``'s readings at toy size: the reference in
    float8 in the program's place, and each DCN fault planted in the
    program, move ``internimage_err`` a thousand times past the program's
    own reading; all but the bf16 locations fail at least one of the
    cell's limits (at the toy's 16×24 stage-1 grid bf16 resolves a location
    to 1/8 px, at the cell's 200×272 to 1-2 px)."""
    from benchmark import calibrate

    spec, cfg = _toy_tree(tmp_path)
    cell = common.Cell.load(CELL, spec, tmp_path, tmp_path / "benchmark")
    with calibrate_internimage.in_place(cfg, mode):
        r = calibrate.readings(cell, SEED, mode, 0.3, "cpu")
    assert r["internimage_err"] > 1e3 * TOL, r
    if mode != "bf16_loc":
        assert [k for k, v in cell.limits.items() if r[k] > v], r
