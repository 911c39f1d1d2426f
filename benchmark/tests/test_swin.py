"""The Swin cell's yardsticks on the CPU: ``harness/swin_attention.py``'s
counts on hand-worked shapes, the reader of ``swin_attn_roofline.serve``,
and each of ``calibrate_swin.py``'s faults moving ``swin_err`` through a
toy run of the cell (embed 32, depths 2/2/2, heads 1/2/4, window 4, at
64×96 queries and 32 px supports, f32)."""

from __future__ import annotations

import json

import pytest

from benchmark import calibrate, calibrate_swin
from benchmark.harness import common, flops, forced_cover, swin_attention
from benchmark.tests import toy

CELL = "coco2voc-swin-l-serve-b4"
SEED = 2**31 + 31
PEAK, HBM = 989.4e12, 3.35e12


def _d(shape, itemsize=2):
    return {"shape": shape, "itemsize": itemsize}


def test_counts_of_the_first_stages_shifted_block():
    """A b4 query's stage-1 SW-MSA call: 391 windows of 144 tokens, 6 heads
    of 32. FLOPs 4·32 a score; bytes: q, k, v and the output (4 · 43.2 M
    entries), the gathered table (6·144²) and the mask (391·144²), 2 B
    each. Bound by bytes: 108.2 µs against 25.2 µs of FLOPs."""
    q = (4, 391, 6, 144, 32)
    assert swin_attention.attn_flops(q, q) == 24_907_087_872
    n = 4 * 391 * 6 * 144 * 32
    assert n == 43_241_472
    got = swin_attention.attn_bytes(q, q, q, (391, 144, 144), 2)
    assert got == 2 * (4 * n + 6 * 144 ** 2 + 391 * 144 ** 2) == 362_396_160
    call = {"args": [_d(q), _d(q), _d(q), _d((529, 6), 4), _d((391, 144, 144), 4)]}
    assert swin_attention.roofline_s(call, PEAK, HBM) == pytest.approx(got / HBM)
    assert got / HBM == pytest.approx(108.17e-6, rel=1e-3)


def test_a_plain_block_reads_no_mask():
    """A support's stage-3 W-MSA call (36 supports, one window, 24 heads)."""
    q = (36, 1, 24, 144, 32)
    n = 36 * 24 * 144 * 32
    assert swin_attention.attn_bytes(q, q, q, None, 2) == 2 * (4 * n + 24 * 144 ** 2)
    call = {"args": [_d(q), _d(q), _d(q), _d((529, 24), 4), None]}
    assert swin_attention.roofline_s(call, PEAK, HBM) == pytest.approx(
        max(swin_attention.attn_flops(q, q) / PEAK, 2 * (4 * n + 24 * 144 ** 2) / HBM))


def test_the_roofline_reader():
    reader = common.load_metric("swin_attn_roofline.serve")
    q = (4, 391, 6, 144, 32)
    call = {"args": [_d(q), _d(q), _d(q), _d((529, 6), 4), _d((391, 144, 144), 4)]}
    least = swin_attention.roofline_s(call, PEAK, HBM)

    class Rec:
        calls = {"swin_attend": [call, call]}
        span_device_us = {"swin_attend": [500.0, 500.0]}
        peak_flops, hbm_bytes_s = PEAK, HBM

    assert reader.read(Rec) == pytest.approx(100 * 2 * least / 1e-3)
    Rec.peak_flops = None  # no card: nothing to read
    assert reader.read(Rec) is None


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("toy")
    spec = toy.make(tmp)
    path = tmp / common.find(spec["configs"], "coco2voc-swin-l-n3k3-800", "config")["file"]
    cfg = json.loads(path.read_text())
    cfg["backbone"].update(embed_dim=32, depths=[2, 2, 2], num_heads=[1, 2, 4],
                           window_size=4)
    path.write_text(json.dumps(cfg))
    return common.Cell.load(CELL, spec, tmp, tmp / "benchmark")


def _swin_err(cell, mode):
    with calibrate_swin.in_place(cell.config, mode):
        return calibrate.readings(cell, SEED, mode, 0.3, "cpu")["swin_err"]


@pytest.mark.parametrize("fault", calibrate_swin.SWIN_FAULTS)
def test_each_fault_moves_swin_err(cell, fault):
    """The program's f32 maps equal the reference's to rounding; each fault
    moves them by a thousand times that and past the cell's limit."""
    sound = _swin_err(cell, "program")
    assert sound < 1e-5
    moved = _swin_err(cell, fault)
    assert moved > max(1e3 * sound, cell.limits["swin_err"]), (fault, sound, moved)


def test_greedy_nms_at_half_its_threshold_fails_cover_gap_all(cell):
    """K2 suppressing above half its threshold, the fault that ``cover_gap``
    catches in the R50 cells, reads past ``cover_gap_all``'s limit in the
    Swin cell too; the program reads under it."""
    with calibrate_swin.in_place(cell.config, "program"):
        sound = calibrate.readings(cell, SEED, "program", 0.3, "cpu")
    with calibrate_swin.in_place(cell.config, "suppress"):
        fault = calibrate.readings(cell, SEED, "suppress", 0.3, "cpu")
    limit = cell.limits["cover_gap_all"]
    assert sound["cover_gap_all"] <= sound["cover_gap"] <= limit
    assert fault["cover_gap_all"] > limit, fault


def _crowded(prog_err):
    """One image of two proposals and one way, every slot (one) taken. The
    reference scores them 0.300 and 0.305; the program kept the first at
    0.300 and scored the second, far from it, ``prog_err`` off."""
    import torch

    m = {"n_ways": 1, "rcnn_nms_iou": 0.5, "rcnn_max_per_img": 1, "rcnn_score_thr": 0.05}
    props = torch.tensor([[[0., 0., 10., 10.], [50., 50., 60., 60.]]])
    ref_scores = torch.tensor([[[0.300], [0.305]]])

    class Ref:
        def det_candidates(self, batch, qry, spp_maps, proposals):
            return ref_scores, proposals[:, :, None, :]

    out = {"proposals": props, "prop_valid": torch.tensor([[True, True]]),
           "dt_boxes": props[:, :1], "dt_scores": torch.tensor([[0.300]]),
           "dt_cats": torch.zeros(1, 1, dtype=torch.int32), "dt_valid": torch.tensor([[True]])}
    prog = ref_scores + torch.tensor([[[0.0], [prog_err]]])
    return forced_cover.det_gap(Ref(), {"model": m}, None, None, None, out,
                                lambda batch, p: prog)


def test_a_candidate_rounded_under_the_lowest_kept_score_is_spared():
    """The second proposal's reference score clears the lowest kept (0.300)
    by 0.005, more than the kept errors' margin (0.001): ``cover_gap``
    reads the threshold. The program scored it 0.007 low, under the kept
    one, so greedy NMS rightly left it out; the margin from every
    candidate's error (2·0.007 + 0.001) spares it."""
    assert _crowded(-0.007) == 0.0


def test_a_candidate_the_program_scored_right_is_not():
    """The same candidate scored right by the program, and left out: a
    fault, and ``cover_gap_all`` reads the threshold."""
    assert _crowded(0.0) == pytest.approx(0.5)


def test_the_flop_count_takes_roialign_at_the_c4_width(cell):
    """``serve_swin``'s count is ``flops.py``'s less RoIAlign's work over
    the 1024 − 128 channels that the toy Swin's C4 map (32·4) lacks: a
    multiply-add of 16 corner weights a bin, 7×7 bins, over the nine
    supports, the proposals and the detections."""
    from benchmark.loops import serve_swin

    m = cell.config["model"]
    with serve_swin.in_place(cell.config):
        got = flops.serve_flops_per_img(cell.config, 2)
        heads = serve_swin._FLOPS(cell.config, 2)
    rois = 9 + m["rpn_test_max_per_img"] + m["rcnn_max_per_img"]
    assert heads - got == 2 * 16 * 49 * rois * (1024 - 128)


def test_swin_ms_reads_the_backbone_span_as_vit_ms_does():
    swin, vit = common.load_metric("swin_ms.serve"), common.load_metric("vit_ms.serve")
    assert (swin.LAYER, swin.UNIT, swin.MOVES) == (vit.LAYER, vit.UNIT, vit.MOVES)
    assert swin.read.__code__.co_filename == vit.read.__code__.co_filename
