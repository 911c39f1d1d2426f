"""The InternImage cell's yardsticks on the CPU: ``harness/dcn.py``'s counts
on hand-worked shapes, the reader of ``dcn_roofline.serve``, the FLOP
count, and each of ``calibrate_internimage.py``'s faults moving
``internimage_err`` through a toy run of the cell (channels 32, depths
2/2/2, groups 2/4/8, at 64×96 queries and 32 px supports, f32)."""

from __future__ import annotations

import json

import pytest

from benchmark import calibrate, calibrate_internimage
from benchmark.harness import common, dcn, flops
from benchmark.tests import toy

CELL = "coco2voc-internimage-l-serve-b4"
SEED = 2**31 + 37
PEAK, HBM = 989.4e12, 3.35e12


def _d(shape, itemsize=2):
    return {"shape": shape, "itemsize": itemsize}


def test_counts_of_the_first_stages_query_call():
    """A b4 query's stage-1 call: 200×272 pixels, 160 channels, 10 groups
    of 9 points: 19,584,000 samples, 10 FLOPs each of 16 channels; bytes:
    the map read and written (2 · 34.8 M bf16 entries), the offsets (180
    a pixel) and the logits (90). Bound by bytes: 76.6 µs against 3.2 µs
    of FLOPs."""
    v, off, m = (4, 200, 272, 160), (4, 200, 272, 180), (4, 200, 272, 90)
    assert dcn.dcn_samples(v, m) == 4 * 200 * 272 * 90 == 19_584_000
    assert dcn.dcn_flops(v, m) == 160 * 19_584_000
    got = dcn.dcn_bytes(_d(v), _d(off), _d(m))
    assert got == 2 * 217_600 * (2 * 160 + 180 + 90) == 256_768_000
    call = {"args": [_d(v), _d(off), _d(m)]}
    assert dcn.roofline_s(call, PEAK, HBM) == pytest.approx(got / HBM)
    assert got / HBM == pytest.approx(76.65e-6, rel=1e-3)


def test_the_grids_and_the_backbones_sampling_flops():
    """800×1088: stage grids 200×272, 100×136, 50×68; 128 px: 32², 16², 8².
    InternImage-L's cores: 10·9 FLOPs a pixel and channel, depths 5/5/22."""
    assert dcn.grids(800, 1088, 3) == [(200, 272), (100, 136), (50, 68)]
    assert dcn.grids(128, 128, 3) == [(32, 32), (16, 16), (8, 8)]
    assert dcn.grids(65, 97, 3) == [(17, 25), (9, 13), (5, 7)]
    b = {"channels": 160, "depths": [5, 5, 22, 5], "kernel_size": 3, "out_stage": 3}
    per = 90 * (5 * 54_400 * 160 + 5 * 13_600 * 320 + 22 * 3_400 * 640)
    assert dcn.backbone_flops(b, 800, 1088) == per


def test_the_roofline_reader():
    reader = common.load_metric("dcn_roofline.serve")
    v, off, m = (4, 200, 272, 160), (4, 200, 272, 180), (4, 200, 272, 90)
    call = {"args": [_d(v), _d(off), _d(m)]}
    least = dcn.roofline_s(call, PEAK, HBM)

    class Rec:
        calls = {"dcn_core": [call, call]}
        span_device_us = {"dcn_core": [500.0, 500.0]}
        peak_flops, hbm_bytes_s = PEAK, HBM

    assert reader.read(Rec) == pytest.approx(100 * 2 * least / 1e-3)
    Rec.peak_flops = None  # no card: nothing to read
    assert reader.read(Rec) is None


def test_internimage_ms_reads_the_backbone_span_as_vit_ms_does():
    ii, vit = common.load_metric("internimage_ms.serve"), common.load_metric("vit_ms.serve")
    assert (ii.LAYER, ii.UNIT, ii.MOVES) == (vit.LAYER, vit.UNIT, vit.MOVES)
    assert ii.read.__code__.co_filename == vit.read.__code__.co_filename


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("toy")
    spec = toy.make(tmp)
    path = tmp / common.find(spec["configs"], "coco2voc-internimage-l-n3k3-800",
                             "config")["file"]
    cfg = json.loads(path.read_text())
    cfg["backbone"].update(channels=32, depths=[2, 2, 2], groups=[2, 4, 8])
    path.write_text(json.dumps(cfg))
    return common.Cell.load(CELL, spec, tmp, tmp / "benchmark")


def _err(cell, mode):
    with calibrate_internimage.in_place(cell.config, mode):
        return calibrate.readings(cell, SEED, mode, 0.3, "cpu")["internimage_err"]


@pytest.mark.parametrize("fault", calibrate_internimage.DCN_FAULTS)
def test_each_fault_moves_internimage_err(cell, fault):
    """The program's f32 maps equal the reference's to rounding; each fault
    moves them by a thousand times that."""
    sound = _err(cell, "program")
    assert sound < 1e-5
    assert _err(cell, fault) > 1e3 * max(sound, 1e-8), fault


def test_the_flop_count_adds_the_sampling_and_takes_roialign_at_the_c4_width(cell):
    """``serve_internimage``'s count is ``flops.py``'s (the convolutions and
    GEMMs of the InternImage reference) less RoIAlign's work over the
    1024 − 128 channels that the toy C4 map lacks, plus the DCN cores'
    sampling over a query and its nine supports."""
    from benchmark.loops import serve_internimage

    m, geo, b = cell.config["model"], cell.config["geometry"], cell.config["backbone"]
    with serve_internimage.in_place(cell.config):
        got = flops.serve_flops_per_img(cell.config, 2)
        heads = serve_internimage._FLOPS(cell.config, 2)
    assert flops.RefFGN.__name__ == "RefFGN"
    rois = 9 + m["rpn_test_max_per_img"] + m["rcnn_max_per_img"]
    sampling = dcn.backbone_flops(b, geo["H"], geo["W"]) + 9 * dcn.backbone_flops(b, 32, 32)
    assert got - heads == sampling - 2 * 16 * 49 * rois * (1024 - 128)
