"""The comparison fails what it must: the lower-precision control and the
faults a cell can have, each driven through a whole run at toy size on the
CPU (the run's look for a card skipped), against the cells' own limits.

  * the control: the reference in float8 put in the program's place
    (``calibrate.py --mode control``, as on the card at the cells' sizes);
  * serving: half of the batch left out; an answer altered where it is
    produced (a score, a box, a mask); the wrong candidates kept (one
    detection an image, the lowest-scoring ones, NMS suppressing too
    much, the pre-NMS top-k cut short);
  * training: a step that leaves its state unchanged; half of the batch
    left out, the means taken over the rest; the RoI head not updated,
    or updated at ten times its learning rate.

Each fault is planted by ``calibrate.plant``, as on the card.

A sound toy run passes the same limits (``test_sound_runs_pass``).
"""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import calibrate
from benchmark import run as bench_run
from benchmark.harness import common
from benchmark.tests import toy

SERVE = ["omniiseg-serve-b8", "coco2voc-serve-b4", "omniiseg-serve-b1"]
TRAIN = ["omniiseg-train-b8"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("toy")
    return tmp, toy.make(tmp)


def _run(tree, cell, seed=2**31 + 11):
    tmp, spec = tree
    line, _, _ = bench_run.run_cell(cell, seed, 0.3, False, "cpu", time.time(), spec,
                                    tmp, tmp / "benchmark")
    return line


def _failed(line):
    return [k for k, c in line["checks"].items() if c["value"] > c["limit"]]


@pytest.mark.parametrize("cell", SERVE + TRAIN)
def test_sound_runs_pass(tree, cell):
    line = _run(tree, cell)
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("cell", SERVE + TRAIN)
def test_control_fails(tree, cell):
    tmp, spec = tree
    c = common.Cell.load(cell, spec, tmp, tmp / "benchmark")
    r = calibrate.readings(c, 2**31 + 3, "control", 0.3, "cpu")
    assert any(r[k] > lim for k, lim in c.limits.items()), r


@pytest.mark.parametrize("kind", calibrate.SERVE_FAULTS)
@pytest.mark.parametrize("cell", SERVE)
def test_serving_faults_fail(tree, cell, kind):
    with calibrate.plant(kind, "serve"):
        line = _run(tree, cell)
    assert not line["correct"] and _failed(line), line["checks"]


@pytest.mark.parametrize("kind", calibrate.TRAIN_FAULTS)
@pytest.mark.parametrize("cell", TRAIN)
def test_training_faults_fail(tree, cell, kind):
    with calibrate.plant(kind, "train"):
        line = _run(tree, cell)
    assert not line["correct"] and _failed(line), line["checks"]


def test_fp8_rounds_to_three_mantissa_bits():
    from benchmark.reference.precision import fp8

    x = torch.tensor([1.0, 1.06, 1.07, 448.0, -3.3])
    q = fp8(x)
    assert q[0] == 1.0 and q[3] == 448.0
    assert q[1] == 1.0 and q[2] == 1.125  # the step above 1 is 1/8
    assert abs(float(q[4]) + 3.25) < 1e-6
