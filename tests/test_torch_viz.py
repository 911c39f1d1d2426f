"""The port's debug renderers (``fgn_torch/models/viz.py``) against the JAX
package's on the same seeded inputs, byte for byte (canvases and the PNG
files they write), and a smoke test of ``fgn_torch/utils/profiling.py`` on
the CPU."""

import json
import os

import numpy as np
import pytest
import torch

from fgn_tpu.models import viz as jviz
from fgn_torch.models import viz
from fgn_torch.utils.profiling import StepTimer, device_trace

torch.set_num_threads(2)


def _inputs(seed):
    rng = np.random.RandomState(seed)
    return {
        "visualize_spp_fmaps": (rng.randn(3, 5, 4, 16).astype(np.float32),),
        "visualize_qry_fmaps": (rng.randn(6, 7, 16).astype(np.float32),
                                rng.randn(3, 6, 7, 16).astype(np.float32)),
        "visualize_cls_scores": (rng.rand(2, 8, 6, 15).astype(np.float32),),
    }


@pytest.mark.parametrize("name", ["visualize_spp_fmaps",
                                  "visualize_qry_fmaps",
                                  "visualize_cls_scores"])
@pytest.mark.parametrize("seed", [0, 1])
def test_renderers_byte_identical(tmp_path, name, seed):
    args = _inputs(seed)[name]
    fp, jfp = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    got = getattr(viz, name)(*args, out_fp=fp, scale=4)
    want = getattr(jviz, name)(*args, out_fp=jfp, scale=4)
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape and got.tobytes() == want.tobytes()
    with open(fp, "rb") as a, open(jfp, "rb") as b:
        assert a.read() == b.read()


def test_device_trace_and_step_timer(tmp_path):
    x = torch.randn(64, 64)
    timer = StepTimer(alpha=0.5)
    with device_trace(str(tmp_path / "trace")):
        timer.start()
        y = {"out": [x @ x, (x * 2,)]}
        dt = timer.stop(y)
    assert dt > 0 and timer.ema_ms == dt
    timer.start()
    timer.stop()
    assert timer.ema_ms is not None and timer.ema_ms > 0
    files = os.listdir(tmp_path / "trace")
    assert files == [f"trace_{os.getpid()}.json"]
    with open(tmp_path / "trace" / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    with device_trace(str(tmp_path / "off"), enabled=False):
        pass
    assert not os.path.exists(tmp_path / "off")
