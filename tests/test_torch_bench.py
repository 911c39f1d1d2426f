"""The port's yardstick and its entry point against the JAX package's, on
the CPU at toy geometry.

The port's speed is measured by ``benchmark/`` alone. Its work count
(``benchmark/harness/flops.py``: the reference's convolutions and matrix
products counted on the meta device, RoIAlign and NMS counted from shapes)
is held here to the JAX package's jaxpr, and its table of peaks to the data
sheet. ``fgn_torch.entry`` is held to ``__graft_entry__.entry()``, with the
JAX package's weights loaded through ``fgn_torch.bridge``.

Tolerances:
  * FLOPs: the benchmark's count less its RoIAlign and NMS terms within
    1e-5 of the JAX jaxpr's count of ``conv_general_dilated`` and
    ``dot_general`` at 2 a multiply-add, a convolution whose input is
    dilated (``lhs_dilation``: the transposed mask deconvolution, and the
    input gradients of strided convolutions) counted at its multiply-adds
    with the input's nonzero entries, the naive count over the dilated input
    divided by the dilation's product (the naive count is 1.2 % larger in
    the forward here). The residual, about 1e-6 of the count, is the JAX
    graph's one-hot selections done as ``dot_general`` (the way merge of the
    RPN's outputs, the detections' support-vector gate), which the
    reference does with gathers;
  * ``entry()``'s example episode equals the JAX one byte for byte; its
    ``fn`` at 64 px with the JAX entry's weights, its model cast to f32,
    is held to the JAX ``fn``'s graph at f32 as
    tests/test_torch_model.py holds ``test_forward`` end to end: valid
    masks and classes equal; proposals and detection boxes ≤ 1e-4 of the
    64 px image side; scores and mask logits ≤ 1e-4 (bf16 on both sides
    differs by more than any useful bound: proposal scores by 0.11 at these
    random weights, so the bf16 run is held to shapes, dtypes and finite
    values only).
"""

import dataclasses
import math
import subprocess
import sys
from collections import Counter
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from fgn_tpu.models.fgn import FGN as JFGN
from fgn_tpu.models.fgn import FGNConfig as JConfig
from fgn_torch import entry
from fgn_torch.bridge import load_flax_params
from fgn_torch.config import FGNConfig
from fgn_torch.data.batching import from_numpy, toy_batch
from fgn_torch.models.fgn import FGN
from tests.test_torch_model import SMALL, _batch_np, _jbatch, _scaled_reg

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
IMG = 64.0
TOL = 1e-4  # scores, mask logits; boxes TOL · IMG (test_torch_model.py)
FLOP_TOL = 1e-5


# --- the JAX package's FLOP count, from its jaxpr ---------------------------

def _subjaxprs(params):
    for v in params.values():
        for x in (v if isinstance(v, (tuple, list)) else (v,)):
            if isinstance(x, jax.extend.core.ClosedJaxpr):
                yield x.jaxpr
            elif isinstance(x, jax.extend.core.Jaxpr):
                yield x


def jaxpr_flops(jaxpr, acc=None, mult=1):
    """{"conv", "conv_naive", "dot"}: FLOPs of the jaxpr's convolutions (at
    their nonzero inputs, and naively over dilated inputs) and dot_generals,
    2 a multiply-add, sub-jaxprs included (a scan's body times its
    length). A while loop holding either raises: its trip count is not
    known."""
    acc = Counter() if acc is None else acc
    for e in jaxpr.eqns:
        p = e.primitive.name
        if p == "conv_general_dilated":
            rhs, out = e.invars[1].aval, e.outvars[0].aval
            dn = e.params["dimension_numbers"]
            taps = math.prod(rhs.shape[d] for d in dn.rhs_spec[2:])
            naive = 2 * math.prod(out.shape) * taps * rhs.shape[dn.rhs_spec[1]]
            acc["conv_naive"] += mult * naive
            acc["conv"] += mult * naive / math.prod(e.params["lhs_dilation"])
        elif p == "dot_general":
            (lc, _rc), _ = e.params["dimension_numbers"]
            lhs, out = e.invars[0].aval, e.outvars[0].aval
            acc["dot"] += (mult * 2 * math.prod(out.shape)
                           * math.prod(lhs.shape[i] for i in lc))
        if p == "while":
            inner = Counter()
            for j in _subjaxprs(e.params):
                jaxpr_flops(j, inner)
            assert not inner, f"FLOPs inside a while loop: {inner}"
            continue
        for j in _subjaxprs(e.params):
            jaxpr_flops(j, acc, mult * (e.params["length"] if p == "scan"
                                        else 1))
    return acc


# --- one SMALL configuration: the JAX model and its weights, the port's config

class Pair:
    def __init__(self, seed=3):
        self.jcfg, self.tcfg = JConfig(**SMALL), FGNConfig(**SMALL)
        self.fields = _batch_np(seed)
        self.jb = _jbatch(self.fields)
        self.jm = JFGN(cfg=self.jcfg)
        params = jax.jit(
            lambda k, b, r: self.jm.init(k, b, r, method=JFGN.train_forward)
        )(jax.random.PRNGKey(0), self.jb, jax.random.PRNGKey(1))
        self.params = _scaled_reg(jax.device_get(params))


@pytest.fixture(scope="module")
def pair():
    return Pair()


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, ref, tol, what):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = float(np.abs(got - ref).max()) if ref.size else 0.0
    assert err <= tol, f"{what}: max abs diff {err} > {tol}"


def _held_as_test_forward(got, ref, what):
    assert set(got) == set(ref), what
    for k in ("prop_valid", "dt_valid", "dt_cats"):
        assert np.array_equal(_np(got[k]), _np(ref[k])), f"{what}: {k}"
    assert _np(ref["dt_valid"]).any() and _np(ref["prop_valid"]).any()
    for k, tol in (("proposals", TOL * IMG), ("prop_scores", TOL),
                   ("dt_boxes", TOL * IMG), ("dt_scores", TOL),
                   ("dt_mask_logits", TOL)):
        _close(got[k], ref[k], tol, f"{what}: {k}")


def _model_cfg(cfg):
    """The model dict the benchmark's configs hold, from an FGNConfig."""
    return {k: (list(v) if isinstance(v, tuple) else v)
            for k, v in cfg.__dict__.items()}


def _harness_cfg(pair):
    """SMALL at the Pair's geometry, as a benchmark config."""
    B, H, W = pair.fields["qry_img"].shape[:3]
    S = pair.fields["spp_imgs"].shape[2]
    G = pair.fields["qry_boxes"].shape[1]
    return B, {"geometry": dict(H=H, W=W, S=S, max_gt=G),
               "model": _model_cfg(pair.tcfg)}


def _anchors(m, geo):
    return ((-(-geo["H"] // m["stride"])) * (-(-geo["W"] // m["stride"]))
            * len(m["anchor_scales"]) * len(m["anchor_ratios"]))


def test_serve_flops_match_jax_jaxpr(pair):
    """The benchmark's count of a request (``serve_flops_per_img``, the
    reference's convolutions and matrix products on the meta device, plus
    RoIAlign and NMS counted from shapes) less the RoIAlign and NMS terms,
    counted here from shapes, against the jaxpr of the JAX package's
    ``test_forward``."""
    from benchmark.harness import flops

    jx = jax.make_jaxpr(
        lambda p, b: pair.jm.apply(p, b, method=JFGN.test_forward)
    )(pair.params, pair.jb)
    ref = jaxpr_flops(jx.jaxpr)
    nb, cfg = _harness_cfg(pair)
    m, geo = cfg["model"], cfg["geometry"]
    NK, C = m["n_ways"] * m["k_shots"], m["feat_channels"]
    P, D = m["rpn_test_max_per_img"], m["rcnn_max_per_img"]
    roi = 32 * 49 * nb * (NK * (C + 1) + (P + D) * C)
    nms = 12 * nb * (min(m["rpn_test_nms_pre"], _anchors(m, geo))
                     + P * m["n_ways"])
    got = flops.serve_flops_per_img(cfg, nb) * nb - roi - nms
    want = ref["conv"] + ref["dot"]
    assert abs(got / want - 1) <= FLOP_TOL, (got, ref)
    # the naive count of the dilated convolutions is what the tolerance
    # must not absorb
    assert (ref["conv_naive"] + ref["dot"]) / want - 1 > 100 * FLOP_TOL


def test_train_flops_match_jax_jaxpr(pair):
    """The benchmark's count of a training step (``train_flops_per_img``:
    forward and backward of the summed losses) less its RoIAlign and NMS
    terms against the jaxpr of the JAX gradient of the summed losses (the
    optax update holds no convolution or dot)."""
    from benchmark.harness import flops

    jm = pair.jm

    def loss(p, b, r):
        out = jm.apply(p, b, r, method=JFGN.train_forward)
        return sum(v for k, v in out.items() if k.startswith("loss_"))

    jx = jax.make_jaxpr(jax.grad(loss))(pair.params, pair.jb,
                                       jax.random.PRNGKey(2))
    ref = jaxpr_flops(jx.jaxpr)
    nb, cfg = _harness_cfg(pair)
    m, geo = cfg["model"], cfg["geometry"]
    NK, C, R = m["n_ways"] * m["k_shots"], m["feat_channels"], m["rcnn_num_samples"]
    feat = 49 * C * nb * (NK + R)
    pos = max(int(R * m["rcnn_pos_fraction"]), 1)
    masks = nb * NK * 49 + nb * pos * m["mask_size"] ** 2 * geo["max_gt"]
    # the map's gradient: SMALL trains its backbone
    assert not m["backbone_frozen"]
    roi = 32 * (2 * feat + masks)
    nms = 12 * nb * min(m["rpn_train_nms_pre"], _anchors(m, geo))
    got = flops.train_flops_per_img(cfg, nb) * nb - roi - nms
    want = ref["conv"] + ref["dot"]
    assert abs(got / want - 1) <= FLOP_TOL, (got, ref)


def test_peak_table():
    from benchmark.harness import flops

    p = flops.peaks("NVIDIA H100 80GB HBM3")
    assert p["bf16"] == 989.4e12 and p["hbm"] == 3.35e12
    assert "data sheet" in p["source"]
    for name in ("NVIDIA A100-SXM4-80GB", "cpu"):
        with pytest.raises(KeyError):
            flops.peaks(name)


def test_entry_imports_no_jax():
    code = ("import sys, fgn_torch.entry; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'fgn_tpu')))")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]", r.stdout
    for line in (ROOT / "fgn_torch" / "entry.py").read_text().splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]):
            assert words[1].split(".")[0] not in (
                "jax", "flax", "optax", "fgn_tpu"), line


@pytest.fixture(scope="module")
def entries():
    jfn, (jparams, jbatch) = graft.entry()
    fn, (model, batch) = entry.entry(device="cpu")
    return jfn, jax.device_get(jparams), jbatch, fn, model, batch


def test_entry_example_batch_equals_jax(entries):
    _jfn, _jp, jbatch, _fn, _model, batch = entries
    assert jbatch._fields == batch._fields[:len(jbatch._fields)]
    for k in jbatch._fields:
        a, b = np.asarray(getattr(jbatch, k)), getattr(batch, k).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k
    assert batch.qry_img.shape == (1, 480, 480, 3)


def _jax_model(jfn):
    """The model the JAX ``fn`` closes over."""
    cells = dict(zip(jfn.__code__.co_freevars,
                     (c.cell_contents for c in jfn.__closure__)))
    return cells["model"]


def test_entry_fn_matches_jax_fn(entries):
    jfn, jparams, _jb, fn, model, _b = entries
    jm = _jax_model(jfn)
    jcfg = dataclasses.asdict(jm.cfg)
    tcfg = dataclasses.asdict(model.cfg)
    assert {k: jcfg[k] for k in tcfg} == tcfg  # the same flagship
    params = _scaled_reg(jparams)
    load_flax_params(model, params)
    fields = {k: np.asarray(v) for k, v in
              graft._toy_batch(B=1, H=64, W=64, N=3, K=3, S=32)._asdict().items()}
    small = from_numpy(**fields)
    jsmall = _jbatch(fields)
    # bf16, as returned: both run, same keys, shapes, dtypes, finite
    jout = jax.jit(jfn)(params, jsmall)
    tout = fn(model, small)
    assert set(jout) == set(tout)
    for k, v in tout.items():
        assert tuple(v.shape) == np.asarray(jout[k]).shape, k
        assert str(v.dtype).split(".")[-1] == str(np.asarray(jout[k]).dtype), k
        if v.is_floating_point():
            assert torch.isfinite(v).all(), k
    # f32: the same fn on the model cast to f32, against the JAX fn's graph
    # at f32
    m32 = FGN(dataclasses.replace(model.cfg, compute_dtype="float32")).eval()
    m32.load_state_dict(model.state_dict())
    jm32 = JFGN(cfg=dataclasses.replace(jm.cfg, compute_dtype="float32"))
    ref = jax.jit(lambda p, b: jm32.apply(p, b, method=JFGN.test_forward))(
        params, jsmall)
    _held_as_test_forward(fn(m32, small), ref, "entry fn f32")


def test_entry_batch_is_toy_batch():
    b = toy_batch(B=1, H=480, W=480, N=3, K=3, S=128)
    _fn, (_m, got) = entry.entry(device="cpu")
    for k in b._fields:
        assert torch.equal(getattr(b, k), getattr(got, k)), k
