"""fgn_torch.bench and fgn_torch.entry against the JAX package's bench.py and
__graft_entry__.entry(), on the CPU at toy geometry, with the JAX package's
weights loaded through ``fgn_torch.bridge``.

Tolerances:
  * the chained forward: two chained steps, each step's outputs held as
    tests/test_torch_model.py holds ``test_forward`` end to end (f32 on both
    sides): valid masks and classes equal; proposals and detection boxes
    ≤ 1e-4 of the 64 px image side; scores and mask logits ≤ 1e-4; the
    chain's scalar, max(dt_scores) · 1e-9, ≤ 1e-4 · 1e-9;
  * FLOPs: the port's count (``FlopCounterMode`` less the kernels' calls)
    within 1e-5 of the JAX jaxpr's count of ``conv_general_dilated`` and
    ``dot_general`` at 2 a multiply-add, a convolution whose input is
    dilated (``lhs_dilation``: the transposed mask deconvolution, and the
    input gradients of strided convolutions) counted at its multiply-adds
    with the input's nonzero entries, the naive count over the dilated input
    divided by the dilation's product (the naive count is 1.2 % larger in
    the forward here). The residual, 1.1e-6 of the forward's count, is the
    JAX graph's one-hot selections done as ``dot_general`` (the way merge
    of the RPN's outputs, 11,520 FLOPs; the detections' support-vector
    gate, 98,304), which the port does with gathers;
  * the FLOP count through the plain versions equals, exactly, the count
    through a stand-in for the kernels' route that the counter cannot see;
    the kernels' own count within 1e-4 (the keep mask's IoUs follow the
    boxes kept and alive, which RoIAlign's order of summation moves: 8e-6
    of the train step's count here);
  * ``entry()``'s example episode equals the JAX one byte for byte; its
    ``fn`` at 64 px with the JAX entry's weights, its model cast to f32,
    is held to the JAX ``fn``'s graph at f32 as ``test_forward`` is above
    (bf16 on both sides differs by more than any useful bound: proposal
    scores by 0.11 at these random weights, so the bf16 run is held to
    shapes, dtypes and finite values only).
"""

import ast
import dataclasses
import json
import math
import os
import subprocess
import sys
from collections import Counter
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from fgn_tpu.models.fgn import FGN as JFGN
from fgn_tpu.models.fgn import FGNConfig as JConfig
from fgn_torch import bench, entry
from fgn_torch.bridge import load_flax_params
from fgn_torch.config import FGNConfig
from fgn_torch.data.batching import from_numpy, toy_batch
from fgn_torch.models.fgn import FGN
from fgn_torch.train.optim import build_optimizer, make_lr_schedule
from fgn_torch.train.train_step import make_train_step
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


# --- one SMALL configuration on both sides, f32, the same weights -----------

class Pair:
    def __init__(self, seed=3):
        self.jcfg, self.tcfg = JConfig(**SMALL), FGNConfig(**SMALL)
        self.fields = _batch_np(seed)
        self.jb = _jbatch(self.fields)
        self.tb = from_numpy(**self.fields)
        self.jm = JFGN(cfg=self.jcfg)
        params = jax.jit(
            lambda k, b, r: self.jm.init(k, b, r, method=JFGN.train_forward)
        )(jax.random.PRNGKey(0), self.jb, jax.random.PRNGKey(1))
        self.params = _scaled_reg(jax.device_get(params))
        self.tm = FGN(self.tcfg).eval()
        load_flax_params(self.tm, self.params)


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


def test_chained_forward_matches_jax(pair):
    """Two chained steps of bench.chained against bench.py's ``chained``
    on the JAX package's model."""
    jm = pair.jm

    @jax.jit
    def jchained(p, b, bias):
        bb = b._replace(qry_img=b.qry_img + bias)
        out = jm.apply(p, bb, method=JFGN.test_forward)
        return jnp.max(out["dt_scores"]) * 1e-9, out

    jbias, tbias = jnp.float32(0.0), torch.zeros(())
    for i in range(2):
        jbias, jout = jchained(pair.params, pair.jb, jbias)
        with torch.no_grad():
            tbias, tout = bench.chained(pair.tm.test_forward, pair.tb, tbias)
        _held_as_test_forward(tout, jout, f"chained step {i}")
        _close(tbias, jbias, TOL * 1e-9, f"chain scalar after step {i}")
        assert float(tbias) > 0


def test_rounds_run_every_step_and_chain(pair):
    """serve_rounds runs n_iters forwards a round, each on the previous
    one's bias; train_rounds n_iters steps a round; both give one positive
    rate a round on the host clock (CPU)."""
    seen = []

    def forward(b):
        seen.append(b.qry_img)
        return pair.tm.test_forward(b)

    with torch.no_grad():
        rates = bench.serve_rounds(forward, pair.tb, 2, 2, "cpu")
        blocked = bench.serve_rounds(forward, pair.tb, 1, 1, "cpu",
                                     blocked=True)
    assert len(rates) == 2 and len(blocked) == 1 and len(seen) == 5
    assert all(r > 0 and math.isfinite(r) for r in rates + blocked)
    # the chain starts at 0; the next forward sees the first one's scalar
    # (the chain is a dependency: a bias of ~1e-10 moves only the pixels
    # near 0, and two forwards may give the same scalar)
    assert torch.equal(seen[0], pair.tb.qry_img)
    assert not torch.equal(seen[1], seen[0])
    calls = []
    trates = bench.train_rounds(lambda b, g: calls.append(g), pair.tb,
                                torch.Generator(), 3, 2, "cpu")
    assert len(trates) == 2 and len(calls) == 6


def test_forward_flops_match_jax_jaxpr(pair):
    jx = jax.make_jaxpr(
        lambda p, b: pair.jm.apply(p, b, method=JFGN.test_forward)
    )(pair.params, pair.jb)
    ref = jaxpr_flops(jx.jaxpr)
    with torch.no_grad():
        got = bench.count_flops(lambda: pair.tm.test_forward(pair.tb))
    want = ref["conv"] + ref["dot"]
    assert abs(got["flops"] / want - 1) <= FLOP_TOL, (got["flops"], ref)
    # the naive count of the dilated convolutions is what the tolerance
    # must not absorb
    assert (ref["conv_naive"] + ref["dot"]) / want - 1 > 100 * FLOP_TOL
    # K1 (3 calls) and K2 (2 calls) counted apart, from their shapes
    assert got["kernel_flops"] > 0


def test_train_flops_match_jax_jaxpr(pair):
    """The train step's count (forward, backward, optimizer) against the
    jaxpr of the JAX gradient of the summed losses (the optax update holds
    no convolution or dot)."""
    jm = pair.jm

    def loss(p, b, r):
        out = jm.apply(p, b, r, method=JFGN.train_forward)
        return sum(v for k, v in out.items() if k.startswith("loss_"))

    jx = jax.make_jaxpr(jax.grad(loss))(pair.params, pair.jb,
                                       jax.random.PRNGKey(2))
    ref = jaxpr_flops(jx.jaxpr)
    tm = FGN(pair.tcfg).train()
    tm.load_state_dict(pair.tm.state_dict())
    opt = build_optimizer(tm, optimizer="adam",
                          schedule=make_lr_schedule(5e-3, steps_per_epoch=1000))
    step = make_train_step(tm, opt)
    got = bench.count_flops(lambda: step(pair.tb, torch.Generator()))
    want = ref["conv"] + ref["dot"]
    assert abs(got["flops"] / want - 1) <= FLOP_TOL, (got["flops"], ref)
    assert "aten.convolution_backward" in got["by_op"]


def test_flop_count_independent_of_route(pair):
    """The plain versions (their einsums counted, then left out) against a
    stand-in for the kernels' route: the same results through functions
    the counter sees no matmul in (the staged kernels' arithmetic in torch,
    and the walk), as ctypes launches are unseen. Forward and train step."""
    import fgn_torch.ops.nms_cuda as nc
    import fgn_torch.ops.roi_align_cuda as rac
    from fgn_torch.ops.nms import _greedy_alive_walk
    from torch.utils.flop_counter import FlopCounterMode

    tm = FGN(pair.tcfg).train()
    tm.load_state_dict(pair.tm.state_dict())
    opt = build_optimizer(tm, optimizer="sgd",
                          schedule=make_lr_schedule(0.0, steps_per_epoch=1))
    step = make_train_step(tm, opt)

    def runs():
        with torch.no_grad():
            fwd = bench.count_flops(lambda: pair.tm.test_forward(pair.tb))
        return fwd, bench.count_flops(lambda: step(pair.tb,
                                                   torch.Generator()))

    plain = runs()
    stand_in = (
        mock.patch.object(rac, "_roi_align_plain", rac._roi_align_separable),
        mock.patch.object(rac, "_roi_align_plain_bwd",
                          rac._roi_align_bwd_ordered),
        mock.patch.object(nc, "_greedy_alive",
                          lambda b, a, t, _blk: _greedy_alive_walk(b, a, t)))
    for p in stand_in:
        p.start()
    try:
        unseen = runs()
        with torch.no_grad(), FlopCounterMode(display=False) as raw:
            pair.tm.test_forward(pair.tb)
    finally:
        for p in stand_in:
            p.stop()
    for a, b in zip(plain, unseen):
        assert a["flops"] == b["flops"] and a["by_op"] == b["by_op"]
        # the keep mask's count follows its kept and alive boxes, which the
        # stand-in's other order of summation in RoIAlign moves by a few
        assert abs(a["kernel_flops"] / b["kernel_flops"] - 1) <= 1e-4
    # nothing was left out on the stand-in's route; on the plain route the
    # einsums were
    assert raw.get_total_flops() == unseen[0]["flops"]
    with torch.no_grad(), FlopCounterMode(display=False) as raw:
        pair.tm.test_forward(pair.tb)
    assert raw.get_total_flops() > plain[0]["flops"]


def test_kernel_calls_left_out_wherever_reached():
    """The wrappers themselves leave their calls out of a count, whoever
    calls them: RoIAlign forward and backward called directly, and the keep
    mask through ``nms_padded``'s default ``alive_fn``. The plain versions'
    einsums on these CPU tensors would count; the kernels' own operations
    are counted apart, and outside a count nothing is computed for them."""
    import fgn_torch.ops.nms_cuda as nc
    from fgn_torch.ops import flops
    from fgn_torch.ops.nms import nms_padded
    from fgn_torch.ops.roi_align_cuda import roi_align_cuda
    from torch.utils.flop_counter import FlopCounterMode

    gen = torch.Generator().manual_seed(0)
    fmap = torch.randn(2, 8, 8, 16, generator=gen, requires_grad=True)
    xy = torch.rand(2, 5, 2, generator=gen) * 5
    rois = torch.cat([xy, xy + 1 + torch.rand(2, 5, 2, generator=gen) * 2], -1)

    def fwd_bwd():
        roi_align_cuda(fmap, rois).square().sum().backward()

    got = flops.count_flops(fwd_bwd)
    assert got["flops"] == 0 and got["by_op"] == {}, got
    out_numel = 2 * 5 * 7 * 7 * 16
    assert got["kernel_flops"] == 2 * flops.ROI_ALIGN_FLOPS * out_numel
    with FlopCounterMode(display=False) as raw:
        fwd_bwd()
    assert raw.get_total_flops() > 0  # what was left out

    boxes = torch.cat([xy, xy + 2], -1).reshape(1, 10, 4)
    scores = torch.rand(1, 10, generator=gen)
    valid = torch.ones(1, 10, dtype=torch.bool)
    seen = []
    real = flops.k2_ops
    with mock.patch.object(nc, "k2_ops",
                           lambda k, a: seen.append((k, a)) or real(k, a)):
        nms_padded(boxes, scores, valid, 0.5, 10)
        assert seen == []  # no count in progress: no work counted
        got = flops.count_flops(lambda: nms_padded(boxes, scores, valid, 0.5,
                                                   10))
    (keep, alive), = seen
    assert keep.shape == alive.shape == (1, 128)
    assert got["kernel_flops"] == real(keep, alive) > 0


def test_peak_table():
    peak, source = bench.peak_flops("NVIDIA H100 80GB HBM3")
    assert peak == 989.4e12 and "data sheet" in source
    assert bench.peak_flops("NVIDIA H100 PCIe")[0] == 756e12
    with pytest.raises(KeyError, match="no bf16 peak"):
        bench.peak_flops("NVIDIA A100-SXM4-80GB")
    with pytest.raises(KeyError):
        bench.peak_flops("cpu")


def _bench_py_fields():
    """The keys of bench.py's JSON line, read from its source: the ``out``
    dict of ``main`` and the ``coco[...]`` keys, f-strings expanded over the
    loop's tags."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    keys, tags = set(), []
    for node in ast.walk(main):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == "out"
                        for t in node.targets)):
            keys |= {k.value for k in node.value.keys}
        if (isinstance(node, ast.For) and isinstance(node.target, ast.Tuple)
                and getattr(node.target.elts[0], "id", "") == "tag"):
            tags = [e.elts[0].value for e in node.iter.elts]
    for node in ast.walk(main):
        if (isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Store)
                and getattr(node.value, "id", "") == "coco"):
            s = node.slice
            if isinstance(s, ast.Constant):
                keys.add(s.value)
            else:
                parts = [p.value if isinstance(p, ast.Constant) else "{tag}"
                         for p in s.values]
                keys |= {"".join(parts).replace("{tag}", t) for t in tags}
    return keys


def test_json_line_has_every_bench_py_field(monkeypatch):
    """``run`` + ``report`` on the CPU at toy geometry (64 px, SMALL's
    sampler sizes, 1 step a round): every bench.py field, the rounds beside
    each median, every ``mfu`` positive, JSON-serialisable."""
    want = _bench_py_fields()
    assert {"value", "blocked", "train", "mfu", "mfu_b4",
            "coco2voc_n1k1_imgs_s", "coco2voc_n3k3_mfu",
            "coco2voc_hw"} <= want
    small = {k: v for k, v in SMALL.items() if k.startswith(("rpn", "rcnn"))}
    make = bench.make_model
    monkeypatch.setattr(
        bench, "make_model",
        lambda n, k, device, **kw: make(n, k, device, **{**small, **kw}))
    res = bench.run("cpu", batch=2, batch_alt=1, train_batch=2, n_iters=1,
                    n_rounds=1, coco_batch=1,
                    flagship=bench.Geometry(64, 64, 32),
                    coco2voc=bench.Geometry(64, 96, 32), peak=1e12)
    out = json.loads(json.dumps(bench.report(res)))
    assert want <= set(out), sorted(want - set(out))
    for k in ("value_rounds", "blocked_rounds", "value_b4_rounds",
              "train_rounds", "coco2voc_n1k1_rounds", "coco2voc_n3k3_rounds",
              "power_limit_w"):
        assert k in out, k
    assert len(out["value_rounds"]) == 1 and len(out["train_rounds"]) == 3
    for k in ("mfu", "mfu_b4", "train_mfu", "coco2voc_n1k1_mfu",
              "coco2voc_n3k3_mfu"):
        assert 0 < out[k] < 1, (k, out[k])
    assert out["coco2voc_hw"] == "64x96" and out["device"] == "cpu"
    # the settings read back from the workloads that ran
    assert (out["iters"], out["rounds"], out["batch_alt"],
            out["train_steps_per_round"], out["train_remat"]) == (1, 1, 1, 5,
                                                                  "")
    assert out["flops_per_img"] > 0 and out["train_flops_per_img"] > 0


def test_cli_without_cuda_exits_nonzero_without_json():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", "fgn_torch.bench"], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "{" not in r.stdout, r.stdout
    assert "no CUDA device" in r.stderr


def test_bench_and_entry_import_no_jax():
    code = ("import sys, fgn_torch.bench, fgn_torch.entry; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'fgn_tpu')))")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]", r.stdout
    for name in ("bench.py", "entry.py"):
        for line in (ROOT / "fgn_torch" / name).read_text().splitlines():
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
