"""K5, the optimizer's multi-tensor kernel, on the CPU through its twin.

``FGNOptimizer.step`` is driven down K5's route on CPU tensors: ``takes``
is asked as if each tensor were on the card, and ``optim_cuda.run`` is
replaced by ``twin``, which reads the packed records and block tables as
the kernel does, finds each tensor by its address and updates it chunk by
chunk in the kernel's order of operations. Each case is held bit for bit to
the plain route (``takes`` left as it is, so every tensor goes there on the
CPU) over four steps with a warmup and a decay boundary: the parameters,
the state, Adam's step counts and the counters. The card holds the kernel
to the plain route the same way (``chip_smoke.py::k5_check``).
"""

import contextlib
import re
import types
from unittest import mock

import numpy as np
import pytest
import torch

from fgn_torch.ops import _build, optim_cuda
from fgn_torch.train import optim as t_optim
from fgn_torch.utils import profiling

C = optim_cuda.CHUNK

# case → (named shapes, optimizer keywords, steps whose gradient of a name
# is None, optim_cuda's MAX_TENSORS and MAX_BLOCKS if lowered)
CASES = {
    "missing_grad": (
        [("backbone.conv1.weight", (4, 3, 3, 3)), ("rpn_cls.weight", (6, 5)),
         ("fc_cls.bias", (7,))],
        {}, {"rpn_cls.weight": (0, 1, 2), "backbone.conv1.weight": (1,)}, {}),
    "frozen_group": (
        [("backbone.conv1.weight", (8, 3, 3, 3)), ("backbone.gn.scale", (8,)),
         ("rpn_reg.weight", (12, 8)), ("mask_logits.bias", (3,))],
        {"frozen_modules": ("backbone",)}, {}, {}),
    "roi_lr": (
        [("rpn_cls.weight", (9, 17)), ("shared5.conv.weight", (16, 9)),
         ("rel_gn.scale", (33,)), ("fc_reg.weight", (12, 5))],
        {"roi_head_lr_mult": 0.1}, {}, {}),
    "ragged": (
        [("backbone.a", (2 * C + 3,)), ("backbone.b", (C - 1,)),
         ("fc_cls.c", (5,)), ("rpn_cls.d", (C + 4,))],
        {}, {}, {}),
    "scalars": (
        [("backbone.scale", ()), ("rpn_cls.bias", (1,)), ("fc_cls.empty", (0,)),
         ("fc_reg.bias", (2,))],
        {}, {}, {}),
    "many_tensors": (
        [(f"{'rel_gn' if i % 3 == 0 else 'backbone'}.w{i}", (i % 7 + 1,))
         for i in range(optim_cuda.MAX_TENSORS + 6)],
        {}, {"backbone.w1": (1,)}, {}),
    "split_tensor": (
        [("backbone.big", (5 * C + 7,)), ("fc_cls.w", (C + 1,)),
         ("rpn_cls.b", (11,))],
        {}, {}, {"MAX_TENSORS": 2, "MAX_BLOCKS": 3}),
    "cumulative_2": (
        [("backbone.conv1.weight", (4, 3, 3, 3)), ("backbone.big", (C + 9,)),
         ("rpn_cls.weight", (6, 5)), ("fc_cls.bias", (7,))],
        {"cumulative_iters": 2}, {"rpn_cls.weight": (0, 1),
                                  "fc_cls.bias": (2,)}, {}),
}


def update(kind, p, g, s0, s1, step, wd, r1, r2):
    """The kernel's arithmetic on one chunk, in place, in its order: torch
    ops, each rounding as the kernel's."""
    if kind == "adagrad":
        s0.add_(g * g)
        inv = torch.where(s0 > 0, torch.rsqrt(s0 + 1e-7),
                          torch.zeros((), dtype=s0.dtype))
        u = inv * g
    else:
        s0.copy_(0.1 * g + 0.9 * s0)
        s1.copy_(0.001 * (g * g) + 0.999 * s1)
        u = (s0 * r1) / (torch.sqrt(s1 * r2) + 1e-8)
    u = u + wd * p
    p.add_(step * u)


def twin(kind, records, launches, memory):
    """``optim_cuda.run`` in torch ops on CPU tensors: each launch's records
    as the kernel reads them, each block's chunk updated by ``update``;
    ``memory`` maps an address to the tensor that starts there."""
    for launch in launches:
        recs = records[launch.tensors]
        for e in launch.blocks.tolist():
            r = recs[e & 0xFF]
            start = (e >> 8) * C
            stop = min(start + C, int(r["n"]))

            def chunk(ptr):
                return memory[int(ptr)].view(-1)[start:stop]

            p = chunk(r["p"])
            g = chunk(r["g"]) if r["g"] else torch.zeros_like(p)
            s1 = chunk(r["s1"]) if kind == "adam" else None
            update(kind, p, g, chunk(r["s0"]), s1, float(r["step"]),
                   float(r["wd"]), float(r["r1"]), float(r["r2"]))


def on_card(kind, p, takes=optim_cuda.takes):
    """``optim_cuda.takes`` asked as if ``p`` were on the card."""
    return takes(kind, types.SimpleNamespace(is_cuda=True, dtype=p.dtype))


@contextlib.contextmanager
def limits(**kw):
    """optim_cuda's launch limits lowered to ``kw``, ``plan``'s cache
    cleared on the way in and out."""
    optim_cuda.plan.cache_clear()
    try:
        with contextlib.ExitStack() as stack:
            for name, v in kw.items():
                stack.enter_context(mock.patch.object(optim_cuda, name, v))
            yield
    finally:
        optim_cuda.plan.cache_clear()


def _grads(shapes, missing, steps, seed):
    r = np.random.RandomState(seed)
    return [{n: None if s in missing.get(n, ()) else
             torch.from_numpy(np.asarray(r.randn(*shape) * 0.05,
                                         dtype=np.float32))
             for n, shape in shapes} for s in range(steps)]


def _memory(opt):
    """Every tensor the kernel may read, by address: parameters, gradients,
    state."""
    out = {}
    for group in opt.param_groups:
        for p in group["params"]:
            for t in (p, p.grad, *opt.state[p].values()):
                if isinstance(t, torch.Tensor) and t.numel():
                    out[t.data_ptr()] = t
    return out


def _covered(launches, numels, max_tensors, max_blocks):
    """Every chunk of every tensor in exactly one block, within the
    limits."""
    seen = []
    for launch in launches:
        assert 1 <= len(launch.tensors) <= max_tensors
        assert 1 <= len(launch.blocks) <= max_blocks
        for e in launch.blocks.tolist():
            seen.append((int(launch.tensors[e & 0xFF]), e >> 8))
    want = [(i, c) for i, n in enumerate(numels) for c in range(-(-n // C))]
    assert sorted(seen) == want


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("rule", ["adagrad", "adam"])
def test_k5_twin_matches_plain_route(rule, case):
    shapes, kw, missing, lowered = CASES[case]
    steps, k = 4, kw.get("cumulative_iters", 1)
    r = np.random.RandomState(0)
    init = {n: torch.from_numpy(np.asarray(r.randn(*s), dtype=np.float32))
            for n, s in shapes}
    grads = _grads(shapes, missing, steps, seed=1)
    sched = t_optim.make_lr_schedule(5e-3, steps_per_epoch=2 // k,
                                     decay_epochs=(1,), warmup_iters=2 // k)
    frozen = kw.get("frozen_modules", ())
    updated = [n for n, _ in shapes
               if t_optim.param_label(n, frozen) != "frozen"]
    numels = tuple(int(np.prod(s)) for n, s in shapes if n in updated)
    runs = {}
    with limits(**lowered):
        launches = optim_cuda.plan(numels)
        _covered(launches, numels, optim_cuda.MAX_TENSORS,
                 optim_cuda.MAX_BLOCKS)
        for route in ("plain", "k5"):
            params = [(n, torch.nn.Parameter(init[n].clone()))
                      for n, _ in shapes]
            opt = t_optim.FGNOptimizer(params, optimizer=rule,
                                       schedule=sched, **kw)
            ran = []

            def fake_run(kind, records, launches, device):
                assert device == torch.device("cpu")
                twin(kind, records, launches, _memory(opt))
                ran.append(len(launches))

            counted = []
            for s in range(steps):
                for n, p in params:
                    p.grad = grads[s][n]
                profiling.reset()
                with contextlib.ExitStack() as patches:
                    if route == "k5":
                        for name, new in (("takes", on_card),
                                          ("run", fake_run)):
                            patches.enter_context(
                                mock.patch.object(optim_cuda, name, new))
                    opt.step()
                counted.append(profiling.counts())
            runs[route] = (params, opt, counted, ran)

    (pa, oa, ca, _), (pb, ob, cb, ran) = runs["plain"], runs["k5"]
    for (n, a), (_, b) in zip(pa, pb):
        assert torch.equal(a, b), n
        moved = not torch.equal(a, init[n])
        if n not in updated:
            assert not moved, n
        elif a.numel() and any(g[n] is not None for g in grads):
            assert moved, n
        sa, sb = oa.state[a], ob.state[b]
        assert sa.keys() == sb.keys(), n
        for key in sa:
            if isinstance(sa[key], torch.Tensor):
                assert torch.equal(sa[key], sb[key]), (n, key)
            else:
                assert sa[key] == sb[key], (n, key)
    assert oa.state["count"] == ob.state["count"] == steps // k
    applied = [(s + 1) % k == 0 for s in range(steps)]
    for c, a in zip(ca, applied):
        assert c == ({"opt.plain_tensors": len(updated)} if a else {})
    for c, a in zip(cb, applied):
        assert c == ({"opt.plain_tensors": 0, "k5.tensors": len(updated)}
                     if a else {})
    assert ran == [len(launches)] * (steps // k)


def test_takes():
    """K5 takes a CUDA float32 tensor under Adagrad or Adam; the plain
    route keeps the CPU, float64, SGD and Adadelta."""
    card = types.SimpleNamespace(is_cuda=True, dtype=torch.float32)
    assert optim_cuda.takes("adagrad", card)
    assert optim_cuda.takes("adam", card)
    for kind in ("sgd", "adadelta"):
        assert not optim_cuda.takes(kind, card)
    assert not optim_cuda.takes(
        "adagrad", types.SimpleNamespace(is_cuda=True, dtype=torch.float64))
    assert not optim_cuda.takes("adagrad", torch.zeros(3))  # a CPU tensor


@pytest.mark.parametrize("bad", ["strided_param", "strided_grad",
                                 "other_layout_grad", "f64_state",
                                 "other_layout_state"])
def test_record_raises(bad):
    """A tensor K5 takes goes to the kernel or raises: a parameter that does
    not fill its memory in order, a gradient or state of another dtype or
    layout."""
    p = torch.zeros(2, 3, 4, 5)
    g, states = torch.ones(2, 3, 4, 5), [torch.zeros(2, 3, 4, 5)]
    optim_cuda.record(p, g, states, -1e-3, 1e-5)
    optim_cuda.record(p, None, states, -1e-3, 1e-5)
    cl = torch.channels_last
    optim_cuda.record(p.to(memory_format=cl), g.to(memory_format=cl),
                      [states[0].to(memory_format=cl)], -1e-3, 1e-5)
    if bad == "strided_param":
        p = torch.zeros(2, 3, 4, 10)[..., ::2]
    elif bad == "strided_grad":
        g = torch.ones(2, 3, 4, 10)[..., ::2]
    elif bad == "other_layout_grad":
        g = g.to(memory_format=cl)
    elif bad == "f64_state":
        states = [states[0].double()]
    else:
        states = [states[0].to(memory_format=cl)]
    with pytest.raises(ValueError, match="optimizer kernel"):
        optim_cuda.record(p, g, states, -1e-3, 1e-5)


@pytest.mark.parametrize("rule", ["adagrad", "adam"])
@pytest.mark.parametrize("k", [1, 2])
def test_routes(rule, k):
    """Every tensor K5 takes reaches it, the ``MultiSteps`` mean on the step
    that applies it, in one ``run`` per device; SGD stays plain."""
    params = [("a", torch.nn.Parameter(torch.ones(3))),
              ("b", torch.nn.Parameter(torch.ones(3, device="meta"))),
              ("c", torch.nn.Parameter(torch.ones(2)))]
    for kind, fused in ((rule, True), ("sgd", False)):
        opt = t_optim.FGNOptimizer(params, optimizer=kind,
                                   cumulative_iters=k)
        profiling.reset()
        with mock.patch.object(optim_cuda, "takes", on_card), \
                mock.patch.object(optim_cuda, "run") as run:
            for _ in range(k):
                for _, p in params:
                    p.grad = torch.ones_like(p)
                opt.step()
        if not fused:
            assert not run.called
            assert profiling.counts() == {"opt.plain_tensors": 3}
            continue
        assert [c.args[3] for c in run.call_args_list] == [
            torch.device("cpu"), torch.device("meta")]
        cpu_records = run.call_args_list[0].args[1]
        assert len(cpu_records) == 2
        if k > 1:  # the gradient is the mean, not p.grad
            want = [opt.state[p]["acc_grad"].data_ptr()
                    for n, p in params if n != "b"]
            assert cpu_records["g"].tolist() == want
        assert profiling.counts() == {"opt.plain_tensors": 0,
                                      "k5.tensors": 3}


def _constants(src: str):
    return {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (k\w+) = (\d+);", src)}


def test_layout_matches_source():
    """The record, the limits and the chunk that ``optim_cuda`` packs are
    the ones ``csrc/optim.cu`` reads."""
    src = (_build.SRC_DIR / "optim.cu").read_text()
    k = _constants(src)
    assert (k["kMaxTensors"], k["kMaxBlocks"], k["kChunk"]) == (
        optim_cuda.MAX_TENSORS, optim_cuda.MAX_BLOCKS, optim_cuda.CHUNK)
    body = re.search(r"struct TensorRec \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = re.findall(r"(\w+)\s*[;,]", body)
    assert fields == list(optim_cuda.TENSOR.names)
    assert optim_cuda.TENSOR.itemsize == 56
    assert "sizeof(TensorRec) == 56" in src
    assert optim_cuda.RULES == {"adagrad": 0, "adam": 1}
    assert "kAdagrad = 0, kAdam = 1" in src
    assert (56 * optim_cuda.MAX_TENSORS + 4 * optim_cuda.MAX_BLOCKS
            <= 32764)
