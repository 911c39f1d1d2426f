"""K3's wrapper (``fgn_torch/ops/group_norm_cuda.py``) on the CPU.

The CUDA kernel runs only on the card (``chip_smoke.py``, phase
``group_norm``). Here:

  * the ``GroupNorm`` module's call, which takes the plain version on a CPU
    tensor, equals the composition the model ran before the kernel bit for
    bit (``F.group_norm`` on the f32 cast, a cast to the compute dtype,
    ``y + residual``, ``F.relu``) in bf16 and in f32, at the stem's, layer1's,
    res5's and the relation head's shapes, with each epilogue;
  * ``ResNetC4`` and ``SharedRes5`` on channels_last inputs give the values
    and the memory formats of that composition, layer by layer;
  * a call that autograd records is routed to ``_GroupNormTrain`` and
    counted as ``gn.train``; a ``no_grad`` call is not (a CPU tensor takes
    the plain version uncounted, any other the kernel);
  * that Function's plain forward and backward bodies on the CPU, which
    hold the kernels' gradient formula, against autograd through the
    composition in f64 (and bf16), with each epilogue, frozen weights or
    input, under ``torch.utils.checkpoint``, at shapes of both backward
    routes;
  * the kernels' routes and sizes (``_plan``, ``_plan_bwd``) at the
    model's shapes, and the channel layouts they refuse (``_layout``).
"""

import pytest
import torch
import torch.nn.functional as F

from fgn_torch.models.fgn import init_params
from fgn_torch.models.resnet import (
    FrozenAffine, GroupNorm, ResNetC4, SharedRes5, _nchw, _nhwc,
)
from fgn_torch.ops.group_norm_cuda import (
    _APPLY_BLOCKS_PER_SM, _BWD_TILES_PER_SM, _SMEM_FOUR_BLOCKS, _SMEM_MAX,
    _SMEM_TWO_BLOCKS, _TILE_BYTES, _bwd_smem, _layout, _plan, _plan_bwd,
    group_norm, group_norm_plain, route,
)
from fgn_torch.utils.profiling import counts

torch.set_num_threads(2)

# (name, N, C, H, W): the stem, layer1, a batch of res5's RoI instances and
# the relation head's (RoI, way) instances.
SHAPES = [
    ("stem", 2, 32, 40, 40),
    ("layer1", 1, 256, 120, 120),
    ("res5-512", 12, 512, 7, 7),
    ("res5-1024", 12, 1024, 7, 7),
    ("rel_gn", 18, 1024, 7, 7),
]
EPILOGUES = ["none", "relu", "residual_relu"]
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def _channels_last(gen, N, C, H, W, dtype, scale=1.0, shift=0.0):
    x = torch.randn((N, H, W, C), generator=gen) * scale + shift
    return _nchw(x.to(dtype))  # NCHW view of NHWC memory


def _old_norm(norm, x):
    """The model's norm before the kernel."""
    if isinstance(norm, GroupNorm):
        dt = torch.promote_types(x.dtype, torch.float32)
        return F.group_norm(x.to(dt), norm.num_groups, norm.weight.to(dt),
                            norm.bias.to(dt), norm.eps).to(norm.dt)
    dt = x.dtype
    return (x * norm.weight.to(dt)[:, None, None]
            + norm.bias.to(dt)[:, None, None])


def _old_bottleneck(blk, x):
    identity = x
    y = F.relu(_old_norm(blk.bn1, blk.conv1(x)))
    y = F.relu(_old_norm(blk.bn2, blk.conv2(y)))
    y = _old_norm(blk.bn3, blk.conv3(y))
    if blk.has_downsample:
        if blk.avg_down and blk.stride > 1:
            identity = F.avg_pool2d(identity, blk.stride, blk.stride)
        identity = _old_norm(blk.ds_bn, blk.ds_conv(identity))
    return F.relu(y + identity)


def _old_layer(layer, x):
    for i in range(layer.num_blocks):
        x = _old_bottleneck(getattr(layer, f"block{i}"), x)
    return x


def _randomize_norms(model, gen):
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (GroupNorm, FrozenAffine)):
                m.weight.copy_(1 + 0.3 * torch.randn(m.weight.shape,
                                                     generator=gen))
                m.bias.copy_(0.2 * torch.randn(m.bias.shape, generator=gen))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_plain_equals_the_old_composition(shape, epilogue, dtype):
    _, N, C, H, W = shape
    dt = DTYPES[dtype]
    gen = torch.Generator().manual_seed(C + H)
    gn = GroupNorm(32, C, 1e-5, dtype=dt)
    _randomize_norms(gn, gen)
    x = _channels_last(gen, N, C, H, W, dt, scale=3.0, shift=0.5)
    res = (_channels_last(gen, N, C, H, W, dt)
           if epilogue == "residual_relu" else None)
    with torch.no_grad():
        got = gn(x, res, relu=epilogue != "none")
        want = _old_norm(gn, x)
        if res is not None:
            want = want + res
        if epilogue != "none":
            want = F.relu(want)
    assert got.dtype == dt
    assert torch.equal(got, want)
    assert got.stride() == want.stride()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("norm", ["gn", "frozen_bn"])
def test_resnet_c4_keeps_values_and_channels_last(norm, dtype):
    gen = torch.Generator().manual_seed(3)
    dt = DTYPES[dtype]
    model = ResNetC4(norm=norm, deep_stem=norm == "gn", avg_down=True,
                     dtype=dt)
    init_params(model, gen)
    _randomize_norms(model, gen)
    x = torch.randn((2, 48, 48, 3), generator=gen).to(dt)
    with torch.no_grad():
        got = model(x)
        # the old forward, stage by stage, each stage's memory format held
        stem = ([(getattr(model, f"stem_conv{i}"),
                  getattr(model, f"stem_bn{i}")) for i in (1, 2, 3)]
                if model.deep_stem else [(model.conv1, model.bn1)])
        y = z = _nchw(x)
        for conv, bn in stem:
            y = F.relu(_old_norm(bn, conv(y)))
            z = bn(conv(z), relu=True)
        y = F.max_pool2d(y, 3, 2, padding=1)
        z = F.max_pool2d(z, 3, 2, padding=1)
        assert torch.equal(z, y)
        for name in ("layer1", "layer2", "layer3"):
            layer = getattr(model, name)
            y, z = _old_layer(layer, y), layer(z)
            assert torch.equal(z, y), name
            assert z.is_contiguous(memory_format=torch.channels_last), name
            assert z.stride() == y.stride(), name
    want = _nhwc(y).contiguous()
    assert torch.equal(got, want)
    assert got.is_contiguous()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_shared_res5_keeps_values_and_channels_last(dtype):
    gen = torch.Generator().manual_seed(5)
    dt = DTYPES[dtype]
    model = SharedRes5(dtype=dt)
    init_params(model, gen)
    _randomize_norms(model, gen)
    x = torch.randn((6, 7, 7, 1024), generator=gen).to(dt)
    with torch.no_grad():
        got = model(x)
        y = _nchw(x)
        for i in range(model.res5.num_blocks):
            blk = getattr(model.res5, f"block{i}")
            y, z = _old_bottleneck(blk, y), blk(y)
            assert torch.equal(z, y)
            assert z.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, _nhwc(y).contiguous())


@pytest.mark.parametrize("model", ["res5", "c4"])
def test_any_nhwc_input_runs_channels_last(model):
    """An NHWC input of other strides (a plain RoIAlign's einsum output)
    reaches every GroupNorm as a channels_last map, as the kernel needs,
    with the values of the contiguous input."""
    gen = torch.Generator().manual_seed(7)
    if model == "res5":
        m, shape = SharedRes5(), (4, 7, 7, 1024)
    else:
        m, shape = ResNetC4(deep_stem=True, avg_down=True), (2, 32, 32, 3)
    init_params(m, gen)
    x = torch.randn(shape, generator=gen)
    strided = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    assert not strided.is_contiguous()
    seen = []
    hooks = [g.register_forward_pre_hook(
        lambda mod, args: seen.append(
            args[0].is_contiguous(memory_format=torch.channels_last)))
        for g in m.modules() if isinstance(g, GroupNorm)]
    with torch.no_grad():
        got, want = m(strided), m(x)
    for h in hooks:
        h.remove()
    assert seen and all(seen)
    assert torch.equal(got, want)


# (which tensors require grad, whether grad is enabled) → route on the CPU
ROUTES = [
    ("params", True, "train"),
    ("params", False, "plain"),
    ("x", True, "train"),
    ("residual", True, "train"),
    ("none", True, "plain"),
    ("none", False, "plain"),
]


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("needs,grad,want", ROUTES,
                         ids=[f"{n}-{'grad' if g else 'no_grad'}"
                              for n, g, _ in ROUTES])
def test_route_follows_autograd(needs, grad, want, device):
    """On the CPU the route is also taken and counted; a meta tensor stands
    for a card's, whose no-grad calls go to the kernel."""
    gen = torch.Generator().manual_seed(0)
    gn = GroupNorm(32, 64, 1e-5, dtype=torch.float32)
    gn.requires_grad_(needs == "params")
    x = _channels_last(gen, 2, 64, 6, 6, torch.float32)
    res = _channels_last(gen, 2, 64, 6, 6, torch.float32)
    x.requires_grad_(needs == "x")
    res.requires_grad_(needs == "residual")
    x, res, w, b = (t.to(device) for t in (x, res, gn.weight, gn.bias))
    if device == "meta" and want == "plain":
        want = "kernel"
    with torch.set_grad_enabled(grad):
        assert route(x, w, b, res) == want
        if device == "meta":
            return
        before = counts().get("gn.train", 0)
        out = gn(x, res, relu=True)
        moved = counts().get("gn.train", 0) - before
    assert moved == (want == "train")
    assert out.requires_grad == (want == "train")
    assert not any(counts().get(k, 0) for k in (
        "gn.onepass", "gn.split", "gn.bwd.onepass", "gn.bwd.split"))


# (name, N, H·W, C, bf16?) at the OMNIISEG model's b8 request: queries at
# 480 px, supports at 128 px (72 of them), res5 over 3,272 RoIs, the
# relation head over 7,200 (RoI, way) pairs; the route each must take.
MODEL_SHAPES = [
    ("stem-q", 8, 240 * 240, 32, "split"),
    ("stem3-q", 8, 240 * 240, 64, "split"),
    ("layer1-q", 8, 120 * 120, 256, "split"),
    ("layer2-q", 8, 60 * 60, 512, "split"),
    ("layer3-q", 8, 30 * 30, 1024, "split"),
    ("stem-s", 72, 64 * 64, 32, "split"),
    ("layer1-s", 72, 32 * 32, 64, "split"),
    ("layer2-s", 72, 16 * 16, 128, "onepass"),
    ("layer3-s", 72, 8 * 8, 256, "onepass"),
    ("layer3-s-out", 72, 8 * 8, 1024, "split"),
    ("res5-512", 3272, 49, 512, "onepass"),
    ("res5-1024", 3272, 49, 1024, "onepass"),
    ("rel_gn", 7200, 49, 1024, "onepass"),
    ("res5-1024-b1", 300, 49, 1024, "onepass"),
]


@pytest.mark.parametrize("N,HW,C,want", [s[1:] for s in MODEL_SHAPES],
                         ids=[s[0] for s in MODEL_SHAPES])
def test_plan_at_the_model_shapes(N, HW, C, want):
    assert _layout(C, 32, 2) is None
    plan = _plan(N, HW, C, 32, 2, 132)
    assert plan.route == want
    assert C * 2 // 16 <= plan.threads
    if want == "onepass":
        room = {256: _SMEM_FOUR_BLOCKS, 512: _SMEM_TWO_BLOCKS}
        assert plan.smem <= room[plan.threads]
        return
    assert plan.threads == 256
    assert plan.smem <= _SMEM_MAX
    assert plan.tile_rows * C * 2 <= max(_TILE_BYTES, C * 2)
    assert plan.tiles == -(-HW // plan.tile_rows)
    assert (plan.tiles - 1) * plan.tile_rows < HW
    blocks = -(-HW // plan.apply_rows)
    assert 1 <= blocks <= plan.tiles
    assert (blocks - 1) * plan.apply_rows < HW
    # about _APPLY_BLOCKS_PER_SM apply blocks an SM, at most one a tile
    assert blocks <= min(plan.tiles, -(-_APPLY_BLOCKS_PER_SM * 132 // N))


def test_plan_block_sizes():
    """256 threads a block where four fit on an SM; 512 for a onepass
    instance that only two fit, or a row of more than 256 chunks; an f32
    res5 instance of 1024 channels (196 KB) fits no two blocks."""
    assert _plan(16, 49, 512, 32, 2, 132)[:2] == ("onepass", 256)
    assert _plan(16, 49, 1024, 32, 2, 132)[:2] == ("onepass", 512)
    assert _plan(16, 49, 512, 32, 4, 132)[:2] == ("onepass", 512)
    assert _plan(16, 49, 1024, 32, 4, 132)[:2] == ("split", 256)
    assert _plan(8, 900, 4096, 32, 2, 132)[:2] == ("split", 512)


@pytest.mark.parametrize("C,G,esize,ok", [
    (32, 32, 2, True), (64, 32, 2, True), (1024, 32, 2, True),
    (1024, 32, 4, True), (96, 32, 2, False), (48, 16, 2, False),
    (8192, 32, 2, False), (100, 32, 2, False), (4096, 32, 2, True),
    (4096, 32, 4, False),
])
def test_layout_refuses_what_the_kernel_cannot_take(C, G, esize, ok):
    assert (_layout(C, G, esize) is None) == ok


def test_launch_checks_before_anything_runs():
    """The kernel's checks raise on a tensor the kernel cannot take (here a
    CPU tensor passed straight to the launch path)."""
    from fgn_torch.ops.group_norm_cuda import _launch

    x = torch.zeros((1, 32, 4, 4))
    w = torch.ones(32)
    with pytest.raises(ValueError, match="unsupported device"):
        _launch(x, 32, w, torch.zeros(32), 1e-5, torch.float32, None, False)


def test_group_norm_function_matches_module():
    gen = torch.Generator().manual_seed(1)
    gn = GroupNorm(32, 256, 1e-5, dtype=torch.bfloat16)
    _randomize_norms(gn, gen)
    x = _channels_last(gen, 2, 256, 9, 9, torch.bfloat16)
    with torch.no_grad():
        assert torch.equal(
            group_norm(x, 32, gn.weight, gn.bias, 1e-5, torch.bfloat16,
                       None, True),
            gn(x, relu=True))


# (name, N, C, H, W, residual, relu, (x, weight/bias, residual) require
# grad, dtype, checkpoint, the backward route _plan_bwd gives the shape at
# its N a b8 train step, in bf16): each epilogue; a group that fills 16-byte
# chunks (Cg 16) and one that divides a chunk (Cg 1); both routes at shapes
# of the train step (res5 and the relation head's 7x7 RoI maps, onepass;
# a support's 8x8x1024 map and a query's stem and layer1 maps, split, at
# fewer instances); frozen weights, a frozen input; a call recomputed by
# torch.utils.checkpoint.
T3 = (True, True, True)
TRAIN_CASES = [
    ("none", 2, 64, 6, 6, False, False, T3, "f64", False, None),
    ("relu", 2, 64, 6, 6, False, True, T3, "f64", False, None),
    ("residual", 2, 64, 6, 6, True, False, T3, "f64", False, None),
    ("residual-relu", 2, 64, 6, 6, True, True, T3, "f64", False, None),
    ("group-fills-chunk", 2, 512, 5, 5, True, True, T3, "f64", False, None),
    ("group-divides-chunk", 3, 32, 9, 9, False, True, T3, "f64", False,
     None),
    ("res5-1024", 6, 1024, 7, 7, True, True, T3, "f64", False,
     ("onepass", 1024)),
    ("rel_gn", 6, 1024, 7, 7, False, True, T3, "f64", False,
     ("onepass", 3072)),
    ("layer3-s-out", 3, 1024, 8, 8, True, True, T3, "f64", False,
     ("split", 72)),
    ("stem-q", 1, 32, 240, 240, False, True, T3, "f64", False, ("split", 8)),
    ("layer1-q", 1, 256, 120, 120, True, True, T3, "f64", False,
     ("split", 8)),
    ("frozen-params", 2, 64, 6, 6, True, True, (True, False, True), "f64",
     False, None),
    ("frozen-x", 2, 64, 6, 6, True, True, (False, True, True), "f64", False,
     None),
    ("checkpoint", 2, 64, 6, 6, True, True, T3, "f64", True, None),
    ("bf16", 4, 256, 7, 7, True, True, T3, "bf16", False, None),
]


@pytest.mark.parametrize("case", TRAIN_CASES, ids=[c[0] for c in TRAIN_CASES])
def test_train_function_matches_autograd(case):
    """``_GroupNormTrain``'s plain forward equals the composition bit for
    bit, and its plain backward (the kernels' formula) gives autograd's
    gradients through the composition: in f64 to 1e-10 of each gradient's
    scale; in bf16 dx within two bf16 ulp, the residual's exactly, weight's
    and bias's within 1e-5 of their scale (f32 sums in other orders).
    A frozen input is compared with the composition on its NCHW copy:
    torch's CPU GroupNorm backward crashes on a channels_last input that
    wants no gradient."""
    (_, N, C, H, W, with_res, relu, needs, dtype, remat, bwd) = case
    from torch.utils.checkpoint import checkpoint

    dt = torch.float64 if dtype == "f64" else torch.bfloat16
    if bwd is not None:
        route_, n_model = bwd
        assert _plan_bwd(n_model, H * W, C, 32, 2, 132).route == route_
    gen = torch.Generator().manual_seed(C + H + N)
    x = _channels_last(gen, N, C, H, W, dt, scale=3.0, shift=0.5)
    res = _channels_last(gen, N, C, H, W, dt) if with_res else None
    dy = _channels_last(gen, N, C, H, W, dt)
    w = 1 + 0.3 * torch.randn(C, generator=gen)
    b = 0.2 * torch.randn(C, generator=gen)

    def leaves(x, res, w, b):
        x = x.detach().requires_grad_(needs[0])
        w = w.detach().requires_grad_(needs[1])
        b = b.detach().requires_grad_(needs[1])
        if res is not None:
            res = res.detach().requires_grad_(needs[2])
        return x, res, w, b

    def run(fn, x, res, w, b):
        args = (x, 32, w, b, 1e-5, dt, res, relu)
        out = (checkpoint(fn, *args, use_reentrant=False) if remat
               else fn(*args))
        grads = torch.autograd.grad(
            out, [t for t in (x, w, b, res) if t is not None
                  and t.requires_grad], dy)
        return out, grads

    before = counts().get("gn.train", 0)
    got_out, got = run(group_norm, *leaves(x, res, w, b))
    assert counts().get("gn.train", 0) - before == (2 if remat else 1)
    _, want = run(group_norm_plain,
                  *leaves(x if needs[0] else x.contiguous(), res, w, b))
    with torch.no_grad():
        assert torch.equal(got_out, group_norm_plain(x, 32, w, b, 1e-5, dt,
                                                     res, relu))
    assert len(got) == len(want)
    for g, r in zip(got, want):
        assert g.dtype == r.dtype and g.shape == r.shape
        if dt == torch.float64:
            scale = float(r.abs().max())
            assert float((g - r).abs().max()) <= 1e-10 * scale
        elif g.dtype == torch.float32:  # weight's, bias's
            scale = float(r.abs().max())
            assert float((g - r).abs().max()) <= 1e-5 * scale
        elif with_res and g is got[-1]:  # the residual's
            assert torch.equal(g, r)
        else:  # x's, in bf16
            gf, rf = g.float(), r.float()
            tol = 2.0 ** -7 * (gf.abs() + rf.abs()) + 1e-5 * float(
                rf.abs().max())
            assert bool(((gf - rf).abs() <= tol).all())


def test_train_route_raises_off_the_kernels_reach():
    """A call autograd records on a device that is neither the CPU nor CUDA
    (a meta tensor) goes to the kernel's checks and raises: nothing falls
    back to the composition."""
    gn = GroupNorm(32, 64, 1e-5, dtype=torch.float32).to("meta")
    x = torch.empty((2, 64, 6, 6), device="meta").requires_grad_()
    with pytest.raises(ValueError, match="unsupported device"):
        gn(x, relu=True)


# The backward route of each MODEL_SHAPES entry (bf16) at its N.
BWD_ROUTES = {
    "stem-q": "split", "stem3-q": "split", "layer1-q": "split",
    "layer2-q": "split", "layer3-q": "split", "stem-s": "split",
    "layer1-s": "split", "layer2-s": "onepass", "layer3-s": "onepass",
    "layer3-s-out": "split", "res5-512": "onepass", "res5-1024": "onepass",
    "rel_gn": "onepass", "res5-1024-b1": "onepass",
}


@pytest.mark.parametrize("name,N,HW,C", [(s[0], *s[1:4])
                                         for s in MODEL_SHAPES],
                         ids=[s[0] for s in MODEL_SHAPES])
def test_plan_bwd_at_the_model_shapes(name, N, HW, C):
    """onepass: x and dz of an instance and the scratch fit two blocks of
    256 threads on an SM (a grid of two blocks an SM) or one of 512 (one an
    SM), no more blocks than instances; split: tiles of equal rows that
    cover each instance once, about _BWD_TILES_PER_SM an SM."""
    plan = _plan_bwd(N, HW, C, 32, 2, 132)
    assert plan.route == BWD_ROUTES[name]
    assert C * 2 // 16 <= plan.threads
    if plan.route == "onepass":
        room, per_sm = {256: (_SMEM_TWO_BLOCKS, 2),
                        512: (_SMEM_MAX, 1)}[plan.threads]
        assert plan.smem == _bwd_smem(HW, C, 32, 2, plan.threads) <= room
        assert plan.grid == min(N, per_sm * 132)
        return
    assert plan.threads == 256
    assert plan.grid == -(-HW // plan.tile_rows)
    assert (plan.grid - 1) * plan.tile_rows < HW <= plan.grid * plan.tile_rows
    assert plan.grid <= max(1, -(-_BWD_TILES_PER_SM * 132 // N))
