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
  * a call that autograd records is routed to the plain composition and
    counted as ``gn.autograd``; a ``no_grad`` call is not (a CPU tensor takes
    the plain version uncounted, any other the kernel);
  * the kernel's routes and sizes (``_plan``) at the model's shapes, and the
    channel layouts it refuses (``_layout``).
"""

import pytest
import torch
import torch.nn.functional as F

from fgn_torch.models.fgn import init_params
from fgn_torch.models.resnet import (
    FrozenAffine, GroupNorm, ResNetC4, SharedRes5, _nchw, _nhwc,
)
from fgn_torch.ops.group_norm_cuda import (
    _APPLY_BLOCKS_PER_SM, _SMEM_FOUR_BLOCKS, _SMEM_MAX, _SMEM_TWO_BLOCKS, _TILE_BYTES, _layout,
    _plan, group_norm, route,
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
    ("params", True, "autograd"),
    ("params", False, "plain"),
    ("x", True, "autograd"),
    ("residual", True, "autograd"),
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
        before = counts().get("gn.autograd", 0)
        out = gn(x, res, relu=True)
        moved = counts().get("gn.autograd", 0) - before
    assert moved == (want == "autograd")
    assert out.requires_grad == (want == "autograd")
    assert not any(counts().get(k, 0) for k in ("gn.onepass", "gn.split"))


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
