"""GroupNorm with its epilogue (K3) and its gradient (K3-bwd): hand-written
CUDA kernels + plain versions.

``group_norm(x, num_groups, weight, bias, eps, dtype, residual, relu)``
computes ``act(cast(GN_f32(x) * weight + bias) [+ residual])`` on an NCHW
``x``: the statistics and the affine in f32 (f64 for an f64 input), as
flax's ``nn.GroupNorm`` does, one rounding to ``dtype``, then the optional
residual add in ``dtype`` and the optional ReLU.

Routes, chosen from what the call shows:

  * a call that autograd records (grad enabled and any of x, weight, bias,
    residual requiring grad), counted as ``gn.train``, runs through
    ``_GroupNormTrain``: on a CUDA tensor the forward kernel, which also
    writes each (instance, group)'s f32 mean and rstd, and in the backward
    ``fgn_group_norm_backward`` (counted ``gn.bwd.onepass`` or
    ``gn.bwd.split``, ``_plan_bwd`` decides), or it raises as the forward
    does on what the kernels cannot take; on a CPU tensor the same Function
    with plain bodies (``group_norm_train_plain``,
    ``group_norm_bwd_plain``). Under ``torch.utils.checkpoint``'s
    non-reentrant recomputation the forward runs twice, and its counters
    count twice;
  * any other call on a CPU tensor takes the plain version, uncounted;
  * any other call on a CUDA tensor launches ``csrc/group_norm.cu`` or
    raises: x channels_last (NHWC in memory), bf16 or f32, in ``dtype``.
    An instance (H·W·C values) that fits in shared memory beside three
    more blocks (256 threads) or one more (512) takes the
    one-block-an-instance kernel, counted as ``gn.onepass``;
    larger maps a statistics kernel over tiles of rows and an apply kernel
    that merges the tiles' partials, counted as ``gn.split``
    (``utils/profiling.py``'s ``count``; ``_plan`` decides).

The plain version is the composition the model ran before the kernel:
``F.group_norm`` on the input cast to f32, a cast to ``dtype``, ``y +
residual``, ``F.relu``. The kernel differs from it only in the order of its
f32 sums (a few elements one bf16 ulp apart). The backward computes the
composition's gradient (``dz`` = dy where the output is not <= 0 with the
ReLU; the residual's gradient ``dz``; dx in f32 rounded once to x's dtype;
weight's and bias's in f32) with its own order of sums, which repeats from
run to run: no float is added atomically. Nothing synchronises.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from fgn_torch.ops import _build
from fgn_torch.utils.profiling import count

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# csrc/group_norm.cu: a block may use up to _SMEM_MAX bytes of shared
# memory; four fit on an SM (228 KB, less 1 KB the card keeps per block) at
# _SMEM_FOUR_BLOCKS or less, two at _SMEM_TWO_BLOCKS. A block has 256
# threads, or 512 where a row has more 16-byte chunks than 256 or a onepass
# instance is too large for four blocks on an SM. A statistics tile of the
# split route holds up to _TILE_BYTES of the map, so that several blocks
# share an SM.
_SMEM_MAX = 232_448
_SMEM_TWO_BLOCKS = 115_712
_SMEM_FOUR_BLOCKS = 56_320
_TILE_BYTES = 48 * 1024
# The split route's apply blocks: this many an SM over the whole call.
_APPLY_BLOCKS_PER_SM = 2
# The backward's split route: about this many tiles (blocks) an SM over the
# call.
_BWD_TILES_PER_SM = 4


class Plan(NamedTuple):
    """How one call runs: the route, the threads a block, the onepass or
    statistics kernel's shared memory, and for "split" the statistics
    tile's rows, the number of tiles an instance and the rows of an apply
    block."""

    route: str  # "onepass" or "split"
    threads: int
    smem: int
    tile_rows: int = 0
    tiles: int = 0
    apply_rows: int = 0


class BwdPlan(NamedTuple):
    """How one backward call runs: the route, the threads a block, the
    onepass kernel's shared memory, its blocks ("onepass") or the tiles an
    instance ("split"), and a tile's rows."""

    route: str  # "onepass" or "split"
    threads: int
    smem: int
    grid: int
    tile_rows: int = 0


def group_norm_plain(x, num_groups: int, weight, bias, eps: float, dtype,
                     residual=None, relu: bool = False):
    """The plain version: F.group_norm in f32 (f64 for f64), cast to
    ``dtype``, ``+ residual``, ReLU."""
    dt = torch.promote_types(x.dtype, torch.float32)
    y = F.group_norm(x.to(dt), num_groups, weight.to(dt), bias.to(dt),
                     eps).to(dtype)
    if residual is not None:
        y = y + residual
    return F.relu(y) if relu else y


def group_norm_train_plain(x, num_groups: int, weight, bias, eps: float,
                           dtype, residual=None, relu: bool = False):
    """``group_norm_plain``'s output and each (instance, group)'s mean and
    rstd, stacked (N, G, 2) in f32 (f64 for f64)."""
    dt = torch.promote_types(x.dtype, torch.float32)
    var, mean = torch.var_mean(x.to(dt).reshape(x.shape[0], num_groups, -1),
                               -1, unbiased=False)
    return (group_norm_plain(x, num_groups, weight, bias, eps, dtype,
                             residual, relu),
            torch.stack((mean, (var + eps).rsqrt()), -1))


def group_norm_bwd_plain(x, out, dy, stats, weight, num_groups: int,
                         relu: bool, residual_dtype=None,
                         needs=(True, True, True, True)):
    """The gradient of ``group_norm_train_plain``'s call: x, its output
    ``out`` (read only with ``relu``), the output's gradient ``dy``, its
    ``stats``; ``needs`` says which of (dx, dweight, dbias, dresidual) to
    form, ``residual_dtype`` the residual's dtype. → those four, None where
    not wanted. The kernels' formula in plain torch, in f32 (f64 for f64):
    ``dz`` = dy where out is not <= 0 (with the ReLU), x̂ = (x − mean)·rstd,
    dx = rstd·(w·dz − mean(w·dz) − x̂·mean(w·dz·x̂)), the means over a
    group; dweight = Σ dz·x̂, dbias = Σ dz; dresidual = dz."""
    dt = torch.promote_types(x.dtype, torch.float32)
    N, C = x.shape[:2]
    G = num_groups
    dz = torch.where(out <= 0, torch.zeros((), dtype=dy.dtype), dy) \
        if relu else dy
    z = dz.to(dt).reshape(N, G, C // G, -1)
    mean, rstd = (s.to(dt)[:, :, None, None] for s in stats.unbind(-1))
    xh = (x.to(dt).reshape(N, G, C // G, -1) - mean) * rstd
    dx = dw = db = dres = None
    if needs[0]:
        wz = z * weight.to(dt).reshape(1, G, C // G, 1)
        dx = rstd * (wz - wz.mean((2, 3), keepdim=True)
                     - xh * (wz * xh).mean((2, 3), keepdim=True))
        dx = dx.reshape(x.shape).to(x.dtype)
    if needs[1]:
        dw = (z * xh).sum((0, 3)).reshape(C).to(weight.dtype)
    if needs[2]:
        db = z.sum((0, 3)).reshape(C).to(weight.dtype)
    if needs[3]:
        dres = dz.to(residual_dtype)
    return dx, dw, db, dres


def _records_grad(x, weight, bias, residual) -> bool:
    return torch.is_grad_enabled() and (
        x.requires_grad or weight.requires_grad or bias.requires_grad
        or (residual is not None and residual.requires_grad))


def route(x, weight, bias, residual=None) -> str:
    """The route of a call: "train" where autograd records it, else
    "plain" for a CPU tensor, else "kernel" (whose own route, "onepass" or
    "split", ``_plan`` picks from the shape)."""
    if _records_grad(x, weight, bias, residual):
        return "train"
    return "plain" if x.device.type == "cpu" else "kernel"


def _layout(C: int, G: int, esize: int) -> Optional[str]:
    """Why the kernel cannot take C channels in G groups of ``esize``-byte
    values, or None: a 16-byte chunk must hold whole groups or lie inside
    one, and a row must not have more chunks than a block (512 threads)
    has threads."""
    V = 16 // esize
    if G <= 0 or C % G:
        return f"C={C} is not a multiple of groups={G}"
    Cg = C // G
    if C % V or C // V > 512:
        return f"C={C} must be a multiple of {V} and at most {V * 512}"
    if Cg % V and V % Cg:
        return (f"a group of {Cg} channels neither fills nor divides a "
                f"16-byte chunk of {V}")
    return None


def _stats_smem(C: int, G: int, esize: int, threads: int) -> int:
    """Shared memory of the statistics' scratch (``stats_smem``): a slot a
    (thread, group its chunk touches) and two floats a group."""
    V = 16 // esize
    S = max(1, V // (C // G))
    return threads * S * 4 + 2 * G * 4


@functools.lru_cache(maxsize=1024)
def _plan(N: int, HW: int, C: int, G: int, esize: int, sms: int,
          tile_bytes: int = _TILE_BYTES,
          apply_per_sm: int = _APPLY_BLOCKS_PER_SM,
          split_threads: int = 256) -> Plan:
    """The route of N instances of HW rows of C channels (``esize`` bytes
    each) in G groups, on a card of ``sms`` SMs: "onepass" where an
    instance and the scratch fit four blocks of 256 threads on an SM, or
    two of 512; else "split", blocks of ``split_threads`` (512 where a row
    has more 16-byte chunks), tiles of up to ``tile_bytes`` (at least one
    row), and apply blocks of equal rows, about ``apply_per_sm`` an SM over
    the call and no more than the tiles (each apply block reads all its
    instance's partials). The keywords serve ``chip_smoke.py``'s sweep."""
    row = C * esize
    wide = row // 16 > 256  # more chunks a row than 256 threads
    for threads, room in ((256, _SMEM_FOUR_BLOCKS), (512, _SMEM_TWO_BLOCKS)):
        smem = HW * row + _stats_smem(C, G, esize, threads)
        if smem <= room and not (wide and threads == 256):
            return Plan("onepass", threads, smem)
    threads = 512 if wide else split_threads
    tile_rows = min(HW, max(1, tile_bytes // row))
    tiles = -(-HW // tile_rows)
    per_instance = max(1, min(tiles, -(-apply_per_sm * sms // N)))
    apply_rows = -(-HW // per_instance)
    return Plan("split", threads,
                tile_rows * row + _stats_smem(C, G, esize, threads),
                tile_rows, tiles, apply_rows)


def _bwd_smem(HW: int, C: int, G: int, esize: int, threads: int) -> int:
    """Shared memory of the backward's onepass kernel: x and dz of an
    instance, a slot a (row of a pass, channel), a channel's two sums and a
    group's two means."""
    return 2 * HW * C * esize + threads * (16 // esize) * 4 + 8 * C + 8 * G


@functools.lru_cache(maxsize=1024)
def _plan_bwd(N: int, HW: int, C: int, G: int, esize: int,
              sms: int) -> BwdPlan:
    """The backward's route of N instances of HW rows of C channels
    (``esize`` bytes each) in G groups, on a card of ``sms`` SMs:
    "onepass" where an instance's x and dz and the scratch fit two blocks
    of 256 threads on an SM (a grid of two blocks an SM) or one of 512 (one
    an SM); else "split", blocks of 256 threads (512 where a row has more
    16-byte chunks), about _BWD_TILES_PER_SM tiles an SM over the call,
    tiles of equal rows."""
    row = C * esize
    wide = row // 16 > 256  # more chunks a row than 256 threads
    for threads, per_sm, room in ((256, 2, _SMEM_TWO_BLOCKS),
                                  (512, 1, _SMEM_MAX)):
        smem = _bwd_smem(HW, C, G, esize, threads)
        if smem <= room and not (wide and threads == 256):
            return BwdPlan("onepass", threads, smem, min(N, per_sm * sms))
    threads = 512 if wide else 256
    tiles = max(1, min(HW, -(-_BWD_TILES_PER_SM * sms // N)))
    tile_rows = -(-HW // tiles)
    return BwdPlan("split", threads, 0, -(-HW // tile_rows), tile_rows)


@functools.lru_cache(maxsize=16)
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _sms(x) -> int:
    dev = x.device.index
    return _sm_count(torch.cuda.current_device() if dev is None else dev)


class _GroupNormTrain(torch.autograd.Function):
    """GroupNorm with its epilogue, differentiable: the kernels on a CUDA
    tensor, the plain bodies on a CPU one. Saves x, the mean and rstd, the
    weight and, with the ReLU, the output (its mask is ``out > 0``)."""

    @staticmethod
    def forward(ctx, x, weight, bias, residual, num_groups, eps, dtype, relu):
        if x.device.type == "cpu":
            out, stats = group_norm_train_plain(
                x, num_groups, weight, bias, eps, dtype, residual, relu)
        else:
            stats = torch.empty((x.shape[0], num_groups, 2),
                                dtype=torch.float32, device=x.device)
            out = _launch(x, num_groups, weight, bias, eps, dtype, residual,
                          relu, stats=stats)
        ctx.save_for_backward(x, weight, stats, out if relu else None)
        ctx.num_groups, ctx.relu = num_groups, relu
        ctx.residual_dtype = None if residual is None else residual.dtype
        return out

    @staticmethod
    def backward(ctx, dy):
        x, weight, stats, out = ctx.saved_tensors
        needs = tuple(ctx.needs_input_grad[:4])
        if x.device.type == "cpu":
            grads = group_norm_bwd_plain(x, out, dy, stats, weight,
                                         ctx.num_groups, ctx.relu,
                                         ctx.residual_dtype, needs)
        else:
            grads = _launch_bwd(x, out, dy, stats, weight, ctx.num_groups,
                                needs)
        return (*grads, None, None, None, None)


def group_norm(x, num_groups: int, weight, bias, eps: float, dtype,
               residual=None, relu: bool = False):
    """``act(cast(GN_f32(x) * weight + bias) [+ residual])``: x (N, C, H, W);
    weight, bias (C,); residual like x or None. See the module's docstring
    for the routes."""
    r = route(x, weight, bias, residual)
    if r == "train":
        count("gn.train")
        return _GroupNormTrain.apply(x, weight, bias, residual, num_groups,
                                     eps, dtype, bool(relu))
    if r == "kernel":
        return _launch(x, num_groups, weight, bias, eps, dtype, residual,
                       relu)
    return group_norm_plain(x, num_groups, weight, bias, eps, dtype,
                            residual, relu)


def _check(x, G, weight, bias, dtype, residual):
    if x.device.type != "cuda":
        raise ValueError(f"group_norm: unsupported device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"group_norm: want x (N,C,H,W), got {tuple(x.shape)}")
    if x.dtype not in _DTYPES or dtype != x.dtype:
        raise TypeError(f"group_norm: the kernel takes a bf16 or f32 x in "
                        f"the output's dtype, got {x.dtype} -> {dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("group_norm: x must be channels_last (NHWC in "
                         "memory)")
    C = x.shape[1]
    for name, p in (("weight", weight), ("bias", bias)):
        if (p.dtype != torch.float32 or p.shape != (C,)
                or not p.is_contiguous() or p.device != x.device):
            raise ValueError(f"group_norm: {name} must be ({C},) float32, "
                             f"contiguous, on {x.device}")
    if residual is not None and (
            residual.shape != x.shape or residual.dtype != x.dtype
            or residual.device != x.device
            or not residual.is_contiguous(memory_format=torch.channels_last)
            or residual.data_ptr() % 16):
        raise ValueError("group_norm: residual must be like x: shape, dtype, "
                         "device, channels_last, 16-byte aligned")
    why = _layout(C, G, x.element_size())
    if why is not None:
        raise ValueError(f"group_norm: {why}")
    if x.data_ptr() % 16:
        raise ValueError("group_norm: x must be 16-byte aligned")


def _launch(x, G, weight, bias, eps, dtype, residual, relu, plan=None,
            stats=None):
    """The kernel on checked arguments, on ``_plan``'s route (or ``plan``);
    with ``stats``, an (N, G, 2) f32 tensor, the training instantiation,
    which also writes there each (instance, group)'s mean and rstd."""
    _check(x, G, weight, bias, dtype, residual)
    N, C, H, W = x.shape
    out = torch.empty_like(x)  # x's strides: channels_last
    if out.numel() == 0:
        return out
    if plan is None:
        plan = _plan(N, H * W, C, G, x.element_size(), _sms(x))
    part = None
    if plan.route == "split":
        if N > 65535:
            raise ValueError(f"group_norm: N={N} instances too many for the "
                             f"split route")
        part = torch.empty((N, G, plan.tiles, 2), dtype=torch.float32,
                           device=x.device)
    lib = _build.load("group_norm")
    rc = lib.fgn_group_norm(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        None if residual is None else residual.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(),
        None if stats is None else stats.data_ptr(), N, H * W, C, G,
        float(eps), int(bool(relu)), _DTYPES[x.dtype], plan.threads,
        plan.tile_rows, plan.apply_rows,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, "fgn_group_norm_error_string", rc, "group_norm kernel")
    count("gn." + plan.route)
    return out


def _launch_bwd(x, out, dy, stats, weight, G, needs):
    """The backward kernels on the forward's checked tensors (``out`` None
    without the ReLU) and ``dy`` (made channels_last and 16-byte aligned
    where it is not), on ``_plan_bwd``'s route. ``needs``: (dx, dweight,
    dbias, dresidual) wanted. → those four, None where not wanted."""
    N, C, H, W = x.shape
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"group_norm backward: want dy like x "
                         f"{tuple(x.shape)} {x.dtype}, got "
                         f"{tuple(dy.shape)} {dy.dtype}")
    dy = dy.contiguous(memory_format=torch.channels_last)
    if dy.data_ptr() % 16:
        dy = dy.clone()
    want_dx, want_params, want_res = needs[0], needs[1] or needs[2], needs[3]
    dx = torch.empty_like(x) if want_dx else None
    dres = torch.empty_like(x) if want_res else None
    dw = db = None
    if want_params:
        dw = torch.empty(C, dtype=torch.float32, device=x.device)
        db = torch.empty_like(dw)
    if x.numel() == 0:
        return tuple(None if t is None else t.zero_()
                     for t in (dx, dw, db, dres))
    plan = _plan_bwd(N, H * W, C, G, x.element_size(), _sms(x))
    f32 = dict(dtype=torch.float32, device=x.device)
    gsum = part = None
    if plan.route == "onepass":
        rows = torch.empty((plan.grid, C, 2), **f32)
    else:
        if N > 65535:
            raise ValueError(f"group_norm backward: N={N} instances too "
                             f"many for the split route")
        rows = torch.empty((N, C, 2), **f32)
        gsum = torch.empty((N, G, 2), **f32)
        part = torch.empty((N, plan.grid, C, 2), **f32)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _build.load("group_norm")
    rc = lib.fgn_group_norm_backward(
        x.data_ptr(), dy.data_ptr(), ptr(out), weight.data_ptr(),
        stats.data_ptr(), ptr(dx), ptr(dres), ptr(dw), ptr(db),
        rows.data_ptr(), ptr(gsum), ptr(part), N, H * W, C, G,
        _DTYPES[x.dtype], plan.threads, plan.grid, plan.tile_rows,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, "fgn_group_norm_error_string", rc,
                 "group_norm backward kernel")
    count("gn.bwd." + plan.route)
    return (dx, dw if needs[1] else None, db if needs[2] else None, dres)
