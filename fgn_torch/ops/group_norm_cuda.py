"""GroupNorm with its epilogue (K3): hand-written CUDA kernel + plain version.

``group_norm(x, num_groups, weight, bias, eps, dtype, residual, relu)``
computes ``act(cast(GN_f32(x) * weight + bias) [+ residual])`` on an NCHW
``x``: the statistics and the affine in f32 (f64 for an f64 input), as
flax's ``nn.GroupNorm`` does, one rounding to ``dtype``, then the optional
residual add in ``dtype`` and the optional ReLU.

Routes, chosen from what the call shows:

  * a call that autograd records (grad enabled and any of x, weight, bias,
    residual requiring grad) takes the plain version, counted as
    ``gn.autograd``: the kernel has no backward;
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
f32 sums (a few elements one bf16 ulp apart). It never synchronises.
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


def _records_grad(x, weight, bias, residual) -> bool:
    return torch.is_grad_enabled() and (
        x.requires_grad or weight.requires_grad or bias.requires_grad
        or (residual is not None and residual.requires_grad))


def route(x, weight, bias, residual=None) -> str:
    """The route of a call: "autograd" where autograd records it, else
    "plain" for a CPU tensor, else "kernel" (whose own route, "onepass" or
    "split", ``_plan`` picks from the shape)."""
    if _records_grad(x, weight, bias, residual):
        return "autograd"
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


@functools.lru_cache(maxsize=16)
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def group_norm(x, num_groups: int, weight, bias, eps: float, dtype,
               residual=None, relu: bool = False):
    """``act(cast(GN_f32(x) * weight + bias) [+ residual])``: x (N, C, H, W);
    weight, bias (C,); residual like x or None. See the module's docstring
    for the routes."""
    r = route(x, weight, bias, residual)
    if r == "kernel":
        return _launch(x, num_groups, weight, bias, eps, dtype, residual,
                       relu)
    if r == "autograd":
        count("gn.autograd")
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


def _launch(x, G, weight, bias, eps, dtype, residual, relu, plan=None):
    """The kernel on checked arguments, on ``_plan``'s route (or ``plan``)."""
    _check(x, G, weight, bias, dtype, residual)
    N, C, H, W = x.shape
    out = torch.empty_like(x)  # x's strides: channels_last
    if out.numel() == 0:
        return out
    if plan is None:
        dev = x.device.index
        if dev is None:
            dev = torch.cuda.current_device()
        plan = _plan(N, H * W, C, G, x.element_size(), _sm_count(dev))
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
        None if part is None else part.data_ptr(), N, H * W, C, G,
        float(eps), int(bool(relu)), _DTYPES[x.dtype], plan.threads,
        plan.tile_rows, plan.apply_rows,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, "fgn_group_norm_error_string", rc, "group_norm kernel")
    count("gn." + plan.route)
    return out
