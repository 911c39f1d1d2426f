"""The ViT's attention with decomposed relative positions (K4): hand-written
CUDA kernel + plain version.

``vit_attention(q, k, v, rh, rw)`` computes, for q, k, v (B, heads, T, d)
over an h × w grid of T tokens and the gathered tables rh (h, h, d), rw
(w, w, d),

    softmax(q·kᵀ/√d + q·Rh[row(q), row(k)] + q·Rw[col(q), col(k)])·v

with q unscaled in the two bias terms (detectron2's
``add_decomposed_rel_pos``) → (B, heads, T, d) in q's dtype.

Routes, chosen from what the call shows:

  * a CPU tensor takes the plain version: the bias built in memory by
    ``rel_bias`` (or the builder the caller passes), counted as
    ``vit.bias_bytes``, then an explicit softmax in f32;
  * a CUDA tensor launches ``csrc/vit_attention.cu`` or raises: bf16, d = 64,
    q, k, v with contiguous rows at 16-byte aligned strides (the qkv
    projection's permuted view is taken as it is), the tables contiguous;
    the output is a (B, heads, T, d) view of a (B, T, heads, d) buffer.
    Each launch counts ``k4.launches``; nothing counts ``vit.bias_bytes``,
    since no bias exists in memory. A call that autograd would record
    (grad enabled and an input requiring grad) raises: the kernel has no
    backward.

The plain version is the composition the model ran before the kernel, with
its softmax written out in f32 in place of the library's attention. The
kernel differs from it in precision only where the plain version rounds:
its bias terms are f32 (the plain version's bias is in q's dtype), and its
softmax weights meet v in bf16 (the plain version's in f32).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from fgn_torch.ops import _build
from fgn_torch.utils.profiling import count

HEAD_DIM = 64
BLOCK_M = 128  # query slots a block (csrc/vit_attention.cu: kBM)
BLOCK_N = 64  # keys a tile (kBN)
_STAGES = 3  # K/V tiles in shared memory (kStages)
_STAGE_BYTES = 2 * BLOCK_N * HEAD_DIM * 2  # one K and one V tile in bf16
PATCH_ROWS, PATCH_COLS = 16, 8  # a block's query patch (kPatchRows, kPatchCols)
_SMEM_MAX = 232_448


class Plan(NamedTuple):
    """How one call runs: the blocks' query patches of PATCH_ROWS ×
    PATCH_COLS grid cells down and across the grid, a key tile's grid
    columns ``kc`` (and BLOCK_N / kc rows), the key tiles, and the block's
    shared memory."""

    patches_h: int
    patches_w: int
    kc: int
    key_tiles: int
    smem: int


@functools.lru_cache(maxsize=256)
def plan(h: int, w: int) -> Plan:
    """The tiling of an h × w grid (``csrc/vit_attention.cu``): query
    patches of 16 × 8 cells; key tiles of the least of 8, 16, 32, 64
    columns not below w (64 past it); shared memory for the K/V stages and
    the f32 bias terms of the block's queries, rows padded as the kernel
    pads them."""
    if h < 1 or w < 1:
        raise ValueError(f"vit_attention: an empty grid {h}x{w}")
    kc = next((c for c in (8, 16, 32) if c >= w), 64)
    kr = BLOCK_N // kc
    hs = -(-h // kr) * kr | 1
    ws = -(-w // kc) * kc
    ws += 8 if ws % 32 == 16 else 0
    smem = _STAGES * _STAGE_BYTES + BLOCK_M * (hs + ws) * 4
    if smem > _SMEM_MAX:
        raise ValueError(f"vit_attention: a {h}x{w} grid's bias terms need "
                         f"{smem} bytes of shared memory, over {_SMEM_MAX}")
    return Plan(-(-h // PATCH_ROWS), -(-w // PATCH_COLS), kc,
                -(-h // kr) * -(-w // kc), smem)


def rel_bias(q, rh, rw):
    """The additive bias (B, heads, T, T): q·Rh[row(q), row(k)] +
    q·Rw[col(q), col(k)], q unscaled, in q's dtype; ``rh`` (h, h, d), ``rw``
    (w, w, d)."""
    B, nh, T, d = q.shape
    h, w = rh.shape[0], rw.shape[0]
    r_q = q.reshape(B, nh, h, w, d)
    rel_h = torch.einsum("bnhwc,hkc->bnhwk", r_q, rh)
    rel_w = torch.einsum("bnhwc,wkc->bnhwk", r_q, rw)
    return (rel_h[..., :, None] + rel_w[..., None, :]).reshape(B, nh, T, T)


def attention_plain(q, k, v, bias):
    """softmax(q·kᵀ/√d + bias)·v with the scores, the softmax and the sums in
    f32 (f64 for f64), → q's dtype."""
    dt = torch.promote_types(q.dtype, torch.float32)
    s = torch.matmul(q.to(dt), k.to(dt).transpose(-2, -1)) * q.shape[-1] ** -0.5
    p = torch.softmax(s + bias.to(dt), dim=-1)
    return torch.matmul(p, v.to(dt)).to(q.dtype)


def vit_attention_plain(q, k, v, rh, rw):
    """The plain version: ``rel_bias`` then ``attention_plain``."""
    return attention_plain(q, k, v, rel_bias(q, rh, rw))


def route(q, k, v, rh, rw) -> str:
    """"plain" for a CPU tensor, else "kernel"; raises where autograd would
    record the call."""
    if q.device.type == "cpu":
        return "plain"
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, rh, rw)):
        raise RuntimeError("vit_attention: the kernel has no backward; call "
                           "it under torch.no_grad() or with inputs that do "
                           "not require grad")
    return "kernel"


def vit_attention(q, k, v, rh, rw, bias_fn=rel_bias):
    """The attention of one ViT block (see the module's docstring for the
    routes). ``bias_fn(q, rh, rw)`` builds the plain route's bias."""
    if route(q, k, v, rh, rw) == "kernel":
        return _launch(q, k, v, rh, rw)
    bias = bias_fn(q, rh, rw)
    count("vit.bias_bytes", bias.numel() * bias.element_size())
    return attention_plain(q, k, v, bias)


@functools.lru_cache(maxsize=256)
def _check_layout(q_shape, k_shape, v_shape, strides, rh_shape, rw_shape,
                  dtypes, tables_contiguous) -> Plan:
    """What of a call's shapes, dtypes and strides the kernel cannot take
    raises; → the plan. Cached by those, so that a repeated call only pays
    for the device and the alignment."""
    if len(q_shape) != 4 or k_shape != q_shape or v_shape != q_shape:
        raise ValueError(f"vit_attention: want q, k, v (B, heads, T, d) of one "
                         f"shape, got {tuple(q_shape)}, {tuple(k_shape)}, "
                         f"{tuple(v_shape)}")
    B, nh, T, d = q_shape
    if d != HEAD_DIM:
        raise ValueError(f"vit_attention: the kernel takes heads of "
                         f"{HEAD_DIM}, got {d}")
    h, w = rh_shape[0], rw_shape[0]
    if rh_shape != (h, h, d) or rw_shape != (w, w, d) or h * w != T:
        raise ValueError(f"vit_attention: want rh (h, h, {d}), rw (w, w, {d}) "
                         f"with h·w = T = {T}, got {tuple(rh_shape)}, "
                         f"{tuple(rw_shape)}")
    if B > 65535 or nh > 65535:
        raise ValueError(f"vit_attention: B={B}, heads={nh} over 65535")
    if any(dt != torch.bfloat16 for dt in dtypes):
        raise TypeError("vit_attention: the kernel takes bf16 q, k, v and "
                        "tables, got " + ", ".join(map(str, dtypes)))
    p = plan(h, w)  # raises where the bias terms do not fit
    for name, st in zip("qkv", strides):
        if st[-1] != 1 or any(s % 8 for s in st[:3]):
            raise ValueError(f"vit_attention: {name}'s rows must be "
                             f"contiguous at strides of 16 bytes, got "
                             f"strides {st}")
    if not tables_contiguous:
        raise ValueError("vit_attention: the tables must be contiguous")
    return p


def _check(q, k, v, rh, rw) -> Plan:
    """Raise on what the kernel cannot take: shapes, dtypes and strides
    first, then the device and the alignment. → the plan."""
    ts = (q, k, v, rh, rw)
    p = _check_layout(q.shape, k.shape, v.shape,
                      (q.stride(), k.stride(), v.stride()), rh.shape,
                      rw.shape, tuple(t.dtype for t in ts),
                      rh.is_contiguous() and rw.is_contiguous())
    if q.device.type != "cuda":
        raise ValueError(f"vit_attention: unsupported device {q.device}")
    if any(t.device != q.device for t in ts[1:]):
        raise ValueError("vit_attention: inputs on more than one device")
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError("vit_attention: inputs must be 16-byte aligned")
    return p


def _launch(q, k, v, rh, rw):
    """The kernel on checked arguments → (B, heads, T, d), a view of a
    (B, T, heads, d) buffer."""
    p = _check(q, k, v, rh, rw)
    B, nh, T, d = q.shape
    h, w = rh.shape[0], rw.shape[0]
    out = torch.empty((B, T, nh, d), dtype=q.dtype, device=q.device)
    lib = _build.load("vit_attention")
    rc = lib.fgn_vit_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), rh.data_ptr(),
        rw.data_ptr(), out.data_ptr(), B, nh, h, w,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], p.kc,
        float(d ** -0.5), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "fgn_vit_attention_error_string", rc,
                 "vit_attention kernel")
    count("k4.launches")
    return out.transpose(1, 2)
