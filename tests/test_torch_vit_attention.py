"""The ViT's attention with decomposed relative positions (K4,
``fgn_torch/ops/vit_attention_cuda.py``) on the CPU: its plain version
against the composition it replaced (``rel_bias`` and PyTorch's SDPA) and
against detectron2's ``add_decomposed_rel_pos`` (``benchmark/reference/
vitdet.py``), the wrapper's routes and refusals (a meta tensor stands for a
card's), the counters of the CPU route, and the tile planner that
``csrc/vit_attention.cu`` runs by, at every geometry of the ViT cell. The
kernel itself runs only on the card (``chip_smoke.py``'s ``vit_attention``
phase holds it to the plain version there).
"""

from __future__ import annotations

import re
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from benchmark.reference import vitdet
from fgn_torch.models.vit import rel_table, window_partition
from fgn_torch.ops import vit_attention_cuda as k4
from fgn_torch.utils.profiling import counts

SEED = 2**31 + 20
# shared memory a block may take for two blocks an SM (228 KB, less 1 KB
# the card keeps per block)
SMEM_TWO_BLOCKS = 115_712

# (name, B, heads, h, w, table rows before resizing, window padding): the
# ViT cell's geometries at toy batch, and a non-square grid.
GEOMETRIES = [
    ("support-global", 3, 2, 8, 8, 15, None),  # 127-row tables cut to 15 there
    ("window-padded", 2, 2, 14, 14, 27, (12, 13)),  # a 12x13 map padded to 14x14
    ("global", 1, 2, 32, 32, 63, None),
    ("non-square", 2, 3, 6, 10, 19, None),
]


def _inputs(B, heads, h, w, rows, pad, d=64, dtype=torch.float32):
    """q, k, v (B, heads, T, d) as the qkv projection's permuted view (a
    window zero-padded first where ``pad`` gives the map, so that its padded
    tokens carry the projection's bias alone), and the 1-D tables with their
    gathered forms."""
    g = torch.Generator().manual_seed(SEED)
    C = heads * d
    if pad is None:
        x = torch.randn((B, h, w, C), generator=g)
    else:
        x = window_partition(torch.randn((B, *pad, C), generator=g), h)[0]
    wq = torch.randn((C, 3 * C), generator=g) / C ** 0.5
    bq = torch.randn(3 * C, generator=g)
    qkv = (x.reshape(B, h * w, C) @ wq + bq).to(dtype)
    q, k, v = qkv.reshape(B, h * w, 3, heads, d).permute(2, 0, 3, 1, 4).unbind(0)
    th, tw = (torch.randn((rows, d), generator=g) / 8 for _ in range(2))
    return q, k, v, th, tw, rel_table(th, h).to(dtype), rel_table(tw, w).to(dtype)


@pytest.mark.parametrize("name,B,heads,h,w,rows,pad", GEOMETRIES,
                         ids=[g[0] for g in GEOMETRIES])
def test_plain_equals_the_composition_it_replaced(name, B, heads, h, w, rows,
                                                  pad):
    """The plain version (``rel_bias`` and an f32 softmax) against the
    model's earlier attention, SDPA over the same bias, and against
    detectron2's equations on the 1-D tables."""
    q, k, v, th, tw, rh, rw = _inputs(B, heads, h, w, rows, pad)
    got = k4.vit_attention_plain(q, k, v, rh, rw)
    sdpa = F.scaled_dot_product_attention(q, k, v,
                                          attn_mask=k4.rel_bias(q, rh, rw))
    T, d = h * w, q.shape[-1]
    qf, kf, vf = (t.reshape(B * heads, T, d) for t in (q, k, v))
    attn = vitdet.add_decomposed_rel_pos((qf * d ** -0.5) @ kf.transpose(1, 2),
                                         qf, th, tw, (h, w), (h, w))
    d2 = (attn.softmax(-1) @ vf).reshape(B, heads, T, d)
    assert got.shape == (B, heads, T, d) and got.dtype == q.dtype
    assert torch.allclose(got, sdpa, atol=2e-5, rtol=1e-5)
    assert torch.allclose(got, d2, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
def test_cpu_takes_the_plain_version_and_counts_its_bias(grad):
    """On the CPU the wrapper runs the plain version with the bias builder
    it is given, counts the bias it built and launches nothing; autograd
    records it where grad is enabled."""
    q, k, v, _, _, rh, rw = _inputs(2, 2, 6, 10, 19, None)
    built = []

    def bias_fn(*a):
        built.append(k4.rel_bias(*a))
        return built[-1]

    before = counts()
    with torch.set_grad_enabled(grad):
        q.requires_grad_(grad)
        out = k4.vit_attention(q, k, v, rh, rw, bias_fn)
    moved = {n: counts().get(n, 0) - before.get(n, 0)
             for n in ("vit.bias_bytes", "k4.launches")}
    assert moved == {"vit.bias_bytes": 2 * 2 * 60 * 60 * 4, "k4.launches": 0}
    assert len(built) == 1 and out.requires_grad == grad
    assert torch.equal(out.detach(),
                       k4.vit_attention_plain(q.detach(), k, v, rh, rw))


def _meta(B=2, heads=2, h=4, w=4, d=64, dtype=torch.bfloat16):
    qkv = torch.empty((B, h * w, 3, heads, d), dtype=dtype, device="meta")
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    rh = torch.empty((h, h, d), dtype=dtype, device="meta")
    rw = torch.empty((w, w, d), dtype=dtype, device="meta")
    return q, k, v, rh, rw


@pytest.mark.parametrize("needs", ["q", "tables", "none"])
@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
def test_a_card_tensor_takes_the_kernel_or_raises(needs, grad):
    """A meta tensor stands for a card's: without autograd the call goes to
    the kernel (whose checks then refuse the meta device: no fallback);
    where autograd would record it, the wrapper raises, since the kernel has
    no backward."""
    q, k, v, rh, rw = _meta()
    q.requires_grad_(needs == "q")
    rh.requires_grad_(needs == "tables")
    rw.requires_grad_(needs == "tables")
    with torch.set_grad_enabled(grad):
        if grad and needs != "none":
            with pytest.raises(RuntimeError, match="no backward"):
                k4.route(q, k, v, rh, rw)
            return
        assert k4.route(q, k, v, rh, rw) == "kernel"
        before = counts()
        with pytest.raises(ValueError, match="unsupported device meta"):
            k4.vit_attention(q, k, v, rh, rw)
    assert counts() == before


def _bad(kind):
    q, k, v, rh, rw = _meta()
    if kind == "head-size":
        return _meta(d=32)
    if kind == "f32":
        return _meta(dtype=torch.float32)
    if kind == "f32-table":
        return q, k, v, rh.float(), rw
    if kind == "grid":
        return q, k, v, rh, torch.empty((5, 5, 64), dtype=rh.dtype, device="meta")
    if kind == "table-shape":
        return q, k, v, rh[:, :3], rw
    if kind == "kv-shape":
        return q, k[:, :1], v, rh, rw
    if kind == "strided-d":
        big = torch.empty((2, 2, 16, 128), dtype=q.dtype, device="meta")
        return big[..., ::2], k, v, rh, rw
    if kind == "odd-stride":
        big = torch.empty((2, 2, 16, 68), dtype=q.dtype, device="meta")
        return big[..., :64], k, v, rh, rw
    if kind == "table-layout":
        return q, k, v, rh.transpose(0, 1), rw
    if kind == "too-large":
        return _meta(B=1, heads=1, h=400, w=400)
    if kind == "batch":
        return _meta(B=65536, heads=1, h=1, w=1)
    raise AssertionError(kind)


REFUSALS = [("head-size", ValueError, "heads of 64"),
            ("f32", TypeError, "bf16"), ("f32-table", TypeError, "bf16"),
            ("grid", ValueError, "h·w = T"),
            ("table-shape", ValueError, "h·w = T"),
            ("kv-shape", ValueError, "of one shape"),
            ("strided-d", ValueError, "rows must be contiguous"),
            ("odd-stride", ValueError, "rows must be contiguous"),
            ("table-layout", ValueError, "tables must be contiguous"),
            ("too-large", ValueError, "shared memory"),
            ("batch", ValueError, "over 65535")]


@pytest.mark.parametrize("kind,exc,match", REFUSALS,
                         ids=[r[0] for r in REFUSALS])
def test_the_kernel_refuses_what_it_cannot_take(kind, exc, match):
    """The launch path's checks raise before any device work, on shapes,
    dtypes and strides first."""
    with torch.no_grad(), pytest.raises(exc, match=match):
        k4._launch(*_bad(kind))


def _slot_token(h, w, pr0, pc0, s):
    """csrc/vit_attention.cu's slot_token: 16 slots down each column of the
    patch."""
    r, c = pr0 + s % k4.PATCH_ROWS, pc0 + s // k4.PATCH_ROWS
    return r * w + c if r < h and c < w else -1


# (h, w): the ViT cell's grids (global 64x64, windows 14x14, the supports'
# 8x8), an unpadded 768x1024 image, and grids that overhang their tiles
PLAN_GRIDS = [(64, 64), (14, 14), (8, 8), (48, 64), (10, 24), (6, 10),
              (3, 3), (1, 7), (100, 100), (64, 14)]


@pytest.mark.parametrize("h,w", PLAN_GRIDS, ids=[f"{h}x{w}" for h, w in PLAN_GRIDS])
def test_plan_covers_every_query_and_key_once(h, w):
    """Every token is one query slot of one patch and one key of one key
    tile; a block's shared memory fits; key tiles are 64 cells, the least
    power-of-two width from 8 that holds a row (64 past it)."""
    p = k4.plan(h, w)
    assert k4.PATCH_ROWS * k4.PATCH_COLS == k4.BLOCK_M
    queries = [_slot_token(h, w, (i // p.patches_w) * k4.PATCH_ROWS,
                           (i % p.patches_w) * k4.PATCH_COLS, s)
               for i in range(p.patches_h * p.patches_w)
               for s in range(k4.BLOCK_M)]
    assert sorted(t for t in queries if t >= 0) == list(range(h * w))
    kr = k4.BLOCK_N // p.kc
    assert p.kc in (8, 16, 32, 64) and (p.kc >= w or p.kc == 64)
    assert p.kc == 8 or p.kc // 2 < w
    n_ct = -(-w // p.kc)
    assert p.key_tiles == -(-h // kr) * n_ct
    keys = []
    for jt in range(p.key_tiles):
        gr, gc = (jt // n_ct) * kr, (jt % n_ct) * p.kc
        for kk in range(k4.BLOCK_N):
            r, c = gr + kk // p.kc, gc + kk % p.kc
            if r < h and c < w:
                keys.append(r * w + c)
    assert sorted(keys) == list(range(h * w))
    assert p.smem <= k4._SMEM_MAX


def test_plan_at_the_vit_cell():
    """The cell's calls: the global blocks' key tiles are grid rows, 32
    patches an image and head, two blocks an SM; a 14x14 window takes two
    patches and four key tiles of 4 x 16 cells, a support's 8x8 grid one of
    each."""
    glob, window, support = k4.plan(64, 64), k4.plan(14, 14), k4.plan(8, 8)
    assert glob[:4] == (4, 8, 64, 64)
    assert glob.smem <= SMEM_TWO_BLOCKS
    assert window[:4] == (1, 2, 16, 4)
    assert support[:4] == (1, 1, 8, 1)
    with pytest.raises(ValueError, match="empty grid"):
        k4.plan(0, 4)


def test_the_planner_mirrors_the_kernel_source():
    """The constants the planner sizes shared memory by are the kernel's."""
    src = (Path(k4.__file__).resolve().parent.parent / "csrc"
           / "vit_attention.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kD") == k4.HEAD_DIM
    assert const("kBM") == k4.BLOCK_M
    assert const("kBN") == k4.BLOCK_N
    assert const("kStages") == k4._STAGES
    assert const("kSmemMax") == k4._SMEM_MAX
    assert const("kPatchRows") == k4.PATCH_ROWS
