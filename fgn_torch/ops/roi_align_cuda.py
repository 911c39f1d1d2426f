"""RoIAlign on backbone features: hand-written CUDA kernels + plain versions.

Counterpart of the JAX package's ``ops/roi_align_pallas.py``, with the
same signature and result. ``roi_align_cuda`` is differentiable with
respect to the map, as the TPU kernel's custom VJP is: it applies
``_RoIAlign``, a ``torch.autograd.Function`` whose forward launches the
forward kernel of ``csrc/roi_align.cu`` and whose backward launches its
backward kernel (``roi_align_backward_cuda``). No gradient flows to the
ROIs. For a CPU tensor the same Function runs the plain versions instead:
``_roi_align_plain`` forward, ``_roi_align_plain_bwd`` backward. They are
the TPU kernel's arithmetic in torch: hat-weight matrices
(``_hat_weights``/``_roi_weights``) and a pair of contractions, f32
accumulation, one rounding to the map's dtype; the backward is the JAX
``f_bwd``'s pair of einsums, chunked over ROIs.

The forward has two kernels. The staged one copies each image's (H, W, Ct)
channel slice into shared memory once and reads every corner from there;
``_channel_tile`` picks Ct and ``_rois_per_block`` the ROI groups. A map
whose slice does not fit at Ct = 8 (or whose data is not 16-byte aligned)
takes the direct kernel, which reads the corners from device memory; its
launches are counted apart, as ``k1.direct`` (``utils/profiling.py``'s
``count``; the staged kernel's as ``k1.staged``).
``_bin_lists`` and ``_roi_align_separable`` repeat the staged kernel's
merged corner lists and order of summation in torch, for the tests.

The backward has two kernels too. The staged one gives each block one
(channel tile, image): it sums the image's (H, W, Ct) slice of the map
gradient in shared memory, each word by one thread in a fixed order, and
writes it once; ``_bwd_channel_tile`` picks Ct, ``_roi_align_bwd_ordered``
repeats its order in torch. A map whose accumulator does not fit at
Ct = 8 (or whose data is not 16-byte aligned) takes the atomics kernel;
its launches are counted apart, as ``k1_bwd.atomic`` (the staged
kernel's as ``k1_bwd.staged``).
"""

from __future__ import annotations

import functools

import torch

from fgn_torch.ops import _build
from fgn_torch.utils.profiling import count

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# The staged forward kernel's shared memory (csrc/roi_align.cu): a block may
# use up to _SMEM_MAX bytes; two blocks fit on an SM (228 KB, less 1 KB the
# card keeps per block) at _SMEM_TWO_BLOCKS or less. A block builds the bin
# lists of _ROI_CHUNK ROIs at a time, beside the channel slice.
_SMEM_MAX = 232_448
_SMEM_TWO_BLOCKS = 115_712
_ROI_CHUNK = 8
_TILES = (128, 64, 32, 16, 8)


def _list_bytes(out_size: int, S: int) -> int:
    """Shared memory of one chunk's bin lists (``staged_list_bytes``)."""
    return _ROI_CHUNK * (2 * out_size * 2 * S * 8 + 2 * out_size * 4)


def _channel_tile(H: int, W: int, C: int, dtype, out_size: int = 7,
                  S: int = 2):
    """Channels per block of the staged forward kernel: the largest power of
    two from 8 to 128 that divides C and keeps the (H, W, Ct) slice and the
    bin lists within ``_SMEM_TWO_BLOCKS``; failing that, the smallest that
    fits within ``_SMEM_MAX``. None when no tile fits: the map then takes
    the direct kernel."""
    esize = torch.finfo(dtype).bits // 8
    need = {ct: H * W * ct * esize + _list_bytes(out_size, S) for ct in _TILES
            if C % ct == 0}
    fits = [ct for ct, n in need.items() if n <= _SMEM_MAX]
    two = [ct for ct in fits if need[ct] <= _SMEM_TWO_BLOCKS]
    return two[0] if two else (fits[-1] if fits else None)


def _bwd_smem(H: int, W: int, ct: int, esize: int, R: int,
              out_size: int = 7) -> int:
    """Shared memory of the staged backward (``bwd_staged_bytes``): the f32
    (H, W, Ct) accumulator; one buffer of a chunk's g slice, two when there
    is more than one chunk; each chunk ROI's (O, H + W) dense weights, its
    H + W bin ranges and its footprint (4 ints)."""
    q = min(_ROI_CHUNK, R)
    nbuf = 2 if R > _ROI_CHUNK else 1
    O = out_size
    return H * W * ct * 4 + q * (nbuf * O * O * ct * esize
                                 + (O + 1) * (H + W) * 4 + 16)


def _bwd_channel_tile(H: int, W: int, C: int, dtype, R: int,
                      out_size: int = 7):
    """Channels per block of the staged backward kernel: the largest power
    of two from 8 to 128 that divides C and keeps the accumulator, the
    staging and the weights within ``_SMEM_MAX``, one block an SM (measured
    on an H100, PERF.md: wider tiles beat more blocks). None when no tile
    fits: the map then takes the atomics kernel."""
    esize = torch.finfo(dtype).bits // 8
    fits = [ct for ct in _TILES if C % ct == 0
            and _bwd_smem(H, W, ct, esize, R, out_size) <= _SMEM_MAX]
    return fits[0] if fits else None


def _bwd_threads(H: int) -> int:
    """Threads a block of the staged backward kernel: a warp for each map
    row (a warp owns rows), up to 32 warps."""
    return 32 * min(32, H)


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _rois_per_block(B: int, tiles: int, R: int, sms: int) -> int:
    """ROIs per block of the staged kernel, a multiple of ``_ROI_CHUNK``:
    the ROIs of an image are split into groups so that the grid (groups ×
    tiles × B blocks) has 16 blocks per SM, keeping two chunks or more per
    block. Many short blocks balance the ROIs' uneven work; each block
    copies its slice, so a block of one chunk costs more than it gains
    (measured on an H100, PERF.md)."""
    chunks = -(-R // _ROI_CHUNK)
    want = -(-16 * sms // (B * tiles))
    return min(chunks, max(2, chunks // want)) * _ROI_CHUNK


def _div(x, d):
    """x / d for a Python number d, rounded as IEEE division on every
    device: a CUDA tensor divided by a Python number is multiplied by its
    reciprocal, which can round differently in the last bit and move a
    sample point off the one the kernels compute."""
    return x / torch.full_like(x, float(d))


def _hat_weights(start, bin_size, size: int, out_size: int, ratio: int):
    """(..., O, size) averaging-bilinear weight matrix for one axis."""
    O, S = out_size, ratio
    dev = start.device
    grid = (
        torch.arange(O, dtype=torch.float32, device=dev)[:, None]
        + _div(torch.arange(S, dtype=torch.float32, device=dev)[None, :] + 0.5, S)
    )  # (O, S)
    pts = start[..., None, None] + bin_size[..., None, None] * grid  # (..., O, S)
    oob = (pts <= -1.0) | (pts >= size)
    ptsc = pts.clamp(0.0, size - 1)
    idx = torch.arange(size, dtype=torch.float32, device=dev)
    w = (1.0 - (ptsc[..., None] - idx).abs()).clamp(min=0.0)
    w = torch.where(oob[..., None], torch.zeros((), device=dev), w)
    return w.sum(dim=-2) / float(S)  # (..., O, size)


def _bin_lists(start, bin_size, size: int, out_size: int, ratio: int):
    """The staged kernel's merged corner lists of one axis, in torch:
    (idx, w, n), each bin's (index, weight) pairs in the kernel's order
    (sample by sample, lower corner first), a zero weight dropped, an index
    already listed adding its weight there; (..., O, 2S) long and float32,
    and the (..., O) count of pairs. Σ w over a bin's pairs at idx is
    ``_hat_weights`` × S."""
    O, S = out_size, ratio
    dev = start.device
    grid = (
        torch.arange(O, dtype=torch.float32, device=dev)[:, None]
        + _div(torch.arange(S, dtype=torch.float32, device=dev)[None, :] + 0.5, S)
    )  # (O, S)
    pts = start[..., None, None] + bin_size[..., None, None] * grid  # (..., O, S)
    oob = (pts <= -1.0) | (pts >= size)
    pc = pts.clamp(0.0, size - 1)
    p0 = pc.floor()
    lo = p0.long()
    hi = (lo + 1).clamp(max=size - 1)
    whi = torch.where(oob, torch.zeros((), device=dev), pc - p0)
    wlo = torch.where(oob, torch.zeros((), device=dev), 1.0 - (pc - p0))
    shape = pts.shape[:-1]
    idx = torch.zeros(shape + (2 * S,), dtype=torch.long, device=dev)
    w = torch.zeros(shape + (2 * S,), dtype=torch.float32, device=dev)
    n = torch.zeros(shape, dtype=torch.long, device=dev)
    slots = torch.arange(2 * S, device=dev)
    for s in range(S):
        for cid, cw in ((lo[..., s], wlo[..., s]), (hi[..., s], whi[..., s])):
            keep = cw != 0
            same = (idx == cid[..., None]) & (slots < n[..., None]) & keep[..., None]
            w = w + torch.where(same, cw[..., None], torch.zeros((), device=dev))
            new = keep & ~same.any(-1)
            put = (slots == n[..., None]) & new[..., None]
            idx = torch.where(put, cid[..., None], idx)
            w = torch.where(put, cw[..., None], w)
            n = n + new.long()
    return idx, w, n


def _roi_axes(rois, O, spatial_scale, aligned):
    """Each ROI's (y start, bin height, x start, bin width) on the map."""
    offset = 0.5 if aligned else 0.0
    x1 = rois[..., 0] * spatial_scale - offset
    y1 = rois[..., 1] * spatial_scale - offset
    rw = rois[..., 2] * spatial_scale - offset - x1
    rh = rois[..., 3] * spatial_scale - offset - y1
    if not aligned:
        rw = rw.clamp(min=1.0)
        rh = rh.clamp(min=1.0)
    return y1, _div(rh, O), x1, _div(rw, O)


def _roi_weights(rois, H, W, O, spatial_scale, sampling_ratio, aligned):
    y1, bh, x1, bw = _roi_axes(rois, O, spatial_scale, aligned)
    wy = _hat_weights(y1, bh, H, O, sampling_ratio)
    wx = _hat_weights(x1, bw, W, O, sampling_ratio)
    return wy, wx


def _roi_align_plain(fmap, rois, out_size=7, spatial_scale=1.0,
                     sampling_ratio=2, aligned=True):
    """The forward kernel's plain version: out[b,r,i,j,c] =
    Σ_h Σ_w Wy[b,r,i,h] · f[b,h,w,c] · Wx[b,r,j,w], in f32."""
    B, H, W, C = fmap.shape
    wy, wx = _roi_weights(
        rois.to(torch.float32), H, W, out_size, spatial_scale,
        max(int(sampling_ratio), 1), aligned,
    )  # (B, R, O, H), (B, R, O, W)
    tmp = torch.einsum("brih,bhwc->briwc", wy, fmap.to(torch.float32))
    out = torch.einsum("briwc,brjw->brijc", tmp, wx)
    return out.to(fmap.dtype)


def _roi_align_separable(fmap, rois, out_size=7, spatial_scale=1.0,
                         sampling_ratio=2, aligned=True):
    """The staged forward kernel's arithmetic in torch, for the tests:
    out[i, j] = Σ_e wx[e] · (Σ_a wy[a] · f[y_a, x_e]) / S² over the merged
    lists of ``_bin_lists``, in the kernel's order, f32. Materialises every
    bin's corners: toy sizes only."""
    B, H, W, C = fmap.shape
    O, S = out_size, max(int(sampling_ratio), 1)
    y1, bh, x1, bw = _roi_axes(rois.to(torch.float32), O, spatial_scale,
                               aligned)
    yi, yw, _ = _bin_lists(y1, bh, H, O, S)  # (B, R, O, 2S)
    xi, xw, _ = _bin_lists(x1, bw, W, O, S)
    f = fmap.to(torch.float32).reshape(B, H * W, C)
    R = rois.shape[1]
    acc = torch.zeros((B, R, O, O, C), dtype=torch.float32, device=fmap.device)
    for e in range(2 * S):
        col = torch.zeros_like(acc)
        for a in range(2 * S):
            pos = yi[..., :, None, a] * W + xi[..., None, :, e]  # (B, R, O, O)
            corner = torch.gather(
                f, 1, pos.reshape(B, -1, 1).expand(-1, -1, C)
            ).reshape(B, R, O, O, C)
            col = col + yw[..., :, None, a, None] * corner
        acc = acc + xw[..., None, :, e, None] * col
    return (acc / float(S * S)).to(fmap.dtype)


def _roi_align_plain_bwd(g, rois, H: int, W: int, dtype, out_size=7,
                         spatial_scale=1.0, sampling_ratio=2, aligned=True,
                         roi_chunk: int = 32):
    """The backward kernel's plain version: the map's gradient
    df[b,h,w,c] = Σ_r Σ_i Σ_j Wy[b,r,i,h] · g[b,r,i,j,c] · Wx[b,r,j,w],
    summed in f32 over chunks of ``roi_chunk`` ROIs, cast to ``dtype``."""
    B, R, O, _, C = g.shape
    wy, wx = _roi_weights(
        rois.to(torch.float32), H, W, out_size, spatial_scale,
        max(int(sampling_ratio), 1), aligned,
    )
    df = torch.zeros((B, H, W, C), dtype=torch.float32, device=g.device)
    for lo in range(0, R, roi_chunk):
        sl = slice(lo, lo + roi_chunk)
        gyc = torch.einsum("brih,brijc->brhjc", wy[:, sl],
                           g[:, sl].to(torch.float32))  # (B, RC, H, O, C)
        df += torch.einsum("brhjc,brjw->bhwc", gyc, wx[:, sl])
    return df.to(dtype)


def _roi_align_bwd_ordered(g, rois, H: int, W: int, dtype, out_size=7,
                           spatial_scale=1.0, sampling_ratio=2, aligned=True):
    """The staged backward kernel's arithmetic in torch, for the tests: the
    merged lists of ``_bin_lists`` made dense, and for each ROI in order
    and each bin row i, df[h, w] += wy_i[h] / S² · Σ_j wx_j[w] · g[i, j],
    in increasing i and j, each step one f32 rounding of the exact
    a · b + c (the kernel's fmaf; here through f64, where the product is
    exact). Loops over the ROIs and bins: toy sizes only."""
    B, R, O, _, C = g.shape
    S = max(int(sampling_ratio), 1)
    y1, bh, x1, bw = _roi_axes(rois.to(torch.float32), O, spatial_scale,
                               aligned)
    dense = []
    for start, size_, size in ((y1, bh, H), (x1, bw, W)):
        idx, w, _ = _bin_lists(start, size_, size, O, S)  # (B, R, O, 2S)
        dense.append(torch.zeros(idx.shape[:-1] + (size,), dtype=torch.float32,
                                 device=g.device).scatter_add_(-1, idx, w))
    wy = dense[0] * _div(torch.ones((), device=g.device), S * S)
    wx = dense[1]  # (B, R, O, W)
    g32 = g.to(torch.float32)

    def fma(a, b, c):
        return (a.double() * b.double() + c.double()).float()

    df = torch.zeros((B, H, W, C), dtype=torch.float32, device=g.device)
    for r in range(R):
        for i in range(O):
            col = torch.zeros((B, W, C), dtype=torch.float32, device=g.device)
            for j in range(O):
                col = fma(wx[:, r, j, :, None], g32[:, r, i, j, None, :], col)
            df = fma(wy[:, r, i, :, None, None], col[:, None], df)
    return df.to(dtype)


def _check(fmap, rois, out_size, S, what):
    if fmap.dim() != 4 or rois.dim() != 3 or rois.shape[-1] != 4:
        raise ValueError(
            f"{what}: want fmap (B,H,W,C) and rois (B,R,4), got "
            f"{tuple(fmap.shape)} and {tuple(rois.shape)}"
        )
    if fmap.dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {fmap.dtype} not in f32/bf16")
    if rois.dtype != torch.float32:
        raise TypeError(f"{what}: rois must be float32, got {rois.dtype}")
    if rois.device != fmap.device or rois.shape[0] != fmap.shape[0]:
        raise ValueError(f"{what}: rois must match the map's device and batch")
    if not (fmap.is_contiguous() and rois.is_contiguous()):
        raise ValueError(f"{what}: tensors must be contiguous")
    if fmap.shape[-1] % 2 or fmap.data_ptr() % (2 * fmap.element_size()):
        raise ValueError(f"{what}: C must be even and the data pair-aligned")
    if out_size * S > 64 or rois.shape[1] > 65535 or fmap.shape[0] > 65535:
        raise ValueError(f"{what}: out_size*sampling_ratio <= 64, R and B "
                         f"<= 65535")


def _roi_align_forward(fmap, rois, out_size, spatial_scale, sampling_ratio,
                       aligned):
    """Forward on the map's device: the plain version for a CPU tensor, a
    kernel for a CUDA tensor: the staged kernel where ``_channel_tile``
    finds a tile and the map is 16-byte aligned, else the direct kernel."""
    if fmap.device.type == "cpu":
        return _roi_align_plain(
            fmap, rois, out_size, spatial_scale, sampling_ratio, aligned
        )
    if fmap.device.type != "cuda":
        raise ValueError(f"roi_align_cuda: unsupported device {fmap.device}")
    S = max(int(sampling_ratio), 1)
    _check(fmap, rois, out_size, S, "roi_align_cuda")
    B, H, W, C = fmap.shape
    R = rois.shape[1]
    out = torch.empty((B, R, out_size, out_size, C), dtype=fmap.dtype,
                      device=fmap.device)
    if out.numel() == 0:
        return out
    tile = None
    if fmap.data_ptr() % 16 == 0:
        tile = _channel_tile(H, W, C, fmap.dtype, out_size, S)
    lib = _build.load("roi_align")
    args = (fmap.data_ptr(), rois.data_ptr(), out.data_ptr(), B, H, W, C, R,
            out_size, S, float(spatial_scale), int(bool(aligned)),
            _DTYPES[fmap.dtype])
    stream = torch.cuda.current_stream(fmap.device).cuda_stream
    if tile is None:
        rc = lib.fgn_roi_align_forward(*args, stream)
        _build.check(lib, "fgn_roi_align_error_string", rc,
                     "roi_align direct kernel")
        count("k1.direct")
        return out
    rc = lib.fgn_roi_align_forward_staged(
        *args, tile, _rois_per_block(B, C // tile, R, _sm_count(fmap.device)),
        stream)
    _build.check(lib, "fgn_roi_align_error_string", rc, "roi_align kernel")
    count("k1.staged")
    return out


def _backward_atomic(g, rois, H: int, W: int, out_size: int, S: int,
                     spatial_scale: float, aligned: bool):
    """The atomics backward kernel on checked CUDA arguments: a zeroed f32
    buffer, the scatter, a cast to bf16. Counts nothing."""
    B, R = g.shape[:2]
    C = g.shape[-1]
    acc = torch.zeros((B, H, W, C), dtype=torch.float32, device=g.device)
    df = acc if g.dtype == torch.float32 else torch.empty_like(acc, dtype=g.dtype)
    lib = _build.load("roi_align")
    rc = lib.fgn_roi_align_backward(
        g.data_ptr(), rois.data_ptr(), acc.data_ptr(), df.data_ptr(), B, H, W,
        C, R, out_size, S, float(spatial_scale), int(bool(aligned)),
        _DTYPES[g.dtype], torch.cuda.current_stream(g.device).cuda_stream,
    )
    _build.check(lib, "fgn_roi_align_error_string", rc,
                 "roi_align atomics backward kernel")
    return df


def roi_align_backward_cuda(g, rois, H: int, W: int, out_size: int = 7,
                            spatial_scale: float = 1.0, sampling_ratio: int = 2,
                            aligned: bool = True):
    """The map's gradient: g (B, R, O, O, C), the gradient of the output, →
    (B, H, W, C) in g's dtype (the map's dtype). For a CUDA tensor the
    staged backward kernel where ``_bwd_channel_tile`` finds a tile and g is
    16-byte aligned, else the atomics kernel; the plain version for a CPU
    tensor."""
    if g.device.type == "cpu":
        return _roi_align_plain_bwd(g, rois, H, W, g.dtype, out_size,
                                    spatial_scale, sampling_ratio, aligned)
    if g.device.type != "cuda":
        raise ValueError(f"roi_align_backward_cuda: unsupported device {g.device}")
    S = max(int(sampling_ratio), 1)
    B, R = g.shape[:2]
    C = g.shape[-1]
    if g.shape != (B, R, out_size, out_size, C) or not g.is_contiguous():
        raise ValueError(f"roi_align_backward_cuda: g must be a contiguous "
                         f"(B,R,O,O,C) with O={out_size}, got {tuple(g.shape)}")
    _check(g.reshape(B, R * out_size, out_size, C), rois, out_size, S,
           "roi_align_backward_cuda")
    if B * H * W * C == 0 or g.numel() == 0:
        return torch.zeros((B, H, W, C), dtype=g.dtype, device=g.device)
    tile = None
    if g.data_ptr() % 16 == 0:
        tile = _bwd_channel_tile(H, W, C, g.dtype, R, out_size)
    if tile is None:
        df = _backward_atomic(g, rois, H, W, out_size, S, spatial_scale,
                              aligned)
        count("k1_bwd.atomic")
        return df
    df = torch.empty((B, H, W, C), dtype=g.dtype, device=g.device)
    lib = _build.load("roi_align")
    rc = lib.fgn_roi_align_backward_staged(
        g.data_ptr(), rois.data_ptr(), df.data_ptr(), B, H, W, C, R, out_size,
        S, float(spatial_scale), int(bool(aligned)), _DTYPES[g.dtype], tile,
        _bwd_threads(H), torch.cuda.current_stream(g.device).cuda_stream,
    )
    _build.check(lib, "fgn_roi_align_error_string", rc,
                 "roi_align backward kernel")
    count("k1_bwd.staged")
    return df


class _RoIAlign(torch.autograd.Function):
    """RoIAlign, differentiable with respect to the map (not the ROIs)."""

    @staticmethod
    def forward(ctx, fmap, rois, out_size, spatial_scale, sampling_ratio,
                aligned):
        ctx.save_for_backward(rois)
        ctx.geom = (fmap.shape[1], fmap.shape[2], out_size, spatial_scale,
                    sampling_ratio, aligned)
        return _roi_align_forward(fmap, rois, out_size, spatial_scale,
                                  sampling_ratio, aligned)

    @staticmethod
    def backward(ctx, g):
        (rois,) = ctx.saved_tensors
        df = roi_align_backward_cuda(g.contiguous(), rois, *ctx.geom)
        return df, None, None, None, None, None


def roi_align_cuda(fmap, rois, out_size: int = 7, spatial_scale: float = 1.0,
                   sampling_ratio: int = 2, aligned: bool = True):
    """(B, H, W, C) map, (B, R, 4) XYXY f32 rois → (B, R, O, O, C) in the
    map's dtype (f32 or bf16). Differentiable with respect to the map."""
    return _RoIAlign.apply(fmap, rois, out_size, spatial_scale,
                           sampling_ratio, aligned)
