"""FGN — Fully Guided Network for few-shot instance segmentation, in PyTorch.

Port of the JAX package's ``models/fgn.py``, inference path:
``FGN.test_forward(batch) -> detections``, the reference's simple_test to
a fixed number of detections per image. The method split, the output keys
and the numerics follow the JAX module; only ``vmap`` became a batch
dimension. Layout at the methods is NHWC (fmaps (B, h, w, C), ROI features
(B, R, 7, 7, C)); boxes are XYXY.

Two hand-written CUDA kernels carry the path on the card:

  * RoIAlign on backbone features (``ops/roi_align_cuda.py``), three calls
    per forward: support crops, proposals, detections;
  * the greedy-NMS keep mask (``ops/nms_cuda.py``), two calls: RPN
    proposals and per-class detections.

On CPU tensors both wrappers use their plain versions.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from fgn_torch.config import FGNConfig
from fgn_torch.data.batching import EpisodeBatch, mask_to_float, to_device
from fgn_torch.models.resnet import (
    Conv2d, GroupNorm, ResNetC4, SharedRes5, _nchw, _nhwc,
)
from fgn_torch.ops.anchors import generate_anchors
from fgn_torch.ops.boxes import delta_decode
from fgn_torch.ops.nms import batched_nms, nms_padded
from fgn_torch.ops.nms_cuda import greedy_alive_cuda
from fgn_torch.ops.roi_align import roi_align
from fgn_torch.ops.roi_align_cuda import roi_align_cuda

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Linear(nn.Module):
    """flax ``nn.Dense``: weight (out, in) held in f32, cast at use."""

    def __init__(self, cin, cout, dtype=torch.float32):
        super().__init__()
        self.dt = dtype
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return F.linear(x.to(self.dt), self.weight.to(self.dt),
                        self.bias.to(self.dt))


class ConvTranspose2d(nn.Module):
    """flax ``nn.ConvTranspose`` with kernel = stride (no overlap, no
    padding). Weight (in, out, kh, kw); the bridge flips flax's kernel on
    both spatial axes for it."""

    def __init__(self, cin, cout, k, dtype=torch.float32):
        super().__init__()
        self.dt = dtype
        self.weight = nn.Parameter(torch.empty(cin, cout, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):  # NCHW
        k = self.weight.shape[-1]
        return F.conv_transpose2d(x.to(self.dt), self.weight.to(self.dt),
                                  self.bias.to(self.dt), stride=k)


def _conv1x1_nhwc(conv: Conv2d, x):
    """A 1×1 conv on the channel axis of an NHWC tensor of any rank."""
    w = conv.weight[:, :, 0, 0].to(conv.dt)
    b = None if conv.bias is None else conv.bias.to(conv.dt)
    return F.linear(x.to(conv.dt), w, b)


class FGN(nn.Module):
    def __init__(self, cfg: FGNConfig):
        super().__init__()
        self.cfg = c = cfg
        dt = self.dt = _DTYPES[c.compute_dtype]
        A = c.num_anchors
        C = c.feat_channels
        self.backbone = ResNetC4(
            norm=c.backbone_norm, frozen=c.backbone_frozen,
            deep_stem=c.deep_stem, avg_down=c.avg_down, dtype=dt,
        )
        # AG-RPN: one shared conv head over all gated maps.
        self.rpn_conv = Conv2d(1024, C, 3, dtype=dt)
        self.rpn_cls = Conv2d(C, A, 1, dtype=dt)
        self.rpn_reg = Conv2d(C, A * 4, 1, dtype=dt)
        # RoI tower
        self.shared5 = SharedRes5(norm=c.res5_norm, dtype=dt)
        self.rel_conv_roi = Conv2d(1024, 1024, 1, dtype=dt)
        # bias only on the roi half: conv(concat) has a single bias. With
        # guidance off there is no support half (and flax makes no params).
        if c.guidance:
            self.rel_conv_spp = Conv2d(1024, 1024, 1, bias=False, dtype=dt)
        self.rel_gn = GroupNorm(32, 1024, 1e-5, dtype=dt)
        self.fc_cls = Linear(1024, 2, dtype=dt)
        self.fc_reg = Linear(1024, 4, dtype=dt)
        # FCNMaskHead: 4 convs 1024→256, deconv ×2, 1-ch logits
        self.mask_convs_0 = Conv2d(1024, 256, 3, dtype=dt)
        self.mask_convs_1 = Conv2d(256, 256, 3, dtype=dt)
        self.mask_convs_2 = Conv2d(256, 256, 3, dtype=dt)
        self.mask_convs_3 = Conv2d(256, 256, 3, dtype=dt)
        self.mask_deconv = ConvTranspose2d(256, 256, 2, dtype=dt)
        self.mask_logits = Conv2d(256, 1, 1, dtype=dt)

    # -- shared plumbing ----------------------------------------------------

    def _normalize(self, img, batch):
        x = img.to(torch.float32)
        mean = batch.norm_mean.to(torch.float32)
        std = batch.norm_std.to(torch.float32)
        return ((x - mean) / std).to(self.dt)

    def _extract(self, batch):
        """→ qry_fmap (B,h,w,C); spp_fmaps (B,N,K,hs,ws,C) or None."""
        c = self.cfg
        qry = self.backbone(self._normalize(batch.qry_img, batch))
        if not c.guidance:
            return qry, None
        B, NK, S1, S2, _ = batch.spp_imgs.shape
        spp = self.backbone(
            self._normalize(batch.spp_imgs.reshape(B * NK, S1, S2, 3), batch)
        )
        hs, ws, C = spp.shape[1:]
        return qry, spp.reshape(B, c.n_ways, c.k_shots, hs, ws, C)

    def _rpn_forward(self, qry_fmap, spp_fmaps):
        """AG-RPN conv pass → cls (B,N,h,w,A), reg (B,N,h,w,A,4)."""
        c = self.cfg
        B, h, w, C = qry_fmap.shape
        A = c.num_anchors
        if c.guidance:
            vecs = spp_fmaps.mean(dim=(2, 3, 4))  # (B, N, C)
            mod = qry_fmap[:, None] * vecs[:, :, None, None, :]
            n = c.n_ways
        else:
            if c.n_ways != 1:
                raise ValueError("guidance=False is the single-way mode")
            mod = qry_fmap[:, None]
            n = 1
        x = _nchw(mod.reshape(B * n, h, w, C))
        x = F.relu(self.rpn_conv(x))
        cls = _nhwc(self.rpn_cls(x)).reshape(B, n, h, w, A)
        reg = _nhwc(self.rpn_reg(x)).reshape(B, n, h, w, A, 4)
        return cls, reg

    @staticmethod
    def _merge_ways(cls, reg):
        """Per anchor position keep the way with the top objectness (first
        way on ties, as jnp.argmax). cls (B,N,h,w,A) → (B,h,w,A)."""
        merged_cls = cls.max(dim=1).values
        top = cls.argmax(dim=1)  # (B, h, w, A)
        idx = top[:, None, ..., None].expand(-1, 1, -1, -1, -1, 4)
        merged_reg = torch.gather(reg, 1, idx)[:, 0]
        return merged_cls, merged_reg

    def get_proposals(self, cls_score, bbox_pred, img_hw, nms_pre: int,
                      max_per_img: int):
        """Merged RPN maps → padded proposals.

        cls_score (B,h,w,A) logits, bbox_pred (B,h,w,A,4), img_hw (B,2).
        Returns (boxes (B,M,4) XYXY, scores (B,M), valid (B,M)). Degenerate
        decoded boxes (zero width or height) are dropped before NMS."""
        c = self.cfg
        B, h, w, A = cls_score.shape
        anchors = generate_anchors(
            h, w, c.stride, c.anchor_scales, c.anchor_ratios,
            device=cls_score.device,
        )  # (h*w*A, 4) — location-major, matching the conv layout
        M = anchors.shape[0]
        scores_all = torch.sigmoid(cls_score.reshape(B, M).to(torch.float32))
        deltas_all = bbox_pred.reshape(B, M, 4).to(torch.float32)
        k = min(nms_pre, M)
        top_s, idx = torch.sort(scores_all, dim=1, descending=True, stable=True)
        top_s, idx = top_s[:, :k], idx[:, :k]
        hw = img_hw.to(cls_score.device)
        boxes = delta_decode(
            anchors[idx],
            torch.gather(deltas_all, 1, idx[..., None].expand(-1, -1, 4)),
            max_shape=(hw[:, 0:1], hw[:, 1:2]),
        )
        ws = boxes[..., 2] - boxes[..., 0]
        hs = boxes[..., 3] - boxes[..., 1]
        valid = (ws > c.rpn_min_bbox_size) & (hs > c.rpn_min_bbox_size)
        out_boxes, out_scores, _, out_valid = nms_padded(
            boxes, top_s, valid, c.rpn_nms_iou, max_per_img,
            alive_fn=greedy_alive_cuda,
        )
        return out_boxes, out_scores, out_valid

    # -- support pooling ------------------------------------------------------

    def _count_spp(self, spp_fmaps, spp_boxes, spp_masks):
        """Support maps + mask-pooled vectors.

        spp_fmaps (B,N,K,hs,ws,C); spp_boxes (B,NK,4) XYXY in crop px;
        spp_masks (B,NK,S,S). → (spp_maps (B,N,7,7,C), spp_vecs_mask (B,N,C))."""
        c = self.cfg
        B, N, K, hs, ws, C = spp_fmaps.shape
        NK = N * K
        S = spp_masks.shape[-1]
        rois = spp_boxes.reshape(B * NK, 1, 4).to(torch.float32).contiguous()
        masks_aligned = roi_align(
            mask_to_float(spp_masks).reshape(B * NK, S, S, 1),
            rois, 7, spatial_scale=1.0,
        )  # (B*NK, 1, 7, 7, 1) — C=1: the gather form on every device
        fmaps_aligned = self._roi_align_fmap(
            spp_fmaps.reshape(B * NK, hs, ws, C), rois, 1.0 / c.stride
        )  # (B*NK, 1, 7, 7, C)
        feats = self.shared5(fmaps_aligned.reshape(B * NK, 7, 7, C))
        feats = feats.reshape(B, N, K, 7, 7, C)
        spp_maps = feats.mean(dim=2)  # (B, N, 7, 7, C)
        weighted = feats * masks_aligned.reshape(B, N, K, 7, 7, 1).to(feats.dtype)
        spp_vecs_mask = weighted.mean(dim=(2, 3, 4))  # (B, N, C)
        return spp_maps, spp_vecs_mask

    def _roi_align_fmap(self, fmap, rois, scale):
        """RoIAlign on backbone features: the CUDA kernel (plain version on
        CPU) when C % 128 == 0, as the JAX module routes to its TPU kernel;
        else the gather form."""
        if fmap.shape[-1] % 128 == 0:
            return roi_align_cuda(fmap.contiguous(), rois, 7,
                                  spatial_scale=scale)
        return roi_align(fmap, rois, 7, spatial_scale=scale)

    def _bbox_feats(self, qry_fmap, rois):
        """(B,R,4) rois → (B,R,7,7,C) shared-res5 features."""
        B, R = rois.shape[:2]
        C = qry_fmap.shape[-1]
        feats = self._roi_align_fmap(
            qry_fmap, rois.to(torch.float32).contiguous(), 1.0 / self.cfg.stride
        )  # (B, R, 7, 7, C)
        feats = self.shared5(feats.reshape(B * R, 7, 7, C))
        return feats.reshape(B, R, 7, 7, C)

    def _relation_impl(self, bbox_feats, spp_maps):
        """Relation head → (cls_final (B,R,N+1), reg (B,R,N,4)).

        concat→1×1 conv is written as two 1×1 convs whose outputs add; GN
        normalizes each (ROI, way) instance over (7, 7, channels/32)."""
        c = self.cfg
        B, R = bbox_feats.shape[:2]
        N = c.n_ways
        r_roi = _conv1x1_nhwc(self.rel_conv_roi, bbox_feats)  # (B,R,7,7,1024)
        if c.guidance:
            r_spp = _conv1x1_nhwc(self.rel_conv_spp, spp_maps)  # (B,N,7,7,1024)
            x = r_roi[:, :, None] + r_spp[:, None]  # (B, R, N, 7, 7, 1024)
        else:
            x = r_roi[:, :, None]
        x = self.rel_gn(_nchw(x.reshape(B * R * N, 7, 7, 1024)))
        x = F.relu(x)
        pooled = x.mean(dim=(2, 3)).reshape(B, R, N, 1024)
        cls = self.fc_cls(pooled)  # (B, R, N, 2) = (bg, fg) per way
        reg = self.fc_reg(pooled)  # (B, R, N, 4)
        # fg-argmax merge: (fg per way, bg of the top-fg way)
        fg = cls[..., 1]  # (B, R, N)
        top = fg.argmax(dim=-1, keepdim=True)  # (B, R, 1)
        bg = torch.gather(cls[..., 0], -1, top)
        cls_final = torch.cat([fg, bg], dim=-1)  # (B, R, N+1)
        return cls_final, reg

    def _mask_head_impl(self, feats):
        """(P, 7, 7, 1024) gated RoI feats → (P, 14, 14) logits."""
        x = _nchw(feats)
        for conv in (self.mask_convs_0, self.mask_convs_1,
                     self.mask_convs_2, self.mask_convs_3):
            x = F.relu(conv(x))
        x = F.relu(self.mask_deconv(x))
        return self.mask_logits(x)[:, 0]

    # -- inference ------------------------------------------------------------

    @torch.no_grad()
    def test_forward(self, batch: EpisodeBatch) -> Dict[str, torch.Tensor]:
        c = self.cfg
        batch = to_device(batch, self.rpn_conv.weight.device)
        B = batch.qry_img.shape[0]
        N = c.n_ways

        qry_fmap, spp_fmaps = self._extract(batch)
        rpn_cls, rpn_reg = self._rpn_forward(qry_fmap, spp_fmaps)
        merged_cls, merged_reg = self._merge_ways(rpn_cls, rpn_reg)
        props, prop_scores, prop_valid = self.get_proposals(
            merged_cls, merged_reg, batch.img_hw,
            c.rpn_test_nms_pre, c.rpn_test_max_per_img,
        )
        P = props.shape[1]

        spp_maps = spp_vecs_mask = None
        if c.guidance:
            spp_maps, spp_vecs_mask = self._count_spp(
                spp_fmaps, batch.spp_boxes, batch.spp_masks
            )
        bbox_feats = self._bbox_feats(qry_fmap, props)
        cls_final, reg_ways = self._relation_impl(bbox_feats, spp_maps)
        probs = torch.softmax(cls_final.to(torch.float32), dim=-1)
        scores = probs[..., :N]  # (B, P, N)

        hw = batch.img_hw
        boxes = delta_decode(
            props[:, :, None, :], reg_ways.to(torch.float32),
            stds=c.rcnn_bbox_stds,
            max_shape=(hw[:, 0, None, None], hw[:, 1, None, None]),
        )  # (B, P, N, 4)

        flat_scores = scores.reshape(B, P * N)
        flat_boxes = boxes.reshape(B, P * N, 4)
        flat_cls = torch.arange(N, dtype=torch.int32, device=props.device)
        flat_cls = flat_cls.repeat(P)[None].expand(B, P * N)
        flat_valid = prop_valid.repeat_interleave(N, dim=1) & (
            flat_scores > c.rcnn_score_thr  # compared in f32, as in JAX
        )
        dt_boxes, dt_scores, dt_cats, _, dt_valid = batched_nms(
            flat_boxes, flat_scores, flat_cls, flat_valid,
            c.rcnn_nms_iou, c.rcnn_max_per_img, alive_fn=greedy_alive_cuda,
        )

        # mask branch on detections: gate by the detected class's support
        # vector, evaluate the single class-agnostic mask channel
        det_feats = self._bbox_feats(qry_fmap, dt_boxes)
        if c.guidance:
            C = spp_vecs_mask.shape[-1]
            gate = torch.gather(
                spp_vecs_mask, 1, dt_cats.long()[..., None].expand(-1, -1, C)
            )  # (B, M, C)
            det_feats = det_feats * gate[:, :, None, None, :].to(det_feats.dtype)
        M = dt_boxes.shape[1]
        dt_mask_logits = self._mask_head_impl(
            det_feats.reshape(B * M, 7, 7, -1)
        ).reshape(B, M, c.mask_size, c.mask_size)

        return {
            "proposals": props,
            "prop_scores": prop_scores,
            "prop_valid": prop_valid,
            "dt_boxes": dt_boxes,
            "dt_scores": dt_scores,
            "dt_cats": dt_cats,
            "dt_valid": dt_valid,
            "dt_mask_logits": dt_mask_logits.to(torch.float32),
        }


def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded init in flax's defaults: kernels lecun-normal (normal with
    variance 1/fan_in, truncated at two standard deviations), biases 0,
    norm scales 1. ``generator`` is a CPU generator; init before moving
    the model to its device."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif p.dim() == 1:
                p.fill_(1.0)
            else:
                owner = model.get_submodule(name.rsplit(".", 1)[0])
                if isinstance(owner, ConvTranspose2d):  # (in, out, kh, kw)
                    fan_in = p.shape[0] * p.shape[2] * p.shape[3]
                else:
                    fan_in = p[0].numel()
                std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
                nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)


def build_model(cfg: FGNConfig, device="cuda", seed: int = 0) -> FGN:
    """An FGN with seeded random weights on ``device`` (default ``cuda``;
    raises when there is no GPU — pass ``device="cpu"`` for the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "build_model: no CUDA device; pass device='cpu' to run on the CPU"
        )
    model = FGN(cfg)
    init_params(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()
