"""FGN — Fully Guided Network for few-shot instance segmentation, in PyTorch.

Port of the JAX package's ``models/fgn.py``, with its two entry points:

  * ``FGN.train_forward(batch, generator) -> losses``: the RPN loss per
    (image, way), RCNN assignment and sampling with the gt boxes as
    proposals, the relation head's classification and box losses, and the
    gated mask head's loss;
  * ``FGN.test_forward(batch) -> detections``: the reference's simple_test
    to a fixed number of detections per image.

The method split, the output keys and the numerics follow the JAX module;
only ``vmap`` became a batch dimension. Layout at the methods is NHWC
(fmaps (B, h, w, C), ROI features (B, R, 7, 7, C)); boxes are XYXY.

Hand-written CUDA kernels carry both paths on the card:

  * RoIAlign on backbone features (``ops/roi_align_cuda.py``): three
    forward calls per ``test_forward`` (support crops, proposals,
    detections); two per ``train_forward`` (support crops, sampled ROIs),
    each with its backward kernel in the backward pass;
  * the greedy-NMS keep mask (``ops/nms_cuda.py``): two calls per
    ``test_forward`` (RPN proposals, per-class detections), one per
    ``train_forward`` (RPN proposals).

On CPU tensors the wrappers use their plain versions.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from fgn_torch.config import FGNConfig
from fgn_torch.data.batching import EpisodeBatch, mask_to_float, to_device
from fgn_torch.models.losses import (
    accuracy_balanced, sigmoid_bce, smooth_l1, softmax_ce,
)
from fgn_torch.models.resnet import (
    Conv2d, GroupNorm, ResNetC4, SharedRes5, _nchw, _nhwc,
)
from fgn_torch.ops.anchors import anchor_inside_flags, generate_anchors
from fgn_torch.ops.assign import max_iou_assign
from fgn_torch.ops.boxes import delta_decode, delta_encode
from fgn_torch.ops.nms import batched_nms, nms_padded
from fgn_torch.ops.nms_cuda import greedy_alive_cuda
from fgn_torch.ops.roi_align import roi_align
from fgn_torch.ops.roi_align_cuda import roi_align_cuda
from fgn_torch.ops.sample import random_sample_pos_neg

# float64 serves the parity tests: gradients of this network in float32
# differ from the exact ones by up to a few percent of a leaf's largest
# entry, in the JAX package as in the port.
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float64": torch.float64}

# The uniform draws of the samplers: draws(name, shape) → a float32 tensor
# of that shape, uniform on [0, 1), on the model's device. ``train_forward``
# asks for ("rpn", (B, N, 2, M)) and then ("rcnn", (B, 2, G + P)); index 0
# of the axis of size 2 ranks the positives, index 1 the negatives.
Draws = Callable[[str, Tuple[int, ...]], torch.Tensor]


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
        # Blocks recomputed in the backward pass instead of kept
        # (torch.utils.checkpoint): a set of "backbone", "res5",
        # "relation", "mask". The same ops run in the same order.
        self.remats = frozenset(filter(None, c.remat.split(",")))
        unknown = self.remats - {"backbone", "res5", "relation", "mask"}
        if unknown:
            raise ValueError(f"FGNConfig.remat: unknown blocks {sorted(unknown)}")
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

    def _remat(self, block: str, fn, *args):
        """fn(*args), recomputed in the backward pass when ``block`` is in
        ``cfg.remat`` and autograd records."""
        if block in self.remats and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def _normalize(self, img, batch):
        x = img.to(torch.float32)
        mean = batch.norm_mean.to(torch.float32)
        std = batch.norm_std.to(torch.float32)
        return ((x - mean) / std).to(self.dt)

    def _extract(self, batch):
        """→ qry_fmap (B,h,w,C); spp_fmaps (B,N,K,hs,ws,C) or None."""
        c = self.cfg
        qry = self._remat("backbone", self.backbone,
                          self._normalize(batch.qry_img, batch))
        if not c.guidance:
            return qry, None
        B, NK, S1, S2, _ = batch.spp_imgs.shape
        spp = self._remat("backbone", self.backbone, self._normalize(
            batch.spp_imgs.reshape(B * NK, S1, S2, 3), batch))
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
        feats = self._remat("res5", self.shared5,
                            fmaps_aligned.reshape(B * NK, 7, 7, C))
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
        feats = self._remat("res5", self.shared5, feats.reshape(B * R, 7, 7, C))
        return feats.reshape(B, R, 7, 7, C)

    def _relation(self, bbox_feats, spp_maps):
        return self._remat("relation", self._relation_impl, bbox_feats,
                           spp_maps)

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

    def _mask_head(self, feats):
        return self._remat("mask", self._mask_head_impl, feats)

    def _mask_head_impl(self, feats):
        """(P, 7, 7, 1024) gated RoI feats → (P, 14, 14) logits."""
        x = _nchw(feats)
        for conv in (self.mask_convs_0, self.mask_convs_1,
                     self.mask_convs_2, self.mask_convs_3):
            x = F.relu(conv(x))
        x = F.relu(self.mask_deconv(x))
        return self.mask_logits(x)[:, 0]

    # -- training -------------------------------------------------------------

    def _rpn_loss(self, cls, reg, batch, u):
        """Per-(image, way) anchor losses / N, against each way's gt.

        cls (B,N,h,w,A), reg (B,N,h,w,A,4), u (B,N,2,M) the sampler's draws.
        As in the JAX module (a documented deviation from the reference):
        the sum over all (image, way) pairs is divided by the global
        sampled count, then by N."""
        c = self.cfg
        B, N, h, w, A = cls.shape
        M = h * w * A
        dev = cls.device
        anchors = generate_anchors(h, w, c.stride, c.anchor_scales,
                                   c.anchor_ratios, device=dev)
        cls_flat = cls.reshape(B, N, M).to(torch.float32)
        reg_flat = reg.reshape(B, N, M, 4).to(torch.float32)
        hw = batch.img_hw
        inside = anchor_inside_flags(anchors, hw[:, 0:1], hw[:, 1:2], 0)  # (B,M)
        gt_boxes = batch.qry_boxes.to(torch.float32)  # (B, G, 4)
        G = gt_boxes.shape[1]
        ways = torch.arange(N, device=dev)
        way_valid = batch.qry_valid[:, None, :] & (
            batch.qry_cats[:, None, :] == ways[None, :, None])  # (B, N, G)
        assign = max_iou_assign(
            anchors, gt_boxes[:, None], way_valid,
            c.rpn_pos_iou, c.rpn_neg_iou, c.rpn_min_pos_iou,
            match_low_quality=True, box_valid=inside[:, None],
        )  # (B, N, M)
        s = random_sample_pos_neg(u, assign.pos_mask, assign.neg_mask,
                                  c.rpn_num_samples, c.rpn_pos_fraction)
        logits = torch.gather(cls_flat, 2, s.inds)
        labels = s.is_pos.to(torch.float32)
        lw = s.valid.to(torch.float32)
        gt_idx = (torch.gather(assign.assigned_gt_inds, 2, s.inds) - 1).clamp(min=0)
        tgt = torch.gather(
            gt_boxes[:, None].expand(B, N, G, 4), 2,
            gt_idx.long()[..., None].expand(-1, -1, -1, 4))
        targets = delta_encode(anchors[s.inds], tgt)
        idx4 = s.inds[..., None].expand(-1, -1, -1, 4)
        deltas = torch.gather(reg_flat, 2, idx4)
        pos = s.is_pos & s.valid
        bw = pos.to(torch.float32)[..., None]
        total = lw.sum().clamp(min=1.0)
        losses = {
            "loss_rpn_cls": sigmoid_bce(logits, labels, lw, 1.0) / total / N,
            "loss_rpn_bbox": smooth_l1(deltas, targets, bw, 1.0) / total / N,
        }
        # diagnostics: sampled pos/neg counts per way, inside-image anchors
        n_pos = pos.sum(dim=-1).to(torch.float32)  # (B, N)
        n_neg = (~s.is_pos & s.valid).sum(dim=-1).to(torch.float32)
        for n in range(N):
            losses[f"rpn_log_pos_way{n}"] = n_pos[:, n].mean()
            losses[f"rpn_log_neg_way{n}"] = n_neg[:, n].mean()
        losses["rpn_log_valid_anchors"] = inside.sum(dim=-1).to(torch.float32).mean()
        return losses

    def _sample_rois(self, batch, props, prop_valid, u):
        """RCNN assignment and sampling, the gt boxes prepended to the
        proposals as always-positive candidates (mmdet's
        add_gt_as_proposals). u (B, 2, G+P). → (rois (B,R,4), labels (B,R)
        int32 with N for background, gt_idx (B,R), is_pos (B,R), is_valid
        (B,R), tgt_boxes (B,R,4))."""
        c = self.cfg
        N = c.n_ways
        gt_boxes = batch.qry_boxes.to(torch.float32)
        gt_valid = batch.qry_valid
        B, G = gt_valid.shape
        cand = torch.cat([gt_boxes, props], dim=1)  # (B, G+P, 4)
        # Padded proposals get a box far outside (IoU 0 → negative) and
        # are then excluded through prop_valid.
        props_for_assign = torch.where(prop_valid[..., None], props,
                                       torch.full((), -1e4, device=props.device))
        assign = max_iou_assign(
            props_for_assign, gt_boxes, gt_valid,
            c.rcnn_pos_iou, c.rcnn_neg_iou, c.rcnn_min_pos_iou,
            match_low_quality=True,
        )  # (B, P)
        g_ids = torch.arange(1, G + 1, dtype=torch.int32, device=props.device)
        gt_self = torch.where(gt_valid, g_ids, -1)
        assigned = torch.cat([gt_self, assign.assigned_gt_inds], dim=1)
        cand_valid = torch.cat([gt_valid, prop_valid], dim=1)
        s = random_sample_pos_neg(u, (assigned > 0) & cand_valid,
                                  (assigned == 0) & cand_valid,
                                  c.rcnn_num_samples, c.rcnn_pos_fraction)
        rois = torch.gather(cand, 1, s.inds[..., None].expand(-1, -1, 4))
        gt_idx = (torch.gather(assigned, 1, s.inds) - 1).clamp(min=0).long()
        labels = torch.where(s.is_pos, torch.gather(batch.qry_cats, 1, gt_idx), N)
        tgt_boxes = torch.gather(gt_boxes, 1, gt_idx[..., None].expand(-1, -1, 4))
        return rois, labels, gt_idx, s.is_pos & s.valid, s.valid, tgt_boxes

    def train_forward(self, batch: EpisodeBatch,
                      generator: Optional[torch.Generator] = None,
                      draws: Optional[Draws] = None) -> Dict[str, torch.Tensor]:
        """Losses (``loss_*``) and diagnostics of one episode batch.

        The samplers' uniform draws come from ``draws`` when given (see
        ``Draws``), else from ``torch.rand`` with ``generator``, a generator
        on the model's device."""
        c = self.cfg
        dev = self.rpn_conv.weight.device
        batch = to_device(batch, dev)
        if draws is None:
            if generator is None:
                raise ValueError("train_forward: pass a generator or draws")

            def draws(name, shape):
                return torch.rand(shape, generator=generator, device=dev)

        B = batch.qry_img.shape[0]
        N = c.n_ways

        qry_fmap, spp_fmaps = self._extract(batch)
        rpn_cls, rpn_reg = self._rpn_forward(qry_fmap, spp_fmaps)
        h, w, A = rpn_cls.shape[2:]
        losses = self._rpn_loss(rpn_cls, rpn_reg, batch,
                                draws("rpn", (B, N, 2, h * w * A)))

        # Proposals are inputs to the second stage, not a gradient path.
        with torch.no_grad():
            merged_cls, merged_reg = self._merge_ways(rpn_cls, rpn_reg)
            props, _, prop_valid = self.get_proposals(
                merged_cls, merged_reg, batch.img_hw,
                c.rpn_train_nms_pre, c.rpn_train_max_per_img,
            )
        G, P = batch.qry_boxes.shape[1], props.shape[1]
        rois, labels, gt_idx, is_pos, is_valid, tgt_boxes = self._sample_rois(
            batch, props, prop_valid, draws("rcnn", (B, 2, G + P)))
        R = rois.shape[1]

        spp_maps = spp_vecs_mask = None
        if c.guidance:
            spp_maps, spp_vecs_mask = self._count_spp(
                spp_fmaps, batch.spp_boxes, batch.spp_masks
            )
        bbox_feats = self._bbox_feats(qry_fmap, rois)
        cls_final, reg_ways = self._relation(bbox_feats, spp_maps)

        lw = is_valid.to(torch.float32).reshape(B * R)
        flat_cls = cls_final.reshape(B * R, N + 1)
        flat_labels = labels.reshape(B * R)
        losses["loss_cls"] = softmax_ce(flat_cls, flat_labels, lw,
                                        lw.sum().clamp(min=1.0))
        way = labels.clamp(0, N - 1).long()
        pred_deltas = torch.gather(
            reg_ways, 2, way[:, :, None, None].expand(-1, -1, 1, 4))[:, :, 0]
        targets = delta_encode(rois, tgt_boxes, stds=c.rcnn_bbox_stds)
        bw = is_pos.to(torch.float32)[..., None]
        losses["loss_bbox"] = smooth_l1(pred_deltas, targets, bw, float(B * R))
        acc, bal = accuracy_balanced(flat_cls, flat_labels, lw, N + 1)
        losses["acc"] = acc
        losses["acc_balanced"] = bal

        # -- mask branch: positives live in the first P_max slots ----------
        P_max = max(int(R * c.rcnn_pos_fraction), 1)
        m = c.mask_size
        pos_feats = bbox_feats[:, :P_max]
        if c.guidance:
            C = spp_vecs_mask.shape[-1]
            gate = torch.gather(spp_vecs_mask, 1,
                                way[:, :P_max, None].expand(-1, -1, C))
            pos_feats = pos_feats * gate[:, :, None, None, :].to(pos_feats.dtype)
        mask_logits = self._mask_head(
            pos_feats.reshape(B * P_max, 7, 7, -1)
        ).reshape(B, P_max, m, m)

        # targets: RoIAlign of the (downsampled) gt masks at the pos rois
        with torch.no_grad():
            mh = batch.qry_masks.shape[2]
            mask_fmap = mask_to_float(batch.qry_masks).permute(0, 2, 3, 1)
            aligned = roi_align(
                mask_fmap, rois[:, :P_max].to(torch.float32), m,
                spatial_scale=float(mh) / float(batch.qry_img.shape[1]),
            )  # (B, P_max, m, m, G)
            sel = gt_idx[:, :P_max, None, None, None].expand(-1, -1, m, m, 1)
            tgt = (torch.gather(aligned, -1, sel)[..., 0] >= 0.5).to(torch.float32)
        pos_m = is_pos[:, :P_max].to(torch.float32)
        n_pos_px = pos_m.sum().clamp(min=1.0) * (m * m)
        losses["loss_mask"] = sigmoid_bce(mask_logits, tgt,
                                          pos_m[..., None, None], n_pos_px)
        return losses

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
