"""The plain reference of FGN (Fully Guided Network, Fan et al., CVPR 2020):
ResNet-50-C4, the attention-guided RPN, support pooling, the shared res5
RoI tower, the relation head and the gated mask head, in float32.

Frozen from the port's ``models/fgn.py`` (itself the JAX package's module
in PyTorch) at the benchmark's first commit, with no kernels, no NMS and no
sorting: the comparison (``harness/compare.py``) replays the program's
greedy choices against the scores and boxes computed here, so the
reference never has to make a discrete choice of its own. Parameter names
are the port's: one state dict loads into both.

Layout: NHWC maps, (B, R, 7, 7, C) RoI features, XYXY boxes. The batch is
any object with the ``harness.data.Batch`` fields.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import nets, ops
from benchmark.reference.precision import QUANTIZERS

ROI_OUT = 7


def _mask_float(m):
    f = m.to(torch.float32)
    return f / 255.0 if m.dtype == torch.uint8 else f


class RefFGN(nn.Module):
    def __init__(self, model_cfg: Dict, precision: str = "f32"):
        super().__init__()
        c = self.c = dict(model_cfg)
        q = QUANTIZERS[precision]
        A = len(c["anchor_scales"]) * len(c["anchor_ratios"])
        C = c["feat_channels"]
        self.backbone = nets.ResNetC4(
            norm=c["backbone_norm"], frozen=c["backbone_frozen"],
            deep_stem=c["deep_stem"], avg_down=c["avg_down"], q=q)
        self.rpn_conv = nets.Conv2d(1024, C, 3, q=q)
        self.rpn_cls = nets.Conv2d(C, A, 1, q=q)
        self.rpn_reg = nets.Conv2d(C, A * 4, 1, q=q)
        self.shared5 = nets.SharedRes5(norm=c.get("res5_norm", "gn"), q=q)
        self.rel_conv_roi = nets.Conv2d(1024, 1024, 1, q=q)
        self.rel_conv_spp = nets.Conv2d(1024, 1024, 1, bias=False, q=q)
        self.rel_gn = nets.GroupNorm(32, 1024, 1e-5)
        self.fc_cls = nets.Linear(1024, 2, q=q)
        self.fc_reg = nets.Linear(1024, 4, q=q)
        self.mask_convs_0 = nets.Conv2d(1024, 256, 3, q=q)
        self.mask_convs_1 = nets.Conv2d(256, 256, 3, q=q)
        self.mask_convs_2 = nets.Conv2d(256, 256, 3, q=q)
        self.mask_convs_3 = nets.Conv2d(256, 256, 3, q=q)
        self.mask_deconv = nets.ConvTranspose2d(256, 256, 2, q=q)
        self.mask_logits = nets.Conv2d(256, 1, 1, q=q)

    # -- stages ---------------------------------------------------------------

    def _normalize(self, img, batch):
        return (img.to(torch.float32) - batch.norm_mean) / batch.norm_std

    def extract(self, batch):
        """→ qry (B, h, w, C), spp (B, N, K, hs, ws, C)."""
        c = self.c
        qry = self.backbone(self._normalize(batch.qry_img, batch))
        B, NK, S1, S2, _ = batch.spp_imgs.shape
        spp = self.backbone(self._normalize(
            batch.spp_imgs.reshape(B * NK, S1, S2, 3), batch))
        hs, ws, C = spp.shape[1:]
        return qry, spp.reshape(B, c["n_ways"], c["k_shots"], hs, ws, C)

    def rpn(self, qry, spp):
        """Attention-guided RPN: each way's mean support vector scales the
        query map. → cls (B, N, h, w, A), reg (B, N, h, w, A, 4)."""
        B, h, w, C = qry.shape
        N = self.c["n_ways"]
        mod = qry[:, None] * spp.mean(dim=(2, 3, 4))[:, :, None, None, :]
        x = F.relu(self.rpn_conv(nets.nchw(mod.reshape(B * N, h, w, C))))
        cls = nets.nhwc(self.rpn_cls(x)).reshape(B, N, h, w, -1)
        reg = nets.nhwc(self.rpn_reg(x)).reshape(B, N, h, w, cls.shape[-1], 4)
        return cls, reg

    def rpn_candidates(self, cls, reg, img_hw):
        """Per anchor, the way with the top objectness (the first on ties):
        → scores (B, M) after the sigmoid, decoded clipped boxes (B, M, 4),
        valid (B, M) for boxes of nonzero width and height."""
        c = self.c
        B, N, h, w, A = cls.shape
        top = cls.argmax(dim=1)
        m_cls = cls.max(dim=1).values
        m_reg = torch.gather(reg, 1, top[:, None, ..., None].expand(
            -1, 1, -1, -1, -1, 4))[:, 0]
        a = ops.anchors(h, w, c["stride"], c["anchor_scales"],
                        c["anchor_ratios"], cls.device)
        M = a.shape[0]
        hw = img_hw.to(torch.float32)
        boxes = ops.delta_decode(a[None], m_reg.reshape(B, M, 4),
                                 max_hw=(hw[:, 0:1], hw[:, 1:2]))
        valid = ((boxes[..., 2] - boxes[..., 0]) > c.get("rpn_min_bbox_size", 0.0)) & (
            (boxes[..., 3] - boxes[..., 1]) > c.get("rpn_min_bbox_size", 0.0))
        return torch.sigmoid(m_cls.reshape(B, M)), boxes, valid

    def count_spp(self, spp, spp_boxes, spp_masks):
        """→ support maps (B, N, 7, 7, C), mask-pooled vectors (B, N, C)."""
        B, N, K, hs, ws, C = spp.shape
        S = spp_masks.shape[-1]
        rois = spp_boxes.reshape(B * N * K, 1, 4).to(torch.float32)
        masks = ops.roi_align(_mask_float(spp_masks).reshape(B * N * K, S, S, 1),
                              rois, ROI_OUT, 1.0)
        fm = ops.roi_align(spp.reshape(B * N * K, hs, ws, C), rois, ROI_OUT,
                           1.0 / self.c["stride"])
        feats = self.shared5(fm.reshape(B * N * K, ROI_OUT, ROI_OUT, C))
        feats = feats.reshape(B, N, K, ROI_OUT, ROI_OUT, C)
        vecs = (feats * masks.reshape(B, N, K, ROI_OUT, ROI_OUT, 1)).mean(dim=(2, 3, 4))
        return feats.mean(dim=2), vecs

    def bbox_feats(self, qry, rois):
        B, R = rois.shape[:2]
        C = qry.shape[-1]
        f = ops.roi_align(qry, rois, ROI_OUT, 1.0 / self.c["stride"])
        return self.shared5(f.reshape(B * R, ROI_OUT, ROI_OUT, C)).reshape(
            B, R, ROI_OUT, ROI_OUT, C)

    def relation(self, feats, spp_maps):
        """→ (fg per way then the top-fg way's bg) (B, R, N+1), reg (B, R, N, 4)."""
        B, R = feats.shape[:2]
        N = self.c["n_ways"]
        x = (nets.conv1x1_nhwc(self.rel_conv_roi, feats)[:, :, None]
             + nets.conv1x1_nhwc(self.rel_conv_spp, spp_maps)[:, None])
        x = F.relu(self.rel_gn(nets.nchw(x.reshape(B * R * N, ROI_OUT, ROI_OUT, 1024))))
        pooled = x.mean(dim=(2, 3)).reshape(B, R, N, 1024)
        cls = self.fc_cls(pooled)
        reg = self.fc_reg(pooled)
        fg = cls[..., 1]
        bg = torch.gather(cls[..., 0], -1, fg.argmax(dim=-1, keepdim=True))
        return torch.cat([fg, bg], dim=-1), reg

    def mask_head(self, feats):
        """(P, 7, 7, 1024) → (P, 14, 14) logits."""
        x = nets.nchw(feats)
        for conv in (self.mask_convs_0, self.mask_convs_1, self.mask_convs_2,
                     self.mask_convs_3):
            x = F.relu(conv(x))
        return self.mask_logits(F.relu(self.mask_deconv(x)))[:, 0]

    # -- serving --------------------------------------------------------------

    def det_candidates(self, batch, qry, spp_maps, props):
        """At the given proposals (B, P, 4): → class scores (B, P, N) and
        decoded clipped boxes (B, P, N, 4), as the detection NMS sees them."""
        cls, reg = self.relation(self.bbox_feats(qry, props), spp_maps)
        N = self.c["n_ways"]
        scores = torch.softmax(cls, dim=-1)[..., :N]
        hw = batch.img_hw.to(torch.float32)
        boxes = ops.delta_decode(props[:, :, None, :], reg,
                                 stds=self.c["rcnn_bbox_stds"],
                                 max_hw=(hw[:, 0, None, None], hw[:, 1, None, None]))
        return scores, boxes

    def det_masks(self, qry, spp_vecs, dt_boxes, dt_cats):
        """Mask logits (B, M, 14, 14) at the given detections, gated by their
        class's mask-pooled support vector."""
        B, M = dt_boxes.shape[:2]
        feats = self.bbox_feats(qry, dt_boxes)
        gate = torch.gather(spp_vecs, 1, dt_cats.long()[..., None].expand(
            -1, -1, spp_vecs.shape[-1]))
        feats = feats * gate[:, :, None, None, :]
        m = self.c["mask_size"]
        return self.mask_head(feats.reshape(B * M, ROI_OUT, ROI_OUT, -1)).reshape(B, M, m, m)

    def serve_all(self, batch, props, dt_boxes, dt_cats):
        """Every stage of one served request at the given proposals and
        detections (for the FLOP count)."""
        qry, spp = self.extract(batch)
        cls, reg = self.rpn(qry, spp)
        self.rpn_candidates(cls, reg, batch.img_hw)
        spp_maps, spp_vecs = self.count_spp(spp, batch.spp_boxes, batch.spp_masks)
        self.det_candidates(batch, qry, spp_maps, props)
        return self.det_masks(qry, spp_vecs, dt_boxes, dt_cats)

    # -- training -------------------------------------------------------------

    def train_losses(self, batch, draws: Callable[[str, Tuple[int, ...]], torch.Tensor],
                     props, prop_valid) -> Dict[str, torch.Tensor]:
        """The losses of one batch, with the second stage's proposals given
        (B, P, 4) and their validity (B, P): the RPN's sampled anchor losses,
        the relation head's classification and box losses over ROIs sampled
        from the gt boxes and the proposals, and the gated mask loss."""
        c = self.c
        N = c["n_ways"]
        qry, spp = self.extract(batch)
        cls, reg = self.rpn(qry, spp)
        B, _, h, w, A = cls.shape
        M = h * w * A
        dev = cls.device
        a = ops.anchors(h, w, c["stride"], c["anchor_scales"], c["anchor_ratios"], dev)
        hw = batch.img_hw
        inside = ops.inside_flags(a, hw[:, 0:1], hw[:, 1:2])
        gt = batch.qry_boxes.to(torch.float32)
        G = gt.shape[1]
        way_valid = batch.qry_valid[:, None, :] & (
            batch.qry_cats[:, None, :] == torch.arange(N, device=dev)[None, :, None])
        asg = ops.max_iou_assign(a, gt[:, None], way_valid, c["rpn_pos_iou"],
                                 c["rpn_neg_iou"], c["rpn_min_pos_iou"],
                                 box_valid=inside[:, None])
        s = ops.sample_pos_neg(draws("rpn", (B, N, 2, M)), asg.pos, asg.neg,
                               c["rpn_num_samples"], c["rpn_pos_fraction"])
        logits = torch.gather(cls.reshape(B, N, M), 2, s.inds)
        lw = s.valid.to(torch.float32)
        gidx = (torch.gather(asg.gt_inds, 2, s.inds) - 1).clamp(min=0).long()
        tgt = torch.gather(gt[:, None].expand(B, N, G, 4), 2, gidx[..., None].expand(-1, -1, -1, 4))
        deltas = torch.gather(reg.reshape(B, N, M, 4), 2, s.inds[..., None].expand(-1, -1, -1, 4))
        pos = (s.is_pos & s.valid).to(torch.float32)[..., None]
        total = lw.sum().clamp(min=1.0)
        losses = {
            "loss_rpn_cls": ops.sigmoid_bce(logits, s.is_pos.to(torch.float32), lw, 1.0) / total / N,
            "loss_rpn_bbox": ops.smooth_l1(deltas, ops.delta_encode(a[s.inds], tgt), pos, 1.0) / total / N,
        }

        # second stage: gt boxes first, then the given proposals
        gt_valid = batch.qry_valid
        cand = torch.cat([gt, props], dim=1)
        p_assign = torch.where(prop_valid[..., None], props, torch.full((), -1e4, device=dev))
        asg2 = ops.max_iou_assign(p_assign, gt, gt_valid, c["rcnn_pos_iou"],
                                  c["rcnn_neg_iou"], c["rcnn_min_pos_iou"])
        ids = torch.arange(1, G + 1, dtype=torch.int32, device=dev)
        assigned = torch.cat([torch.where(gt_valid, ids, -1), asg2.gt_inds], dim=1)
        cvalid = torch.cat([gt_valid, prop_valid], dim=1)
        s2 = ops.sample_pos_neg(draws("rcnn", (B, 2, G + props.shape[1])),
                                (assigned > 0) & cvalid, (assigned == 0) & cvalid,
                                c["rcnn_num_samples"], c["rcnn_pos_fraction"])
        rois = torch.gather(cand, 1, s2.inds[..., None].expand(-1, -1, 4))
        gidx2 = (torch.gather(assigned, 1, s2.inds) - 1).clamp(min=0).long()
        labels = torch.where(s2.is_pos, torch.gather(batch.qry_cats, 1, gidx2), N)
        tgt_boxes = torch.gather(gt, 1, gidx2[..., None].expand(-1, -1, 4))
        is_pos = s2.is_pos & s2.valid
        R = rois.shape[1]

        spp_maps, spp_vecs = self.count_spp(spp, batch.spp_boxes, batch.spp_masks)
        feats = self.bbox_feats(qry, rois)
        cls_f, reg_w = self.relation(feats, spp_maps)
        lw2 = s2.valid.to(torch.float32).reshape(B * R)
        losses["loss_cls"] = ops.softmax_ce(cls_f.reshape(B * R, N + 1),
                                            labels.reshape(B * R), lw2,
                                            lw2.sum().clamp(min=1.0))
        way = labels.clamp(0, N - 1).long()
        pred = torch.gather(reg_w, 2, way[:, :, None, None].expand(-1, -1, 1, 4))[:, :, 0]
        losses["loss_bbox"] = ops.smooth_l1(
            pred, ops.delta_encode(rois, tgt_boxes, stds=c["rcnn_bbox_stds"]),
            is_pos.to(torch.float32)[..., None], float(B * R))

        P_max = max(int(R * c["rcnn_pos_fraction"]), 1)
        m = c["mask_size"]
        C = spp_vecs.shape[-1]
        gate = torch.gather(spp_vecs, 1, way[:, :P_max, None].expand(-1, -1, C))
        pf = feats[:, :P_max] * gate[:, :, None, None, :]
        mlog = self.mask_head(pf.reshape(B * P_max, ROI_OUT, ROI_OUT, -1)).reshape(B, P_max, m, m)
        with torch.no_grad():
            mh = batch.qry_masks.shape[2]
            mf = _mask_float(batch.qry_masks).permute(0, 2, 3, 1)
            al = ops.roi_align(mf, rois[:, :P_max], m, float(mh) / float(batch.qry_img.shape[1]))
            sel = gidx2[:, :P_max, None, None, None].expand(-1, -1, m, m, 1)
            mt = (torch.gather(al, -1, sel)[..., 0] >= 0.5).to(torch.float32)
        pm = is_pos[:, :P_max].to(torch.float32)
        losses["loss_mask"] = ops.sigmoid_bce(mlog, mt, pm[..., None, None],
                                              pm.sum().clamp(min=1.0) * (m * m))
        return losses
