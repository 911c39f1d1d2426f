"""The work a request or a training step needs, counted on the reference
at the cell's shapes, and the card's peaks.

``torch.utils.flop_counter.FlopCounterMode`` counts the reference's
convolutions and matrix products (forward, and backward for a step) on
the ``meta`` device: shapes only, no data, no device time. The reference
computes RoIAlign as gathers, which the counter does not see; its work is
counted from shapes (a multiply-add for each of 16 corner weights an
output element, and the same an element of the incoming gradient in the
backward). NMS is counted at the least it must do: one IoU of 12
operations a candidate. Elementwise work (norms, activations, the
optimizer) is not counted. The count follows the model's mathematics,
never how the program computes it.
"""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.harness.data import Batch
from benchmark.reference.fgn import ROI_OUT, RefFGN

ROI_ALIGN_FLOPS = 2 * 16  # a multiply-add for each of 16 corner weights
IOU_FLOPS = 12

# Dense (no sparsity) bf16 tensor-core peaks and HBM bandwidths by the name
# torch.cuda.get_device_name gives, each with its data sheet.
PEAKS = {
    "H100 80GB HBM3": dict(
        bf16=989.4e12, hbm=3.35e12,
        source="NVIDIA H100 Tensor Core GPU data sheet, H100 SXM5: 1,978.9 "
               "TFLOPS BF16 with sparsity, 989.4 dense; 3.35 TB/s HBM3"),
}


def peaks(device_name: str) -> Dict:
    for key, p in PEAKS.items():
        if key.lower() in device_name.lower():
            return p
    raise KeyError(f"no peak known for {device_name!r}")


def meta_batch(cfg: Dict, nb: int, with_gt: bool) -> Batch:
    geo, m = cfg["geometry"], cfg["model"]
    H, W, S = geo["H"], geo["W"], geo["S"]
    NK = m["n_ways"] * m["k_shots"]
    G = geo["max_gt"] if with_gt else 1
    mh, mw = (H // 4, W // 4) if with_gt else (1, 1)

    def t(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device="meta")

    return Batch(t(nb, H, W, 3, dtype=torch.uint8), t(nb, G, 4),
                 t(nb, G, dtype=torch.int32), t(nb, G, dtype=torch.bool),
                 t(nb, G, mh, mw, dtype=torch.uint8),
                 t(nb, NK, S, S, 3, dtype=torch.uint8), t(nb, NK, 4),
                 t(nb, NK, S, S, dtype=torch.uint8), t(nb, 2, dtype=torch.int32),
                 t(3), t(3))


def _counted(run) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        run()
    return counter.get_total_flops()


def serve_flops_per_img(cfg: Dict, nb: int) -> float:
    """FLOPs of one ``test_forward`` over ``nb`` queries, an image."""
    m = cfg["model"]
    with torch.device("meta"):
        ref = RefFGN(m)
    b = meta_batch(cfg, nb, False)
    P, D, N = m["rpn_test_max_per_img"], m["rcnn_max_per_img"], m["n_ways"]
    NK = N * m["k_shots"]
    C = m["feat_channels"]
    props = torch.zeros((nb, P, 4), device="meta")
    dets = torch.zeros((nb, D, 4), device="meta")
    cats = torch.zeros((nb, D), dtype=torch.int32, device="meta")
    with torch.no_grad():
        convs = _counted(lambda: ref.serve_all(b, props, dets, cats))
    bins = ROI_OUT * ROI_OUT
    roi = ROI_ALIGN_FLOPS * bins * (nb * NK * (C + 1) + nb * P * C + nb * D * C)
    geo = cfg["geometry"]
    M = (-(-geo["H"] // m["stride"])) * (-(-geo["W"] // m["stride"])) * len(
        m["anchor_scales"]) * len(m["anchor_ratios"])
    nms = IOU_FLOPS * nb * (min(m["rpn_test_nms_pre"], M) + P * N)
    return (convs + roi + nms) / nb


def train_flops_per_img(cfg: Dict, nb: int) -> float:
    """FLOPs of one training step's forward and backward over ``nb``
    queries, an image."""
    m = cfg["model"]
    with torch.device("meta"):
        ref = RefFGN(m)
    b = meta_batch(cfg, nb, True)
    P = m["rpn_train_max_per_img"]
    N, NK = m["n_ways"], m["n_ways"] * m["k_shots"]
    C = m["feat_channels"]
    props = torch.zeros((nb, P, 4), device="meta")
    valid = torch.zeros((nb, P), dtype=torch.bool, device="meta")

    def draws(name, shape):
        return torch.zeros(shape, device="meta")

    def step():
        losses = ref.train_losses(b, draws, props, valid)
        sum(v for k, v in losses.items() if k.startswith("loss_")).backward()

    convs = _counted(step)
    bins = ROI_OUT * ROI_OUT
    R = m["rcnn_num_samples"]
    P_max = max(int(R * m["rcnn_pos_fraction"]), 1)
    feat_out = bins * C * (nb * NK + nb * R)
    masks = nb * NK * bins + nb * P_max * m["mask_size"] ** 2 * b.qry_masks.shape[1]
    roi = ROI_ALIGN_FLOPS * (feat_out + masks)
    if not m["backbone_frozen"]:
        roi += ROI_ALIGN_FLOPS * feat_out  # the map's gradient
    geo = cfg["geometry"]
    M = (-(-geo["H"] // m["stride"])) * (-(-geo["W"] // m["stride"])) * len(
        m["anchor_scales"]) * len(m["anchor_ratios"])
    nms = IOU_FLOPS * nb * min(m["rpn_train_nms_pre"], M)
    return (convs + roi + nms) / nb
