# Full FGN model config: ResNet-50-C4 with a (DenseCL-)pretrained frozen
# backbone. Mirrors the reference config surface
# (subprojects/sp02_omniiseg_fgn_mmdet/fgn_r50_c4_densecl.py) with
# explicit paths instead of environment probing.

# Optional torch checkpoint to convert (gated: absent in this image).
checkpoint_fp = ""

model = dict(
    n_ways=3,
    k_shots=3,
    backbone_norm="frozen_bn",
    backbone_frozen=True,
    deep_stem=False,
    avg_down=False,
    feat_channels=1024,
    stride=16,
    anchor_scales=(2, 4, 8, 16, 32),
    anchor_ratios=(0.5, 1.0, 2.0),
    # train_cfg (reference :131-173)
    rpn_pos_iou=0.5,
    rpn_neg_iou=0.3,
    rpn_min_pos_iou=0.3,
    rpn_num_samples=64,
    rpn_pos_fraction=0.5,
    rpn_train_nms_pre=4096,
    rpn_train_max_per_img=2000,
    rpn_nms_iou=0.7,
    rcnn_pos_iou=0.5,
    rcnn_neg_iou=0.5,
    rcnn_min_pos_iou=0.5,
    rcnn_num_samples=128,
    rcnn_pos_fraction=0.25,
    mask_size=14,
    # test_cfg (reference :174-186)
    rpn_test_nms_pre=4096,
    rpn_test_max_per_img=300,
    rcnn_score_thr=0.05,
    rcnn_nms_iou=0.5,
    rcnn_max_per_img=100,
    mask_thr=0.5,
    rcnn_bbox_stds=(0.1, 0.1, 0.2, 0.2),
    compute_dtype="bfloat16",
)
