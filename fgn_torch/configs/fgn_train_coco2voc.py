# Stage-1 training on COCO2VOC base classes (reference fgn_train.py).
_base_ = ["fgn_r50_c4_densecl.py", "fgn_train_schedule.py"]

# 800×1333 inputs have ~62k anchors (vs ~13.5k at 480px); the static
# top-k pre-NMS must scale with them or proposal recall suffers —
# match the reference's 12000/6000 (fgn_r50_c4_densecl.py:151-155,174-181).
model = dict(rpn_train_nms_pre=12288, rpn_test_nms_pre=6144)

train_ds_cfg = dict(
    n_ways=3,
    k_shots=3,
    ds_base_="COCO",
    ds_base__subset="train",
    ds_novel="VOC",
    ds_novel_subset="val",
    sampling_origin_ds="COCO",
    sampling_origin_ds_subset="train",
    sampling_cats="base_",
    augment_qry=True,
    augment_spp=True,
    # training mask targets are consumed at H/4 (batching.py) —
    # build them at quarter res end-to-end (episodic.qry_mask_scale)
    qry_mask_scale=4,
    sampling_scenario="parents",
    repeats=1,
    shuffle=True,
    qry_cats_choice_random=True,
    qry_cats_order_shuffle=True,
    spp_random=True,
    delete_qry_insts_in_spp_insts_on_train=True,
    finetune="Ignore",
    spp_fill_ratio=0.8,
    batch=8,
)

eval_ds_cfg0 = dict(
    train_ds_cfg,
    sampling_origin_ds_subset="val",
    shuffle=False,
    augment_qry=False,
    augment_spp=False,
    qry_mask_scale=1,
    batch=4,
)

work_dir = "runs/coco2voc_dcl"
batch_size = 8
eval_batch_size = 4
max_gt = 30
