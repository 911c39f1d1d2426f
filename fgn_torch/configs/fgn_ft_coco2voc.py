# Finetune stage (reference fgn_ft.py): COCO-train base Select (3K per
# base cat) merged with VOC-trainval novel Select (K per novel cat),
# eval on VOC-trainval novel FT=Use.
#
# Protocol notes (mirrors fgn_ft.py:22-109 exactly):
#   - the ENTIRE FT pipeline runs sampling_scenario='children' — one
#     episode per (image, category) pair (fgn_ft.py:38,68,98); the
#     stage-1 train config stays 'parents' (fgn_train.py:32).
#   - ds_novel_subset is 'val' (the novel-universe definition), while
#     the VOC-origin datasets sample from 'trainval' (fgn_ft.py:28,61).
#   - FT training augments both query and support (fgn_ft.py:35-36);
#     only the FT=Use eval disables augmentation (fgn_ft.py:95-96).
_base_ = ["fgn_r50_c4_densecl.py", "fgn_ft_schedule.py"]

ft_ds_cfg0 = dict(
    n_ways=3,
    k_shots=3,
    ds_base_="COCO",
    ds_base__subset="train",
    ds_novel="VOC",
    ds_novel_subset="val",
    sampling_origin_ds="COCO",
    sampling_origin_ds_subset="train",
    sampling_cats="base_",
    sampling_scenario="children",
    augment_qry=True,
    augment_spp=True,
    repeats=10,
    shuffle=True,
    # training mask targets are consumed at H/4 (batching.py)
    qry_mask_scale=4,
    qry_cats_choice_random=True,
    qry_cats_order_shuffle=True,
    spp_random=True,
    delete_qry_insts_in_spp_insts_on_train=True,
    finetune="Select",
    spp_fill_ratio=0.8,
    batch=4,
)

ft_ds_cfg1 = dict(
    ft_ds_cfg0,
    sampling_origin_ds="VOC",
    sampling_origin_ds_subset="trainval",
    sampling_cats="novel",
    repeats=1,
    batch=1,
)

eval_ds_cfg0 = dict(
    ft_ds_cfg1,
    finetune="Use",
    shuffle=False,
    augment_qry=False,
    augment_spp=False,
    qry_mask_scale=1,
    batch=4,
)

work_dir = "runs/coco2voc_ft"
batch_size = 4
eval_batch_size = 4
max_gt = 30
# Stage-1 checkpoint directory to initialize from.
init_from = "runs/coco2voc_dcl"

# COCO-scale anchor budget (see fgn_train_coco2voc.py).
model = dict(rpn_train_nms_pre=12288, rpn_test_nms_pre=6144)
