# MNISTISEG N1 K1, FGN with single-way guidance (the plain Faster R-CNN
# equivalent per SURVEY.md §0; BASELINE.json config #1). CPU-runnable.
_base_ = ["fgn_r50_c4_scratch.py", "fgn_train_schedule.py"]

model = dict(n_ways=1, k_shots=1)

train_ds_cfg = dict(
    n_ways=1,
    k_shots=1,
    ds_base_="MNISTISEG",
    ds_base__subset="train",
    ds_novel="MNISTISEG",
    ds_novel_subset="val",
    sampling_origin_ds="MNISTISEG",
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
    spp_random=True,
    finetune="Ignore",
    spp_fill_ratio=0.8,
    batch=12,
)

eval_ds_cfg0 = dict(
    train_ds_cfg,
    sampling_origin_ds_subset="val",
    shuffle=False,
    augment_qry=False,
    augment_spp=False,
    qry_mask_scale=1,
    batch=8,
)

work_dir = "runs/mnistiseg_n1k1"
batch_size = 12
# Eval batch 8: detections are computed per image, so the eval batch
# changes no metric.
eval_batch_size = 8
max_gt = 12
