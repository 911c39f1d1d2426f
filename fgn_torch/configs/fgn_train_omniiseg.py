# OMNIISEG FGN training (sp02 config family; BASELINE.json config #3).
_base_ = ["fgn_r50_c4_scratch.py", "fgn_train_schedule.py"]

model = dict(n_ways=3, k_shots=3)

train_ds_cfg = dict(
    n_ways=3,
    k_shots=3,
    ds_base_="OMNIISEG",
    ds_base__subset="train",
    ds_novel="OMNIISEG",
    ds_novel_subset="val",
    sampling_origin_ds="OMNIISEG",
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
    batch=8,
)

work_dir = "runs/omniiseg_n3k3"
batch_size = 8
eval_batch_size = 8  # fetch-bound eval: see fgn_train_mnistiseg_n1k1.py
max_gt = 12
