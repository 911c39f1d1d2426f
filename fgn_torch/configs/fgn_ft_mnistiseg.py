# Finetune stage on MNISTISEG (reference fgn_ft.py pattern, applied to
# the synthetic setup): base-digit Select (3K per base cat) merged with
# novel-digit Select (K+1 per novel cat {1,3,5,7}), then eval on the
# val-subset novel digits with FT=Use support banks.
_base_ = ["fgn_r50_c4_scratch.py", "fgn_ft_schedule.py"]

model = dict(n_ways=3, k_shots=3)

ft_ds_cfg0 = dict(
    n_ways=3,
    k_shots=3,
    ds_base_="MNISTISEG",
    ds_base__subset="train",
    ds_novel="MNISTISEG",
    ds_novel_subset="val",
    sampling_origin_ds="MNISTISEG",
    sampling_origin_ds_subset="train",
    sampling_cats="base_",
    # Reference protocol: the ENTIRE FT pipeline (both FT training
    # datasets and the FT=Use eval) runs sampling_scenario='children' —
    # one episode per (image, category) pair (fgn_ft.py:38,68,98; its
    # published tags are `..._novel_children`).
    sampling_scenario="children",
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

# Novel-select set: repeats=1 like the reference (fgn_ft.py:69 — the
# base Select gets repeats=10, the novel Select does not).
ft_ds_cfg1 = dict(
    ft_ds_cfg0,
    sampling_cats="novel",
    repeats=1,
)

# Reference protocol (fgn_ft.py:22-109): FT=Use on the SAME subset the
# selection came from — supports are the exact finetuned instances,
# queries are the novel-only images the selection left out.
eval_ds_cfg0 = dict(
    ft_ds_cfg1,
    sampling_cats="novel",
    finetune="Use",
    repeats=1,
    shuffle=False,
    augment_qry=False,
    augment_spp=False,
    qry_mask_scale=1,
    batch=4,
)

# Additional generalization probe: FT=Use on the held-out val subset
# (supports drawn from a val-side selection).
eval_ds_cfg1 = dict(
    eval_ds_cfg0,
    sampling_origin_ds_subset="val",
)

optimizer = dict(type="adam", lr=0.005)
work_dir = "runs/mnistiseg_ft"
batch_size = 4
eval_batch_size = 4
max_gt = 12
# Stage-1 checkpoint directory to initialize from (per-NK variants
# suffixed _N{n}K{k} are picked up by the grid driver).
init_from = "runs/mnistiseg_n3k3_adam"
