# Finetune stage on OMNIISEG: base letters Select merged with the novel
# 'SPUTNIK' letters Select; eval on val novel letters with FT=Use
# support banks (reference fgn_ft.py pattern; novel split
# omniiseg_fst.py:21-24).
_base_ = ["fgn_ft_mnistiseg.py"]

ft_ds_cfg0 = dict(
    ds_base_="OMNIISEG",
    ds_novel="OMNIISEG",
    sampling_origin_ds="OMNIISEG",
)
ft_ds_cfg1 = dict(
    ft_ds_cfg0,
    sampling_cats="novel",
    repeats=10,
)
eval_ds_cfg0 = dict(
    ft_ds_cfg1,
    finetune="Use",
    repeats=1,
    shuffle=False,
    augment_qry=False,
    augment_spp=False,
    batch=4,
)
eval_ds_cfg1 = dict(
    eval_ds_cfg0,
    sampling_origin_ds_subset="val",
)

work_dir = "runs/omniiseg_ft"
init_from = "runs/omniiseg_n3k3_adam"
