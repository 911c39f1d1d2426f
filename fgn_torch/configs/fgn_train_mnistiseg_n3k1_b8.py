# N3K1 at batch 8 instead of the reference heuristic's 10.
_base_ = ["fgn_train_mnistiseg_n3k1_adam.py"]

train_ds_cfg = dict(batch=8)
batch_size = 8
work_dir = "runs/mnistiseg_n3k1_b8"
