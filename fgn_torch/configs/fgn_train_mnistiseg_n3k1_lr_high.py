# N3K1 LR sweep, high point.
_base_ = ["fgn_train_mnistiseg_n3k1_b8.py"]
# batch 8 (fgn_train_mnistiseg_n3k1_b8.py).

optimizer = dict(lr=0.02)
work_dir = "runs/mnistiseg_n3k1_lr_high"
