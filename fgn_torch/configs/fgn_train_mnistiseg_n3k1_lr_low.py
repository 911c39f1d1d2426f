# N3K1 LR sweep, low point (reference publishes a 3-point LR sweep
# 0.318/0.737/0.899 for this cell — graphs/MNISTISEG_N3_K1).
_base_ = ["fgn_train_mnistiseg_n3k1_b8.py"]
# batch 8 (fgn_train_mnistiseg_n3k1_b8.py).

optimizer = dict(lr=0.0005)
work_dir = "runs/mnistiseg_n3k1_lr_low"
