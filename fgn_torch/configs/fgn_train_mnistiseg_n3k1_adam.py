# MNISTISEG N3 K1 with Adam (reference N3K1 best: 0.955 — BASELINE.md).
_base_ = ["fgn_train_mnistiseg_n3k1.py"]

optimizer = dict(type="adam", lr=0.005, weight_decay=1e-5)
max_epochs = 4
work_dir = "runs/mnistiseg_n3k1_adam"
