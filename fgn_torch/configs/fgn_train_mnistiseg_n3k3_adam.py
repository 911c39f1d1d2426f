# MNISTISEG N3 K3 with Adam (reference best: 0.985 — BASELINE.md).
_base_ = ["fgn_train_mnistiseg_n3k3.py"]

optimizer = dict(type="adam", lr=0.005, weight_decay=1e-5)
max_epochs = 4
work_dir = "runs/mnistiseg_n3k3_adam"
