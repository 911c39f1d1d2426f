# OMNIISEG N3K3 with Adam + a post-decay epoch (the combination that
# reached reference parity on MNISTISEG N1K1 — RESULTS.md).
_base_ = ["fgn_train_omniiseg.py"]

optimizer = dict(type="adam", lr=0.005, weight_decay=1e-5)
max_epochs = 4
work_dir = "runs/omniiseg_n3k3_adam"
