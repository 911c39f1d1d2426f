# MNISTISEG N3 K3 (BASELINE.md row: best 0.985 bbox mAP@.5 base val).
_base_ = ["fgn_train_mnistiseg_n1k1.py"]

model = dict(n_ways=3, k_shots=3)
train_ds_cfg = dict(n_ways=3, k_shots=3, batch=8)
eval_ds_cfg0 = dict(n_ways=3, k_shots=3)
work_dir = "runs/mnistiseg_n3k3"
batch_size = 8
