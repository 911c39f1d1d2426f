# MNISTISEG N3 K1 (BASELINE.md row: best 0.955 bbox mAP@.5 base val).
_base_ = ["fgn_train_mnistiseg_n1k1.py"]

model = dict(n_ways=3, k_shots=1)
train_ds_cfg = dict(n_ways=3, k_shots=1, batch=10)
eval_ds_cfg0 = dict(n_ways=3, k_shots=1)
work_dir = "runs/mnistiseg_n3k1"
batch_size = 10
