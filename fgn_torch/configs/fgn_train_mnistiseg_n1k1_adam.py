# MNISTISEG N1 K1 with Adam (the reference's optimizer sweep found
# Adam 0.863 vs Adagrad 0.649 on this config — BASELINE.md). One extra
# epoch after the γ0.1 decay at epoch 3.
_base_ = ["fgn_train_mnistiseg_n1k1.py"]

optimizer = dict(type="adam", lr=0.005, weight_decay=1e-5)
max_epochs = 4
work_dir = "runs/mnistiseg_n1k1_adam2"
