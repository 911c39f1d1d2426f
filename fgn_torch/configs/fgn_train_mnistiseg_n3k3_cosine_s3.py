# Flagship-cell variance run #3 (VERDICT r4 item 2) — see _s1.
_base_ = ["fgn_train_mnistiseg_n3k3_cosine.py"]

seed = 3
work_dir = "runs/mnistiseg_n3k3_cosine_s3"
