# Flagship-cell variance run #2 (VERDICT r4 item 2) — see _s1.
_base_ = ["fgn_train_mnistiseg_n3k3_cosine.py"]

seed = 2
work_dir = "runs/mnistiseg_n3k3_cosine_s2"
