# CumIters-5 study point (reference "LR 0.05 WD 1e-05 Adagrad CumIters
# 5" — the curve that falls badly in graphs/MNISTISEG_N3_K3
# Experiments_CumIters), at this repo's N3K3 Adam recipe.
_base_ = ["fgn_train_mnistiseg_n3k3_adam.py"]

optimizer = dict(lr=0.025, cumulative_iters=5)
work_dir = "runs/mnistiseg_n3k3_cum5"
