# CumIters-3 study point (reference "LR 0.03 WD 1e-05 Adagrad CumIters
# 3" — graphs/MNISTISEG_N3_K3 Experiments_CumIters), at this repo's
# N3K3 Adam recipe: 3x LR, one optimizer step per 3 micro-batches.
_base_ = ["fgn_train_mnistiseg_n3k3_adam.py"]

optimizer = dict(lr=0.015, cumulative_iters=3)
work_dir = "runs/mnistiseg_n3k3_cum3"
