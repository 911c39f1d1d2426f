# MNISTISEG N3K3 with gradient accumulation — the reference's CumIters
# study point (graphs/MNISTISEG_N3_K3 Experiments_CumIters: Adagrad
# "LR 0.02 WD 1e-05 CumIters 2" tracks the CumIters-1 curve closely,
# CumIters 5 falls badly; shipped disabled upstream). Mirrored at this
# repo's N3K3 recipe: 2x the per-step LR, half the optimizer steps.
_base_ = ["fgn_train_mnistiseg_n3k3_adam.py"]

optimizer = dict(lr=0.01, cumulative_iters=2)
work_dir = "runs/mnistiseg_n3k3_cum2"
