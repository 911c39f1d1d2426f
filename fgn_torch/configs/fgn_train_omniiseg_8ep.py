# OMNIISEG extended schedule (stretch, queue 14): same doubled-recipe
# lever as the MNIST 8-epoch cells (gamma 0.1 decay at 3/4 of
# max_epochs). The 4-epoch run reads 0.935 fresh-support bbox mAP and
# was still rising at the decay; this tests the cell's converged level.
_base_ = ["fgn_train_omniiseg_adam.py"]

max_epochs = 8
lr_schedule = dict(decay_epochs=[6])
work_dir = "runs/omniiseg_n3k3_8ep"
