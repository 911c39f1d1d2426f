# N1K1 extended schedule: the doubled-recipe lever that closed the
# N3K1 grid cell (0.674 -> 0.947 vs reference best 0.955) applied to
# the N1K1 cell, whose 4-epoch trajectory was also still rising at stop
# (0.597 -> 0.706 cached, 0.709 fresh-support vs reference Adam 0.863).
# Distinguishes "N1K1 saturates against the de-saturated data" (the
# plain-detector calibration reading) from "N1K1 just needs the longer
# schedule like every K=1 cell".
_base_ = ["fgn_train_mnistiseg_n1k1_adam.py"]

max_epochs = 8
lr_schedule = dict(decay_epochs=[6])
work_dir = "runs/mnistiseg_n1k1_8ep"
