# N3K1 extended schedule: the 4-epoch trajectory was still steeply
# rising at stop (0.207 -> 0.649 cached, 0.674 fresh-support; RESULTS.md
# quotes it as a lower bound vs the reference's 0.955 best) — K=1 on the
# deformed-glyph data needs more than the reference 4-epoch recipe.
# Doubled schedule with the gamma-0.1 decay scaled to epoch 6
# (reference proportion: decay at 3/4 of max_epochs,
# fgn_train_schedule.py lr_config analog).
_base_ = ["fgn_train_mnistiseg_n3k1_b8.py"]

max_epochs = 8
lr_schedule = dict(decay_epochs=[6])
work_dir = "runs/mnistiseg_n3k1_8ep"
