# N3K3 extended schedule (stretch, queue 14): the 4-epoch N3K3 cell
# lands at 0.881/0.864 fresh-support bbox mAP vs the reference's 0.985
# real-MNIST best, and the N3K1 cell closed its equivalent gap (0.674 ->
# 0.947) with exactly this lever — the reference recipe doubled, gamma
# 0.1 decay scaled to epoch 6 (3/4 of max_epochs, as in the reference's
# lr_config proportion). Tests whether the residual N3K3 gap is schedule
# (deformed-glyph data needs longer) or data-difficulty floor.
_base_ = ["fgn_train_mnistiseg_n3k3_adam.py"]

max_epochs = 8
lr_schedule = dict(decay_epochs=[6])
work_dir = "runs/mnistiseg_n3k3_8ep"
