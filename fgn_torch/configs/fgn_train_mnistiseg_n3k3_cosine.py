# The reference's BEST MNISTISEG N3K3 recipe, never mirrored until now:
# Adam LR 0.01, WD 5e-05, cosine annealing to min_lr_ratio 0.01 over 10
# epochs, no LR rescale (checkpoint dir "Train-3-3-Scratch … LR 0.01
# WD 5e-05 Adam NoLRRescale CosineLRDecayMinLRRatio 0.01 BEST/epoch_10"
# — main_ft.py:59-63; final-table value 0.985). Our step-decay cells
# reach 0.951 at 8 epochs; this tests the remaining-gap-is-schedule
# hypothesis with the reference's own best schedule shape.
_base_ = ["fgn_train_mnistiseg_n3k3.py"]

optimizer = dict(type="adam", lr=0.01, weight_decay=5e-5)
lr_schedule = dict(type="cosine", min_lr_ratio=0.01)
max_epochs = 10
work_dir = "runs/mnistiseg_n3k3_cosine"
