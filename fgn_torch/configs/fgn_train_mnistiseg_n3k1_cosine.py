# The reference's BEST-recipe schedule shape (Adam LR 0.01, WD 5e-05,
# cosine to 1% over 10 epochs, no LR rescale — the N3K3 winner at
# main_ft.py:59-63) applied to the N3K1 cell. Our step-decay N3K1
# reaches 0.947 fresh-support at 8 epochs vs the reference's 0.955 best
# (graphs/MNISTISEG_N3_K1 final table); on N3K3 the same cosine recipe
# was worth +0.020 over step-decay (0.971 vs 0.951, RESULTS.md), so
# this is the direct shot at beating the reference's N3K1 cell.
# Batch stays 8 (fgn_train_mnistiseg_n3k1_b8.py).
_base_ = ["fgn_train_mnistiseg_n3k1_b8.py"]

optimizer = dict(type="adam", lr=0.01, weight_decay=5e-5)
lr_schedule = dict(type="cosine", min_lr_ratio=0.01)
max_epochs = 10
work_dir = "runs/mnistiseg_n3k1_cosine"
