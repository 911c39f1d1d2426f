# Training schedule (reference fgn_train_schedule.py): Adagrad lr 5e-3
# wd 1e-5, roi_head lr 0.1×, linear warmup 100 iters @ 0.01 → step decay
# γ 0.1 at epoch 3, 3 epochs, keep 3 checkpoints.
optimizer = dict(
    type="adagrad",
    lr=0.005,
    weight_decay=1e-5,
    roi_head_lr_mult=0.1,
)
lr_schedule = dict(
    decay_epochs=[3],
    gamma=0.1,
    warmup_iters=100,
    warmup_ratio=0.01,
    min_lr=1e-6,
)
max_epochs = 3
max_keep_ckpts = 3
log_interval = 50
