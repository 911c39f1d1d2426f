# N3K1 at the REFERENCE batch heuristic (main.py:493-499 -> batch 10):
# the extended-schedule cell at the reference batch
# (FGNConfig.remat stays off: the faithful setting).
_base_ = ["fgn_train_mnistiseg_n3k1.py"]

max_epochs = 8
lr_schedule = dict(decay_epochs=[6])
work_dir = "runs/mnistiseg_n3k1_b10"
# batch_size 10 inherited from fgn_train_mnistiseg_n3k1.py
