# Finetune schedule (reference fgn_ft_schedule.py): same as train but
# wd 5e-5 and 6 epochs / keep 6.
_base_ = ["fgn_train_schedule.py"]

optimizer = dict(weight_decay=5e-5)
max_epochs = 6
max_keep_ckpts = 6
