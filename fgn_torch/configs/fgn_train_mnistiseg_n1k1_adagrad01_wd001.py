# N1K1 WD variant: Adagrad LR 0.01 WD 0.001 (reference Worst/Best table
# row "LR 0.01 WD 0.001 Adagrad" — graphs/MNISTISEG_N1_K1).
_base_ = ["fgn_train_mnistiseg_n1k1.py"]

optimizer = dict(type="adagrad", lr=0.01, weight_decay=1e-3)
max_epochs = 4
work_dir = "runs/mnistiseg_n1k1_adagrad01_wd001"
