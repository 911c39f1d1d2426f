# N1K1 WD variant: Adam LR 0.01 WD 5e-05 (reference Worst/Best table
# row "LR 0.01 WD 5e-05 Adam" — the best N1K1 cell, 0.890).
_base_ = ["fgn_train_mnistiseg_n1k1.py"]

optimizer = dict(type="adam", lr=0.01, weight_decay=5e-5)
max_epochs = 4
work_dir = "runs/mnistiseg_n1k1_adam01_wd5e5"
