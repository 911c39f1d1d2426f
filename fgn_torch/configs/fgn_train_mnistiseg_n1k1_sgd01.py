# N1K1 optimizer sweep point: sgd at the reference sweep's exact
# LR 0.01 / WD 1e-05 (MNISTISEG_N1_K1 notebook optimizer table —
# Adadelta 0.476 / SGD 0.543 / Adagrad 0.649 / Adam 0.863).
_base_ = ["fgn_train_mnistiseg_n1k1.py"]

optimizer = dict(type="sgd", lr=0.01, weight_decay=1e-5)
max_epochs = 4
work_dir = "runs/mnistiseg_n1k1_sgd01"
