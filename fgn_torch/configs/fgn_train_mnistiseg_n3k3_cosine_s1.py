# Flagship-cell variance run #1 (VERDICT r4 item 2): the reference's
# best N3K3 cosine recipe, fresh seed, on the current code path — so the
# quoted best-of-cell rests on code that exists, with an n>=3 band.
_base_ = ["fgn_train_mnistiseg_n3k3_cosine.py"]

seed = 1
work_dir = "runs/mnistiseg_n3k3_cosine_s1"
