# N3K3 res5-norm ablation: BN (frozen-stat affine, the mmdet norm_eval
# analog — models/resnet.py make_norm) vs the default GN. Reference
# table (MNISTISEG_N3_K3 notebook): GN 0.965 vs BN 0.919.
_base_ = ["fgn_train_mnistiseg_n3k3_adam.py"]

model = dict(res5_norm="bn")
work_dir = "runs/mnistiseg_n3k3_bn"
