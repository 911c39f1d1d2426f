# N3K1 at batch 8 with the model's gather RoIAlign selected. The port
# accepts and ignores use_pallas_roi_align: a CUDA tensor always takes
# the hand-written kernel (fgn_torch/config/fgn.py).
_base_ = ["fgn_train_mnistiseg_n3k1_adam.py"]

model = dict(use_pallas_roi_align=False)
work_dir = "runs/mnistiseg_n3k1_jnp"
