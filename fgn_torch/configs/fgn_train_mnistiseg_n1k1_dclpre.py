# Stage A of the frozen-pretrained pipeline (VERDICT r4 item 5): train
# the DENSECL-ARCH model (7×7 stem, frozen_bn affines — reference
# fgn_r50_c4_densecl.py) from scratch on MNISTISEG N1K1 with the
# backbone TRAINABLE, to produce a self-trained backbone that
# tools/export_pretrained_pth.py turns into a DenseCL-layout .pth
# (the real DenseCL weights are absent from this zero-egress image).
_base_ = ["fgn_train_mnistiseg_n1k1_adam.py"]

model = dict(
    n_ways=1,
    k_shots=1,
    backbone_norm="frozen_bn",
    backbone_frozen=False,
    deep_stem=False,
    avg_down=False,
)
max_epochs = 2
work_dir = "runs/mnistiseg_n1k1_dclpre"
