# Stage B of the frozen-pretrained pipeline (VERDICT r4 item 5): the
# reference's pretrained-backbone training mode executed for real —
# fgn_r50_c4_densecl.py:4-41 (convert a .pth via models/convert.py),
# main.py:402-405 (res4 never exists in our C4 backbone — structurally
# dropped), fgn.py:52-53,67-77 (backbone frozen: stop_gradient +
# excluded from the optimizer). The .pth is the self-trained stand-in
# exported by tools/export_pretrained_pth.py from the _dclpre run.
_base_ = ["fgn_train_mnistiseg_n1k1_adam.py"]

model = dict(
    n_ways=1,
    k_shots=1,
    backbone_norm="frozen_bn",
    backbone_frozen=True,
    deep_stem=False,
    avg_down=False,
)
checkpoint_fp = "data/pretrained/mnist_dcl_standin.pth"
max_epochs = 3
work_dir = "runs/mnistiseg_n1k1_frozen"
