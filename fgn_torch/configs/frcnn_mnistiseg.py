# Plain Faster/Mask R-CNN on MNISTISEG — the reference's missing "sp01"
# subproject equivalent (SURVEY.md §0: BASELINE.json names sp01 workloads
# but the nets/ tree is absent upstream; FGN with N=1 and guidance off is
# the natural stand-in). CPU-runnable.
_base_ = ["fgn_train_mnistiseg_n1k1.py"]

model = dict(guidance=False)
optimizer = dict(type="adam")
max_epochs = 4
work_dir = "runs/frcnn_mnistiseg"
