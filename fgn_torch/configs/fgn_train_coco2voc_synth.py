# COCO2VOC stage-1 execution variant for the synthetic COCO/VOC-format
# stand-in data (tools/make_synthetic_cocovoc.py). Two deviations from
# the parity config (fgn_train_coco2voc.py), both environment-driven:
#   - the DenseCL torch checkpoint is absent from this image (the
#     conversion path itself is load-tested in tests/test_convert.py),
#     and glyph scenes are closer to MNISTISEG than ImageNet — train
#     the scratch architecture (reference fgn_r50_c4_scratch.py) like
#     every other executed run in this repo;
#   - the stand-in train set is ~100× smaller than real COCO (800
#     images ≈ 787 parent episodes), so the 1-epoch-scale reference
#     schedule is stretched: 8 epochs, γ decay at 6 (the doubled-recipe
#     lever that closed the MNIST grid cells, RESULTS.md).
_base_ = ["fgn_train_coco2voc.py"]

model = dict(
    backbone_norm="gn",
    backbone_frozen=False,
    deep_stem=True,
    avg_down=True,
)

optimizer = dict(type="adam", lr=0.005)
lr_schedule = dict(decay_epochs=[6])
max_epochs = 8

work_dir = "runs/coco2voc_synth"
