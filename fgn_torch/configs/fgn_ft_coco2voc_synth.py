# COCO2VOC finetune execution variant for the synthetic stand-in data —
# same environment-driven deviations as fgn_train_coco2voc_synth.py
# (scratch architecture; Adam), protocol identical to fgn_ft_coco2voc.py
# (children scenario, VOC-trainval novel Select, FT=Use eval).
_base_ = ["fgn_ft_coco2voc.py"]

model = dict(
    backbone_norm="gn",
    backbone_frozen=False,
    deep_stem=True,
    avg_down=True,
)

optimizer = dict(type="adam", lr=0.005)

work_dir = "runs/coco2voc_ft_synth"
init_from = "runs/coco2voc_synth"
