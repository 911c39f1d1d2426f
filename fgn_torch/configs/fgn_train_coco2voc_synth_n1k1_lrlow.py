# COCO2VOC N1K1 LR-sensitivity pair, low-LR cell (reference
# graphs/COCO2VOC_DCL_N1_K1 LR table: bbox mAP base 0.271 @ lr .01 vs
# 0.151 @ lr .001 — a 1.8x quality swing from LR alone). Ours runs the
# same pair on the synthetic stand-in at the scratch arch: the default
# N1K1 cell trains at lr 5e-3, this one at 1e-3.
_base_ = ["fgn_train_coco2voc_synth_n1k1.py"]

optimizer = dict(lr=0.001)
work_dir = "runs/coco2voc_synth_n1k1_lrlow"
