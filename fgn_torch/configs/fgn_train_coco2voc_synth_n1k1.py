# COCO2VOC scratch All-NK study, N1 K1 cell (reference
# graphs/COCO2VOC_Scratch_All_NK: {N1K1, N3K1, N3K3, N6K5}) on the
# synthetic stand-in data.
_base_ = ["fgn_train_coco2voc_synth.py"]

model = dict(n_ways=1, k_shots=1)
train_ds_cfg = dict(n_ways=1, k_shots=1)
eval_ds_cfg0 = dict(n_ways=1, k_shots=1)
work_dir = "runs/coco2voc_synth_n1k1"
