# COCO2VOC scratch All-NK study, N6 K5 cell (reference
# graphs/COCO2VOC_Scratch_All_NK — its largest-way/shot cell) on the
# synthetic stand-in data. Batch halved: 6 relation ways x 30 support
# crops per query at the 800x1088 canvas.
_base_ = ["fgn_train_coco2voc_synth.py"]

model = dict(n_ways=6, k_shots=5)
train_ds_cfg = dict(n_ways=6, k_shots=5, batch=4)
eval_ds_cfg0 = dict(n_ways=6, k_shots=5)
work_dir = "runs/coco2voc_synth_n6k5"
batch_size = 4
