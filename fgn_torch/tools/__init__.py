"""Command-line tools, each the counterpart of the script of the same name
in the repo's ``tools/``: ``python -m fgn_torch.tools.<name>``.

  * ``make_synthetic_cocovoc``: the COCO/VOC-format stand-in datasets of the
    COCO2VOC configs (host code);
  * ``export_pretrained_pth``: a ``frozen_bn`` checkpoint as a DenseCL-layout
    ``.pth`` (host code);
  * ``diagnose_detector``: proposal recall, score distribution, per-stage
    counts and renders of a checkpoint;
  * ``eval_cat_shuffle``: the category-order-shuffle evaluation protocol.

The last two run model code on ``cuda`` unless given ``--device cpu``.
"""
