# From-scratch FGN variant (reference fgn_r50_c4_scratch.py): deep stem,
# avg-down shortcuts, GroupNorm, trainable backbone.
_base_ = ["fgn_r50_c4_densecl.py"]

model = dict(
    backbone_norm="gn",
    backbone_frozen=False,
    deep_stem=True,
    avg_down=True,
)
