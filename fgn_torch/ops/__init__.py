"""Detection ops: boxes, anchors, RoIAlign, NMS, and the CUDA kernels."""
