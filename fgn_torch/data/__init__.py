"""Episode batches as torch tensors, and the episode engine.

The engine's names (``FewShotISEG``, the dataset bindings, ``MNISTISEG``)
load on first access: they need cv2, which the evaluation path
(``data.batching``, ``train.evaluator``) does not.
"""

import importlib

_LAZY = {
    "FewShotISEG": "fgn_torch.data.episodic",
    "COCOFewShot": "fgn_torch.data.fst_bindings",
    "MNISTFewShotISEG": "fgn_torch.data.fst_bindings",
    "OMNIFewShotISEG": "fgn_torch.data.fst_bindings",
    "VOCFewShot": "fgn_torch.data.fst_bindings",
    "init_ds_class_by_config": "fgn_torch.data.fst_bindings",
    "MNISTISEG": "fgn_torch.data.mnistiseg",
    "OMNIISEG": "fgn_torch.data.mnistiseg",
}


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
