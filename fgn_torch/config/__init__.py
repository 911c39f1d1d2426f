"""Configuration: the model's hyperparameters (``FGNConfig``) and the
python-file config system (``Config``, ``merge_dicts``,
``apply_typed_config``)."""

from fgn_torch.config.core import Config, apply_typed_config, merge_dicts
from fgn_torch.config.fgn import FGNConfig

__all__ = ["Config", "FGNConfig", "apply_typed_config", "merge_dicts"]
