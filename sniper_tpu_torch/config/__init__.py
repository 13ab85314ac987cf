"""The port's configuration tree: its own copy of sniper_tpu/config (the
same keys, defaults and YAML loader), so that the port loads the same trees
from ``configs/*.yml`` as the JAX package does without importing it."""

from sniper_tpu_torch.config.defaults import (
    AttrDict,
    config_name,
    default_config,
    load_config,
    update_config,
    update_config_from_list,
)

__all__ = [
    "AttrDict",
    "config_name",
    "default_config",
    "load_config",
    "update_config",
    "update_config_from_list",
]
