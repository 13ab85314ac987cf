"""The port's configuration: the JAX package's config tree.

``sniper_tpu.config`` is pure Python (PyYAML and NumPy, no jax), and PyYAML
is installed beside torch on the GPU machine, so the port loads the same
trees from ``configs/*.yml`` as the JAX package does.
"""

from sniper_tpu.config import AttrDict, default_config, load_config
from sniper_tpu.config.defaults import config_name

__all__ = ["AttrDict", "config_name", "default_config", "load_config"]
