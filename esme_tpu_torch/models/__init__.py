"""ESM model configs, layers, init, weight IO and the model classes."""

from .config import (ESMConfig, config_for, esm1b_config, esm1v_config,
                     esm2_config, esmc_config)
