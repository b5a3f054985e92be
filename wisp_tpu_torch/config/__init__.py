"""The port's config front end: typed dataclass configs, the yaml subset of the app configs,
and the optimizer presets (counterpart of wisp_tpu/config)."""

from wisp_tpu_torch.config.utils import (autoconfig, config_to_dict, configure,
                                         get_config_target, instantiate, parse_config,
                                         print_config)

__all__ = ["autoconfig", "config_to_dict", "configure", "get_config_target", "instantiate",
           "parse_config", "print_config"]
