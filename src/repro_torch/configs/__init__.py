"""Architecture registry — importing this package registers the configs
the port runs so far (mamba2-130m, qwen2.5-14b)."""
from repro_torch.configs.base import (REGISTRY, HybridConfig, ModelConfig,
                                      MoEConfig, SSMConfig, all_arch_names,
                                      get_config, kv_cache_specs)

from repro_torch.configs import mamba2_130m, qwen25_14b  # noqa: F401

__all__ = [
    "REGISTRY", "HybridConfig", "ModelConfig", "MoEConfig", "SSMConfig",
    "all_arch_names", "get_config", "kv_cache_specs",
]
