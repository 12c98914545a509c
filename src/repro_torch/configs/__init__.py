"""Architecture registry — importing this package registers all configs
(the reference's ten; the model builds the dense, vlm and ssm ones)."""
from repro_torch.configs.base import (REGISTRY, SHAPES, HybridConfig,
                                      ModelConfig, MoEConfig, SSMConfig,
                                      ShapeConfig, all_arch_names,
                                      get_config, input_specs,
                                      kv_cache_specs, shape_applicable)

from repro_torch.configs import (arctic_480b, codeqwen15_7b,  # noqa: F401
                                 deepseek_coder_33b, jamba_15_large_398b,
                                 mamba2_130m, mistral_nemo_12b, qwen2_vl_7b,
                                 qwen25_14b, qwen3_moe_30b_a3b, whisper_base)

__all__ = [
    "REGISTRY", "SHAPES", "HybridConfig", "ModelConfig", "MoEConfig",
    "SSMConfig", "ShapeConfig", "all_arch_names", "get_config",
    "input_specs", "kv_cache_specs", "shape_applicable",
]
