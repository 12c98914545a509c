"""arctic-480b — dense-MoE hybrid: 128 experts top-2 + parallel dense residual
[hf:Snowflake/snowflake-arctic-base]."""
from repro_torch.configs.base import ModelConfig, MoEConfig, register


@register("arctic-480b")
def config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b",
        family="moe",
        num_layers=35,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        d_ff=4864,
        vocab_size=32000,
        moe=MoEConfig(num_experts=128, experts_per_token=2, d_ff=4864,
                      dense_residual_d_ff=4864, every=1),
        optimizer="adafactor",     # factored moments: 480B state fits HBM
        source="hf:Snowflake/snowflake-arctic-base",
    )
