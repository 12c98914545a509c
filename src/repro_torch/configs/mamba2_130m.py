"""mamba2-130m — attention-free SSD (state-space duality) [arXiv:2405.21060]."""
from repro_torch.configs.base import ModelConfig, SSMConfig, register


@register("mamba2-130m")
def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m",
        family="ssm",
        num_layers=24,
        d_model=768,
        num_heads=24,          # ssd heads = expand*d_model/head_dim
        num_kv_heads=24,
        d_ff=0,
        vocab_size=50280,
        max_seq_len=1_048_576,
        ssm=SSMConfig(d_state=128, expand=2, head_dim=64, conv_kernel=4,
                      chunk_size=256),
        source="arXiv:2405.21060",
    )
