"""jamba-1.5-large-398b — hybrid Mamba+attention 1:7 interleave + MoE 16e top-2
[arXiv:2403.19887; hf]."""
from repro_torch.configs.base import (HybridConfig, ModelConfig, MoEConfig,
                                SSMConfig, register)


@register("jamba-1.5-large-398b")
def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        num_layers=72,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=24576,
        vocab_size=65536,
        max_seq_len=262_144,
        hybrid=HybridConfig(attn_every=8, attn_offset=4),
        moe=MoEConfig(num_experts=16, experts_per_token=2, d_ff=24576, every=2),
        ssm=SSMConfig(d_state=128, expand=2, head_dim=128, conv_kernel=4,
                      chunk_size=256),
        optimizer="adafactor",     # factored moments: 398B state fits HBM
        source="arXiv:2403.19887; hf",
    )
