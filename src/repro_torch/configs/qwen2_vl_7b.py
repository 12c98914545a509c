"""qwen2-vl-7b — VLM backbone with M-RoPE; patch frontend is a stub
[arXiv:2409.12191; hf]."""
from repro_torch.configs.base import ModelConfig, register


@register("qwen2-vl-7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b",
        family="vlm",
        num_layers=28,
        d_model=3584,
        num_heads=28,
        num_kv_heads=4,
        d_ff=18944,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        mrope_sections=(16, 24, 24),  # t/h/w sections over head_dim/2 = 64
        source="arXiv:2409.12191; hf",
    )
