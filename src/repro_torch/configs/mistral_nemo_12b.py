"""mistral-nemo-12b — dense, 128k ctx [hf:mistralai/Mistral-Nemo-Base-2407]."""
from repro_torch.configs.base import ModelConfig, register


@register("mistral-nemo-12b")
def config() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-12b",
        family="dense",
        num_layers=40,
        d_model=5120,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14336,
        vocab_size=131072,
        head_dim=128,
        rope_theta=1_000_000.0,
        max_seq_len=131_072,
        source="hf:mistralai/Mistral-Nemo-Base-2407",
    )
