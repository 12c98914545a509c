"""whisper-base — enc-dec audio backbone; conv frontend is a stub
(the encoder takes precomputed frame embeddings) [arXiv:2212.04356]."""
from repro_torch.configs.base import ModelConfig, register


@register("whisper-base")
def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base",
        family="audio",
        num_layers=6,           # decoder layers
        encoder_layers=6,
        d_model=512,
        num_heads=8,
        num_kv_heads=8,
        d_ff=2048,
        vocab_size=51865,
        num_audio_frames=1500,
        max_seq_len=448 * 128,  # shape cells exercise the backbone mechanically
        source="arXiv:2212.04356",
    )
