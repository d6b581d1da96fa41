"""whisper-medium [audio] — enc-dec, conv frontend stub [arXiv:2212.04356].

24 encoder + 24 decoder layers, d_model 1024, 16 heads (MHA), GELU MLPs,
LayerNorm, tied unembedding. The conv/mel frontend is a STUB:
input_specs() provides precomputed frame embeddings (1500 frames).
"""

from repro_torch.configs.base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        arch_id="whisper_medium",
        family="audio",
        num_layers=24,  # decoder layers
        encoder_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        d_ff=4096,
        vocab_size=51865,
        encoder_seq=1500,
        frontend="audio_stub",
        norm_eps=1e-5,
        tie_embeddings=True,
        optimizer="adamw",
        remat="full",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch_id="whisper_medium_smoke",
        family="audio",
        num_layers=2,
        encoder_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=512,
        encoder_seq=32,
        frontend="audio_stub",
        tie_embeddings=True,
    )
