"""granite-8b [dense] — llama-arch code model [arXiv:2405.04324; hf]."""

from repro_torch.configs.base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        arch_id="granite_8b",
        family="dense",
        num_layers=36,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14336,
        vocab_size=49152,
        rope_theta=1e4,
        norm_eps=1e-5,
        optimizer="adamw",
        remat="full",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch_id="granite_8b_smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=160,
        vocab_size=512,
        norm_eps=1e-5,
    )
