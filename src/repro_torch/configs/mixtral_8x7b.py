"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attn [arXiv:2401.04088; hf]."""

from repro_torch.configs.base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        arch_id="mixtral_8x7b",
        family="moe",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14336,
        vocab_size=32000,
        num_experts=8,
        experts_per_token=2,
        sliding_window=4096,
        rope_theta=1e6,
        norm_eps=1e-5,
        optimizer="adamw",
        remat="full",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch_id="mixtral_8x7b_smoke",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        num_experts=4,
        experts_per_token=2,
        expert_capacity_factor=4.0,  # dropless in smoke tests
        sliding_window=32,
    )
