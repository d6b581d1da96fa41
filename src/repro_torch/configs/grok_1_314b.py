"""grok-1-314b [moe] — 8 experts top-2 [hf:xai-org/grok-1; unverified].

Adafactor (314B total params; see DESIGN.md Sec 7 memory budget).
"""

from repro_torch.configs.base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        arch_id="grok_1_314b",
        family="moe",
        num_layers=64,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        d_ff=32768,
        vocab_size=131072,
        num_experts=8,
        experts_per_token=2,
        rope_theta=1e4,
        norm_eps=1e-5,
        optimizer="adafactor",
        remat="full",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch_id="grok_1_314b_smoke",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=192,
        vocab_size=512,
        num_experts=4,
        experts_per_token=2,
        expert_capacity_factor=4.0,  # dropless in smoke tests
    )
