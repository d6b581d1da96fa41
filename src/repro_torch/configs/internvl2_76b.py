"""internvl2-76b [vlm] — InternViT + InternLM2 backbone [arXiv:2404.16821].

Backbone-only per the assignment: the vision frontend is a STUB;
`input_specs()` provides precomputed patch embeddings for the first
`vision_tokens` positions. Adafactor (76B).
"""

from repro_torch.configs.base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        arch_id="internvl2_76b",
        family="vlm",
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=28672,
        vocab_size=128256,
        rope_theta=1e6,
        norm_eps=1e-5,
        frontend="vision_stub",
        vision_tokens=256,
        optimizer="adafactor",
        remat="full",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch_id="internvl2_76b_smoke",
        family="vlm",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        frontend="vision_stub",
        vision_tokens=8,
    )
