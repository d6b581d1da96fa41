"""qwen2.5-3b [dense] — GQA with QKV bias [hf:Qwen/Qwen2.5-*; hf]."""

from repro_torch.configs.base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        arch_id="qwen2_5_3b",
        family="dense",
        num_layers=36,
        d_model=2048,
        num_heads=16,
        num_kv_heads=2,
        d_ff=11008,
        vocab_size=151936,
        qkv_bias=True,
        rope_theta=1e6,
        norm_eps=1e-6,
        optimizer="adamw",
        remat="full",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch_id="qwen2_5_3b_smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        qkv_bias=True,
        rope_theta=1e6,
        norm_eps=1e-6,
    )
