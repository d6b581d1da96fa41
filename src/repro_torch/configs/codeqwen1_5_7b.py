"""codeqwen1.5-7b [dense] — qwen1.5-arch, MHA (kv=32) [hf:Qwen/CodeQwen1.5-7B; hf]."""

from repro_torch.configs.base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        arch_id="codeqwen1_5_7b",
        family="dense",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=32,
        d_ff=13440,
        vocab_size=92416,
        qkv_bias=True,
        rope_theta=1e6,
        norm_eps=1e-6,
        optimizer="adamw",
        remat="full",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch_id="codeqwen1_5_7b_smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=512,
        qkv_bias=True,
        norm_eps=1e-6,
    )
