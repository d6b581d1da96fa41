"""llama3-405b [dense] — GQA, 128k vocab [arXiv:2407.21783; unverified].

Adafactor optimizer so optimizer state fits 16 GiB/chip HBM at 256 chips
(AdamW fp32 moments for 405B would need ~4.9 TiB; see DESIGN.md Sec 7).
"""

from repro_torch.configs.base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        arch_id="llama3_405b",
        family="dense",
        num_layers=126,
        d_model=16384,
        num_heads=128,
        num_kv_heads=8,
        d_ff=53248,
        vocab_size=128256,
        rope_theta=5e5,
        norm_eps=1e-5,
        optimizer="adafactor",
        remat="full",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch_id="llama3_405b_smoke",
        family="dense",
        num_layers=3,
        d_model=128,
        num_heads=8,
        num_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        rope_theta=5e5,
        optimizer="adafactor",
    )
