"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 2 recurrent : 1
attention block pattern [arXiv:2402.19427 (Griffin); hf].

MQA (kv=1), head_dim 256, GeGLU MLP, local window 2048. Sub-quadratic:
runs the long_500k shape (recurrent state is O(1); attention caches only
the 2048-token window).
"""

from repro_torch.configs.base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        arch_id="recurrentgemma_2b",
        family="hybrid",
        num_layers=26,
        d_model=2560,
        num_heads=10,
        num_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        vocab_size=256000,
        block_pattern="rra",
        lru_width=2560,
        conv_width=4,
        local_window=2048,
        rope_theta=1e4,
        norm_eps=1e-6,
        optimizer="adamw",
        remat="full",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch_id="recurrentgemma_2b_smoke",
        family="hybrid",
        num_layers=3,
        d_model=64,
        num_heads=2,
        num_kv_heads=1,
        head_dim=32,
        d_ff=192,
        vocab_size=512,
        block_pattern="rra",
        lru_width=64,
        conv_width=4,
        local_window=16,
        norm_eps=1e-6,
    )
