"""xlstm-125m [ssm] — sLSTM + mLSTM blocks (xLSTM[7:1]) [arXiv:2405.04517].

d_ff=0 per assignment: block-internal widths come from projection
factors (mLSTM up-factor 2, sLSTM ff-factor 4/3), as in the paper.
Sub-quadratic: runs long_500k (O(1) recurrent state).
"""

from repro_torch.configs.base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        arch_id="xlstm_125m",
        family="ssm",
        num_layers=12,
        d_model=768,
        num_heads=4,
        num_kv_heads=4,
        head_dim=192,
        d_ff=0,
        vocab_size=50304,
        slstm_every=8,  # 1 sLSTM per 8 blocks ~ the paper's 7:1 ratio
        mlstm_chunk=128,
        proj_factor_mlstm=2.0,
        proj_factor_slstm=1.3333,
        norm_eps=1e-5,
        optimizer="adamw",
        remat="full",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch_id="xlstm_125m_smoke",
        family="ssm",
        num_layers=3,
        d_model=64,
        num_heads=2,
        num_kv_heads=2,
        head_dim=64,
        d_ff=0,
        vocab_size=256,
        slstm_every=3,
        mlstm_chunk=16,
        norm_eps=1e-5,
    )
