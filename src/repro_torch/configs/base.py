"""Model/arch configuration schema and the assigned input-shape grid.

Every assigned architecture has a module ``repro_torch.configs.<arch_id>``
exposing ``full_config()`` (the exact published dimensions) and
``smoke_config()`` (a reduced same-family config for CPU smoke tests).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Tuple

__all__ = ["ModelConfig", "Shape", "SHAPES", "get_config", "get_smoke_config", "list_archs"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- MoE ---
    num_experts: int = 0  # 0 = dense FFN
    experts_per_token: int = 2
    expert_capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    moe_impl: str = "gather"  # gather (baseline) | local (shard-local dispatch, §Perf)

    # --- attention pattern ---
    sliding_window: int = 0  # 0 = full; > 0 = sliding-window attention
    attn_chunk: int = 1024  # KV-chunk size for the online-softmax path
    attn_impl: str = "auto"  # auto | direct | chunked
    decode_seq_shard: bool = False  # flash-decoding cache layout (§Perf opt)
    attn_gqa_grouped: bool = False  # grouped-GQA einsum, no kv repeat (§Perf opt)

    # --- hybrid (recurrentgemma) ---
    # pattern of temporal-mixing blocks, cycled over layers:
    # "a"=attention (local), "r"=RG-LRU recurrent
    block_pattern: str = ""  # "" = all attention
    lru_width: int = 0  # 0 -> d_model
    conv_width: int = 4
    local_window: int = 2048

    # --- xLSTM ---
    slstm_every: int = 0  # 0 = no sLSTM blocks; else 1 sLSTM per N blocks
    mlstm_chunk: int = 128
    proj_factor_mlstm: float = 2.0
    proj_factor_slstm: float = 1.3333

    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0  # 0 = decoder-only
    encoder_seq: int = 1500  # stub conv frontend output frames
    frontend: str = "none"  # none | audio_stub | vision_stub

    # --- vlm ---
    vision_tokens: int = 0  # prefix positions fed from the vision stub

    # --- numerics / execution ---
    dtype: str = "bfloat16"
    scan_layers: bool = False  # scan for production training; unrolled dry-run
    remat: str = "none"  # none | full | dots
    optimizer: str = "adamw"  # adamw | adafactor

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        assert self.num_heads % max(self.num_kv_heads, 1) == 0

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run 500k-token contexts? (SSM / hybrid w/ local attn)"""
        if self.family == "ssm":
            return True
        if self.family == "hybrid" and "r" in self.block_pattern:
            return True
        return False

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have a decode path (whisper = enc-dec)

    @property
    def param_count(self) -> int:
        """Analytic parameter count (embedding + per-layer weights)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim
        q = d * self.num_heads * hd
        kv = 2 * d * self.num_kv_heads * hd
        o = self.num_heads * hd * d
        attn = q + kv + o
        if self.num_experts > 0:
            ffn = self.num_experts * 3 * d * f + d * self.num_experts  # experts + router
        elif self.family == "ssm":
            pf = self.proj_factor_mlstm
            ffn = int(2 * d * pf * d + 4 * (pf * d) * hd)  # rough mLSTM block
        else:
            ffn = 3 * d * f  # SwiGLU/GeGLU
        layers = self.num_layers * (attn + ffn + 2 * d)
        if self.encoder_layers:
            layers += self.encoder_layers * (attn + ffn + 2 * d)
        emb = v * d * (1 if self.tie_embeddings else 2)
        return emb + layers

    @property
    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k experts only)."""
        if self.num_experts == 0:
            return self.param_count
        d, f = self.d_model, self.d_ff
        inactive = (self.num_experts - self.experts_per_token) * 3 * d * f
        return self.param_count - self.num_layers * inactive


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": Shape("train_4k", 4_096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32_768, 128, "decode"),
    "long_500k": Shape("long_500k", 524_288, 1, "decode"),
}

ARCH_IDS = (
    "internvl2_76b",
    "qwen2_5_3b",
    "granite_8b",
    "llama3_405b",
    "codeqwen1_5_7b",
    "recurrentgemma_2b",
    "mixtral_8x7b",
    "grok_1_314b",
    "xlstm_125m",
    "whisper_medium",
)

# CLI aliases (the assignment's hyphenated ids).
ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}
ALIASES.update({a: a for a in ARCH_IDS})
ALIASES.update({
    "internvl2-76b": "internvl2_76b",
    "qwen2.5-3b": "qwen2_5_3b",
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "grok-1-314b": "grok_1_314b",
})


def list_archs() -> Tuple[str, ...]:
    return ARCH_IDS


def _module(arch: str):
    arch = ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).full_config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()
