"""Model/arch configuration and the arch registry (mirrors
``repro.configs.base``).

``ModelConfig`` keeps every field of the JAX package's config so a config
means the same in both packages.  The port registers the paper's own
language models (``paper_lm.py``) and every architecture of the JAX
package, one module each with the JAX package's values.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

_REGISTRY: dict[str, "ModelConfig"] = {}

_ARCH_MODULES = [
    "qwen1_5_32b", "stablelm_1_6b", "granite_3_8b", "command_r_35b",
    "llava_next_34b", "recurrentgemma_9b", "musicgen_medium", "xlstm_350m",
    "mixtral_8x22b", "kimi_k2_1t_a32b", "paper_lm",
]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                      # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    # block flavour
    norm_type: str = "rmsnorm"       # rmsnorm | layernorm
    gated_mlp: bool = True
    qkv_bias: bool = False
    use_bias: bool = False
    parallel_block: bool = False     # command-r style attn ∥ mlp
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    # attention
    attn_type: str = "full"          # full | swa
    window: int = 0
    attn_chunk: int = 1024
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_dff: int = 0
    # hybrid / recurrent / xlstm: per-super-block layer pattern, cycled
    block_pattern: tuple = ("attn",)
    lru_width: int = 0
    conv_width: int = 4
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0
    # embedding / frontends
    stable_embedding: bool = True
    frontend: str = "none"           # none | vision | audio
    frontend_tokens: int = 0         # prefix positions fed by the stub
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    kv_cache_bits: int = 16          # 8 => block-wise int8 KV cache (ext.)
    # training-time structure
    remat: str = "full"              # none | full | dots
    scan_layers: bool = True
    # sub-quadratic? (controls long_500k eligibility)
    subquadratic: bool = False
    # notes for DESIGN/EXPERIMENTS
    notes: str = ""

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def n_superblocks(self) -> int:
        return self.n_layers // len(self.block_pattern)

    @property
    def n_remainder_layers(self) -> int:
        return self.n_layers % len(self.block_pattern)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, H, KV, Dh = self.d_model, self.n_heads, self.n_kv_heads, self.head_dim
        n = self.vocab_size * d                       # embedding
        if not self.tie_embeddings:
            n += self.vocab_size * d                  # output head
        per_block = {}
        per_block["attn"] = d * H * Dh + 2 * d * KV * Dh + H * Dh * d \
            + (H * Dh + 2 * KV * Dh if self.qkv_bias else 0) + 2 * d
        f = self.d_ff
        mlp = (3 if self.gated_mlp else 2) * d * f
        if self.is_moe:
            fe = self.moe_dff or f
            mlp = d * self.n_experts + self.n_experts * (3 if self.gated_mlp else 2) * d * fe
        per_block["attn"] += mlp
        W = self.lru_width or d
        per_block["rglru"] = 2 * d * W + self.conv_width * W + 2 * W * W + W * d + 3 * W + 2 * d \
            + ((3 if self.gated_mlp else 2) * d * f if f else 0)
        Wm = int(d * self.mlstm_proj_factor)
        Dm = Wm // H
        per_block["mlstm"] = 2 * d * Wm + 4 * H * Dm * Dm + Wm * 2 * H + Wm * d + 2 * d
        fs = int(d * self.slstm_proj_factor)
        per_block["slstm"] = 4 * d * d + 4 * d * (d // H) + 4 * d + d * fs + fs * d + 2 * d
        for i in range(self.n_layers):
            kind = self.block_pattern[i % len(self.block_pattern)]
            n += per_block[kind]
        return int(n)

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top_k of n_experts)."""
        if not self.is_moe:
            return self.param_count()
        fe = self.moe_dff or self.d_ff
        dense_expert = self.n_experts * (3 if self.gated_mlp else 2) * self.d_model * fe
        active_expert = self.top_k * (3 if self.gated_mlp else 2) * self.d_model * fe
        return int(self.param_count() - self.n_layers * (dense_expert - active_expert))


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.arch_id] = cfg
    return cfg


def get_config(arch_id: str) -> ModelConfig:
    if not _REGISTRY:
        load_all()
    if arch_id not in _REGISTRY:
        raise ValueError(f"unknown arch '{arch_id}'; have {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]


def list_archs() -> list[str]:
    if not _REGISTRY:
        load_all()
    return sorted(_REGISTRY)


def load_all():
    for mod in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Smoke-test-size variant of an arch config (same family/flavour)."""
    base_changes = dict(
        n_layers=max(2, len(cfg.block_pattern)),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads > 1 else 1,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        attn_chunk=32,
        window=min(cfg.window, 32) if cfg.window else 0,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        moe_dff=32 if cfg.moe_dff else 0,
        lru_width=64 if cfg.lru_width else 0,
        frontend_tokens=4 if cfg.frontend_tokens else 0,
        param_dtype="float32",
        compute_dtype="float32",
        remat="none",
        scan_layers=cfg.scan_layers,
    )
    base_changes.update(overrides)
    return dataclasses.replace(cfg, **base_changes)
