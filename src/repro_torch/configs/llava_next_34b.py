"""llava-next-34b [vlm] — 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000 [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified].
Backbone only (Yi-34B-flavoured); the anyres vision tower is a STUB:
input_specs() provides 576 precomputed patch embeddings per example,
projected and prepended to token embeddings (assignment rule)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    arch_id="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=20480, vocab_size=64000,
    norm_type="rmsnorm", gated_mlp=True, qkv_bias=False,
    rope_theta=5_000_000.0,
    frontend="vision", frontend_tokens=576,
    param_dtype="bfloat16", compute_dtype="bfloat16",
    subquadratic=False,
))
