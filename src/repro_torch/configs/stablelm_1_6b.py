"""stablelm-1.6b [dense] — 24L d_model=2048 32H (kv=32) d_ff=5632
vocab=100352 [hf:stabilityai/stablelm-2-1_6b; unverified]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    arch_id="stablelm-1.6b", family="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=5632, vocab_size=100352,
    norm_type="layernorm", gated_mlp=True, qkv_bias=False,
    rope_theta=10_000.0,
    param_dtype="float32", compute_dtype="bfloat16",
    subquadratic=False,
))
