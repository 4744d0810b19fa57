"""recurrentgemma-9b [hybrid] — 38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000 [arXiv:2402.19427; unverified]. Griffin pattern 1 local-attn :
2 RG-LRU => block_pattern (rglru, rglru, attn), 12 super-blocks + 2 remainder
rglru layers. Local attention window 2048. Sub-quadratic (O(1) recurrent
state + ring KV) -> runs long_500k. Deviation: RG-LRU gate projections are
full matrices vs Griffin's block-diagonal (DESIGN.md §8); MLP gate uses SiLU
vs GeGLU."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    arch_id="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
    d_ff=12288, vocab_size=256000,
    block_pattern=("rglru", "rglru", "attn"),
    lru_width=4096, conv_width=4,
    attn_type="swa", window=2048,
    norm_type="rmsnorm", gated_mlp=True,
    rope_theta=10_000.0, tie_embeddings=True,
    param_dtype="float32", compute_dtype="bfloat16",
    subquadratic=True,
))
