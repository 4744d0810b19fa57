"""command-r-35b [dense] — 40L d_model=8192 64H (GQA kv=8) d_ff=22528
vocab=256000 [hf:CohereForAI/c4ai-command-r-v01; unverified].
Parallel attention+FFN block, LayerNorm. Deviation note: the assignment says
no-bias; our LayerNorm keeps a zero-init bias param (DESIGN.md §8)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    arch_id="command-r-35b", family="dense",
    n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=22528, vocab_size=256000,
    norm_type="layernorm", gated_mlp=True, qkv_bias=False,
    parallel_block=True, rope_theta=8_000_000.0, tie_embeddings=True,
    param_dtype="bfloat16", compute_dtype="bfloat16",
    subquadratic=False,
))
