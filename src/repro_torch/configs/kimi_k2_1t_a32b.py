"""kimi-k2-1t-a32b [moe] — 61L d_model=7168 64H (GQA kv=8) d_ff=2048
vocab=163840, MoE 384 experts top-8 (paper-table) [arXiv:2501.kimi2;
unverified]. ~1.03T params, ~32B active. We follow the assignment table
exactly (no shared expert, no MLA, all layers MoE — the released K2 differs;
DESIGN.md §8). 384 % 16 == 0 -> true expert parallelism on the model axis."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    arch_id="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=112,
    d_ff=2048, vocab_size=163840,
    n_experts=384, top_k=8, moe_dff=2048, capacity_factor=1.25,
    norm_type="rmsnorm", gated_mlp=True,
    rope_theta=50_000.0,
    param_dtype="bfloat16", compute_dtype="bfloat16",
    subquadratic=False,
))
