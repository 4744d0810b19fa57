"""mixtral-8x22b [moe] — 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, 8 experts top-2, SWA [arXiv:2401.04088; hf]. Sliding-window
attention window 4096 per the assignment -> bounded ring KV cache makes it
sub-quadratic and long_500k-eligible. 8 experts < 16-way model axis: expert
hidden dim is TP-sharded instead of expert-parallel (DESIGN.md §4)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    arch_id="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=32768,
    n_experts=8, top_k=2, moe_dff=16384, capacity_factor=1.25,
    attn_type="swa", window=4096,
    norm_type="rmsnorm", gated_mlp=True,
    rope_theta=1_000_000.0,
    param_dtype="bfloat16", compute_dtype="bfloat16",
    subquadratic=True,
))
