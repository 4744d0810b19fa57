"""qwen1.5-32b [dense] — 64L d_model=5120 40H (kv=40) d_ff=27392 vocab=152064.
QKV bias per the assignment table [hf:Qwen/Qwen1.5-0.5B; hf].
Full attention -> long_500k skipped (DESIGN.md §5)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    arch_id="qwen1.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40, head_dim=128,
    d_ff=27392, vocab_size=152064,
    norm_type="rmsnorm", gated_mlp=True, qkv_bias=True,
    rope_theta=1_000_000.0,
    param_dtype="bfloat16", compute_dtype="bfloat16",
    subquadratic=False,
    notes="40 heads not divisible by the 16-way model axis: attention weights "
          "fall back to fully-sharded (FSDP) placement; MLP stays TP "
          "(27392 % 16 == 0). See sharding rules resolver.",
))
