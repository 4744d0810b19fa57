"""granite-3-8b [dense] — 40L d_model=4096 32H (GQA kv=8) d_ff=12800
vocab=49155 [hf:ibm-granite/granite-3.0-2b-base; hf]. Tied embeddings
(granite-3 family convention)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    arch_id="granite-3-8b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=12800, vocab_size=49155,
    norm_type="rmsnorm", gated_mlp=True, qkv_bias=False,
    rope_theta=10_000.0, tie_embeddings=True,
    param_dtype="float32", compute_dtype="bfloat16",
    subquadratic=False,
))
