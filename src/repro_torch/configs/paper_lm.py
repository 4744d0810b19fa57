"""The paper's own language models (§4 experimental setup), as registered
by ``repro.configs.paper_lm``:

paper-lm-209m — 10L d_model=1024 16H d_ff=8192, 512-token sequences, 50k BPE
vocab (the 2-GPU-day ablation baseline behind Table 3 / Fig 3).
paper-lm-1.5b — the large-scale model of Table 1/3 (layer count chosen to hit
1.5B params at d_model=2048; the paper does not publish the exact depth).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG_209M = register(ModelConfig(
    arch_id="paper-lm-209m", family="dense",
    n_layers=10, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=8192, vocab_size=50264,
    norm_type="layernorm", gated_mlp=False, qkv_bias=False,
    stable_embedding=True,
    param_dtype="float32", compute_dtype="bfloat16",
    subquadratic=False,
))

CONFIG_1_5B = register(ModelConfig(
    arch_id="paper-lm-1.5b", family="dense",
    n_layers=25, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=50264,
    norm_type="layernorm", gated_mlp=False, qkv_bias=False,
    stable_embedding=True,
    param_dtype="float32", compute_dtype="bfloat16",
    subquadratic=False,
))
