"""musicgen-medium [audio] — 48L d_model=1536 24H (kv=24) d_ff=6144
vocab=2048 [arXiv:2306.05284; hf]. Decoder-only over EnCodec tokens; the
EnCodec encoder + text conditioner are STUBS: input_specs() provides 64
precomputed conditioning-frame embeddings prepended to the code tokens.
Deviations: rotary positions instead of sinusoidal; single codebook stream
(the 4-codebook delay pattern is out of backbone scope) — DESIGN.md §8."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    arch_id="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, head_dim=64,
    d_ff=6144, vocab_size=2048,
    norm_type="layernorm", gated_mlp=False, qkv_bias=False,
    rope_theta=10_000.0,
    frontend="audio", frontend_tokens=64,
    param_dtype="float32", compute_dtype="bfloat16",
    subquadratic=False,
))
