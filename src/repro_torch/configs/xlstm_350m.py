"""xlstm-350m [ssm] — 24L d_model=1024 4H (kv=4) d_ff=0 vocab=50304
[arXiv:2405.04517; unverified]. xLSTM[7:1]: block_pattern = 7x mLSTM + 1x
sLSTM, 3 super-blocks. Blocks carry their own up/down projections (mLSTM
pf=2, sLSTM MLP pf=4/3). O(1) recurrent state -> runs long_500k."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    arch_id="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4, head_dim=256,
    d_ff=0, vocab_size=50304,
    block_pattern=("mlstm",) * 7 + ("slstm",),
    mlstm_proj_factor=2.0, slstm_proj_factor=4.0 / 3.0,
    norm_type="layernorm",
    param_dtype="float32", compute_dtype="bfloat16",
    subquadratic=True,
))
