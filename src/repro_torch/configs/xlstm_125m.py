"""xlstm-125m [ssm] -- sLSTM + mLSTM blocks [arXiv:2405.04517].

12L d_model=768 4H d_ff=0 vocab=50304.  xLSTM blocks carry their own
up/down projections (d_ff=0: no separate transformer FFN).  Superblock of 6 =
5 mLSTM + 1 sLSTM (the paper's 7:1-style mostly-mLSTM mix adapted to 12
layers), x2.  Purely recurrent state => long_500k runs with O(1) memory.
"""
from repro_torch.configs.base import ModelConfig, mlstm, slstm

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    head_dim=192,
    block_pattern=tuple([mlstm()] * 5 + [slstm()]),
    n_blocks=2,
    tie_embeddings=True,
    supports_long_ctx=True,
    long_ctx_note="recurrent state only -- O(1) decode memory",
)
