"""whisper-small [audio] -- enc-dec, conv frontend stub [arXiv:2212.04356].

12L (decoder) + 12L encoder, d_model=768 12H (kv=12, head_dim=64) d_ff=3072
vocab=51865.  The conv1d+mel frontend is a STUB per spec: ``input_specs``
supplies 1500 precomputed frame embeddings consumed by the encoder; decoder
layers cross-attend into the encoder memory.  Whisper uses absolute
positions -> parameter-free sinusoids here.  vocab 51865 is indivisible by
the 16-way model axis, exercising the replicate fallback in the partitioner.
"""
from repro_torch.configs.base import ModelConfig, attn

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    head_dim=64,
    block_pattern=(attn("global"),),
    n_blocks=12,
    enc_blocks=12,
    cross_attention=True,
    mlp_kind="gelu",
    pos_kind="sinusoid",
    qkv_bias=True,
    frontend="frames",
    num_prefix_embeds=1500,
    tie_embeddings=True,
    supports_long_ctx=False,
    long_ctx_note="enc-dec full attention -- long_500k skipped per spec",
)
