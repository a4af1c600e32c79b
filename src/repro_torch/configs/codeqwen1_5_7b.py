"""codeqwen1.5-7b [dense] -- qwen1.5 arch [hf:Qwen/CodeQwen1.5-7B].

32L d_model=4096 32H (kv=32 => MHA, head_dim=128) d_ff=13440 vocab=92416.
Qwen1.5 signature: qkv biases, rope theta 1M (64k code context).
"""
from repro_torch.configs.base import ModelConfig, attn

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13440,
    vocab=92416,
    head_dim=128,
    block_pattern=(attn("global"),),
    n_blocks=32,
    mlp_kind="swiglu",
    rope_theta=1_000_000.0,
    qkv_bias=True,
    tie_embeddings=False,
    supports_long_ctx=False,
    long_ctx_note="pure full attention -- long_500k skipped per spec",
)
