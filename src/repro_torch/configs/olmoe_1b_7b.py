"""olmoe-1b-7b [moe] -- 64 experts top-8 [arXiv:2409.02060; hf].

16L d_model=2048 16H (kv=16 => MHA, head_dim=128) d_ff=1024 (per expert)
vocab=50304.  64 experts divide the 16-way model axis exactly -> true
expert parallelism (4 experts per shard).
"""
from repro_torch.configs.base import ModelConfig, attn

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab=50304,
    head_dim=128,
    block_pattern=(attn("global", moe=True),),
    n_blocks=16,
    mlp_kind="swiglu",
    n_experts=64,
    top_k=8,
    tie_embeddings=False,
    supports_long_ctx=False,
    long_ctx_note="pure full attention -- long_500k skipped per spec",
)
