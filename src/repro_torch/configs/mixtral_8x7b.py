"""mixtral-8x7b [moe] -- 8 experts top-2, sliding-window attention
[arXiv:2401.04088; hf].

32L d_model=4096 32H (GQA kv=8, head_dim=128) d_ff=14336 vocab=32000.
Every layer: SWA (window 4096) + MoE FFN.  Pure sliding-window => KV bounded
by the window => legitimately sub-quadratic; long_500k runs on ring caches.
8 experts are indivisible by the 16-way model axis, so expert weights fall
back to tensor-parallel d_ff sharding (partitioner fallback chain).
"""
from repro_torch.configs.base import ModelConfig, attn

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=32000,
    head_dim=128,
    block_pattern=(attn("local", moe=True),),
    n_blocks=32,
    window=4096,
    mlp_kind="swiglu",
    rope_theta=1_000_000.0,
    n_experts=8,
    top_k=2,
    tie_embeddings=False,
    supports_long_ctx=True,
    long_ctx_note="pure SWA: ring KV bounded at window=4096 per layer",
)
