"""nemotron-4-15b [dense] -- GQA, squared-ReLU MLP [arXiv:2402.16819].

32L d_model=6144 48H (GQA kv=8, head_dim=128) d_ff=24576 vocab=256000.
Squared-ReLU (non-gated) FFN.  48 q heads shard 16-way; the 8 kv heads are
indivisible by the model axis and fall back to replication (partitioner
fallback chain), which the perf log revisits.
"""
from repro_torch.configs.base import ModelConfig, attn

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab=256000,
    head_dim=128,
    block_pattern=(attn("global"),),
    n_blocks=32,
    mlp_kind="relu2",
    tie_embeddings=False,
    supports_long_ctx=False,
    long_ctx_note="pure full attention -- long_500k skipped per spec",
)
