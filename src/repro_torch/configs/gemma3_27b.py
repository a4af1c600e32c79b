"""gemma3-27b [dense] -- 5:1 local:global, 128k context [hf:google/gemma-3].

62L d_model=5376 32H (GQA kv=16, head_dim=128) d_ff=21504 vocab=262144.
Superblock = 5 sliding-window (1024) layers + 1 global layer, x10, tail of 2
local layers (62 = 6*10 + 2).  long_500k runs with the caveat (DESIGN.md
Sec. 5): local layers keep window-bounded ring KV; the 10 global layers hold
full-length KV sharded over the model axis; the decode step itself is O(S).
"""
from repro_torch.configs.base import ModelConfig, attn

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    d_ff=21504,
    vocab=262144,
    head_dim=128,
    block_pattern=tuple([attn("local")] * 5 + [attn("global")]),
    n_blocks=10,
    tail_pattern=(attn("local"), attn("local")),
    window=1024,
    mlp_kind="geglu",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    supports_long_ctx=True,
    long_ctx_note="5:1 local:global -- global layers hold full 500k KV (sharded); decode O(S)",
)
