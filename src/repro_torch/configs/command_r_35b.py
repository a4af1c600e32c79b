"""command-r-35b [dense] -- GQA, no-bias [hf:CohereForAI/c4ai-command-r-v01].

40L d_model=8192 64H (GQA kv=8, head_dim=128) d_ff=22528 vocab=256000.
No biases anywhere; embeddings tied (Cohere convention).
"""
from repro_torch.configs.base import ModelConfig, attn

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab=256000,
    head_dim=128,
    block_pattern=(attn("global"),),
    n_blocks=40,
    mlp_kind="swiglu",
    rope_theta=8_000_000.0,
    tie_embeddings=True,
    supports_long_ctx=False,
    long_ctx_note="pure full attention -- long_500k skipped per spec",
)
