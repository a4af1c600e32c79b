"""paligemma-3b [vlm] -- SigLIP + gemma backbone [arXiv:2407.07726; hf].

18L d_model=2048 8H (MQA kv=1, head_dim=256) d_ff=16384 vocab=257216.
The SigLIP vision tower is a STUB per spec: ``input_specs`` supplies 256
precomputed patch embeddings; the backbone sees them as a bidirectional
prefix (PaliGemma's prefix-LM masking).
"""
from repro_torch.configs.base import ModelConfig, attn

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_ff=16384,
    vocab=257216,
    head_dim=256,
    block_pattern=(attn("global"),),
    n_blocks=18,
    mlp_kind="geglu",
    rope_theta=10_000.0,
    prefix_lm=256,
    frontend="patches",
    num_prefix_embeds=256,
    tie_embeddings=True,
    supports_long_ctx=False,
    long_ctx_note="pure full attention -- long_500k skipped per spec",
)
