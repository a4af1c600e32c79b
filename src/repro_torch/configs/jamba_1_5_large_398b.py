"""jamba-1.5-large-398b [hybrid] -- Mamba+attn 1:7, MoE 16e top-2
[arXiv:2403.19887; hf].

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536.  Superblock of 8:
attention at position 4 (Jamba puts the attn layer mid-block), mamba
elsewhere; MoE replaces the dense FFN on every other layer.  Jamba uses no
explicit positional encoding (``pos_kind='none'``).  SSM state is O(1) and
only 9/72 layers hold KV => long_500k runs.
"""
from repro_torch.configs.base import ModelConfig, attn, mamba

_BLOCK = tuple(
    (attn("global", moe=(i % 2 == 1)) if i == 4 else mamba(moe=(i % 2 == 1)))
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab=65536,
    head_dim=128,
    block_pattern=_BLOCK,
    n_blocks=9,
    mlp_kind="swiglu",
    pos_kind="none",
    n_experts=16,
    top_k=2,
    tie_embeddings=False,
    supports_long_ctx=True,
    long_ctx_note="hybrid SSM: O(1) state; KV only on 9/72 layers",
)
