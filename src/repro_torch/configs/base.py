"""Model/shape configuration system for the assigned architecture pool.

Port of ``repro.configs.base``, field for field.  A model is described by a
repeating *superblock* of ``LayerSpec``s plus an optional unrolled tail.
Heterogeneous stacks (jamba's 1:7 mamba:attn interleave, gemma3's 5:1
local:global) become ``n_blocks`` repeats of one superblock; the reference
scans them over stacked params, the port loops over a ``ModuleList``.

Input-shape sets (assigned): every LM arch carries the same four shapes;
``decode_*``/``long_*`` run ``serve_step`` (1 new token against a KV/state
cache), not ``train_step``.  ``long_500k`` requires a sub-quadratic path and
is enabled per-arch via ``supports_long_ctx``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

__all__ = ["LayerSpec", "ModelConfig", "ShapeSpec", "SHAPES", "attn", "mamba", "slstm", "mlstm"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer position inside a superblock."""

    kind: str = "attn"        # attn | mamba | slstm | mlstm
    attn_type: str = "global" # global | local (sliding-window)
    moe: bool = False         # MoE FFN instead of dense FFN
    has_mlp: bool = True      # xLSTM blocks carry their own projections


def attn(attn_type: str = "global", moe: bool = False) -> LayerSpec:
    return LayerSpec(kind="attn", attn_type=attn_type, moe=moe)


def mamba(moe: bool = False) -> LayerSpec:
    return LayerSpec(kind="mamba", moe=moe)


def slstm() -> LayerSpec:
    return LayerSpec(kind="slstm", has_mlp=False)


def mlstm() -> LayerSpec:
    return LayerSpec(kind="mlstm", has_mlp=False)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | vlm | audio
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int
    block_pattern: Tuple[LayerSpec, ...]
    n_blocks: int
    tail_pattern: Tuple[LayerSpec, ...] = ()

    # attention
    window: int = 4096              # sliding window for local layers
    rope_theta: float = 10_000.0
    pos_kind: str = "rope"          # rope | sinusoid (whisper) | none (jamba)
    qkv_bias: bool = False
    prefix_lm: int = 0              # bidirectional prefix length (vlm)

    # mlp
    mlp_kind: str = "swiglu"        # swiglu | gelu | relu2

    # moe
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # ssm (mamba)
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_chunk: int = 64             # inner associative-scan chunk

    # encoder-decoder (whisper)
    enc_blocks: int = 0             # encoder superblock count (same pattern)
    cross_attention: bool = False

    # modality frontend (stubs per spec: precomputed embeddings arrive as input)
    frontend: str = "none"          # none | patches | frames
    num_prefix_embeds: int = 0      # patches/frames prepended to the sequence

    # serving
    kv_quant: bool = False          # int8 KV cache (bounded-error, halves HBM)

    # misc
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    supports_long_ctx: bool = False
    long_ctx_note: str = ""

    @property
    def n_layers(self) -> int:
        return len(self.block_pattern) * self.n_blocks + len(self.tail_pattern)

    def param_count(self) -> int:
        """Total parameters (for 6*N*D roofline bookkeeping)."""
        from repro_torch.models.params import count_params  # lazy; avoids cycle

        return count_params(self)

    def active_param_count(self) -> int:
        from repro_torch.models.params import count_params

        return count_params(self, active_only=True)

    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        layers = max(len(self.block_pattern), 1)
        return dataclasses.replace(
            self,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)) if self.n_kv_heads < self.n_heads else 4,
            d_ff=128 if self.d_ff else 0,
            head_dim=16,
            vocab=256,
            n_blocks=min(self.n_blocks, 2),
            tail_pattern=self.tail_pattern[:1],
            enc_blocks=min(self.enc_blocks, 1),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            window=32,
            ssm_state=8,
            ssm_chunk=8,
            num_prefix_embeds=min(self.num_prefix_embeds, 8),
            prefix_lm=min(self.prefix_lm, 8),
            dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    step: str                        # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def shapes_for(cfg: ModelConfig) -> Tuple[str, ...]:
    """The assigned shape cells that are runnable for this arch."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.supports_long_ctx:
        out.append("long_500k")
    return tuple(out)
