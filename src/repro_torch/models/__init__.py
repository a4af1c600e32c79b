"""Model zoo in PyTorch: layers, attention, MoE, SSM, xLSTM, assembly.

Port of ``repro.models``: every assigned architecture builds, counts,
prefills and decodes; ``loss_fn`` is the next-token loss whose gradient
``train.steps`` takes (``remat`` recomputes the superblocks in the
backward).
"""
from repro_torch.models.params import count_params, param_shapes
from repro_torch.models.transformer import (
    decode_step,
    forward,
    init_decode_state,
    init_params,
    loss_fn,
    prefill,
)

__all__ = [
    "decode_step", "forward", "init_decode_state", "init_params", "loss_fn",
    "prefill", "count_params", "param_shapes",
]
