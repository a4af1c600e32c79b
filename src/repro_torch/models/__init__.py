"""Model zoo in PyTorch: layers, attention, MoE, assembly (serving).

Port of ``repro.models`` for the attention architectures; the training
entry point ``loss_fn`` and the SSM/xLSTM layers are not ported yet.
"""
from repro_torch.models.params import count_params, param_shapes
from repro_torch.models.transformer import (
    decode_step,
    forward,
    init_decode_state,
    init_params,
    prefill,
)

__all__ = [
    "decode_step", "forward", "init_decode_state", "init_params", "prefill",
    "count_params", "param_shapes",
]
