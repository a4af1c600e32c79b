"""Serve step construction.

Port of the serving half of ``repro.train.steps``: ``make_serve_step``.
The training steps are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.models import decode_step as _decode_step

__all__ = ["make_serve_step"]


def make_serve_step(cfg, *, temperature: float = 0.0):
    """``serve_step(params, state, token, generator=None) -> (next token
    (B, 1) int32, new state)``: greedy, or with ``temperature > 0`` and a
    ``generator`` (where the reference takes a key) a sample from the
    tempered softmax."""

    def serve_step(params, state, token, generator=None):
        logits, new_state = _decode_step(params, cfg, state, token)
        if temperature > 0.0 and generator is not None:
            probs = torch.softmax(logits[:, -1] / temperature, dim=-1)
            next_tok = torch.multinomial(probs, 1, generator=generator)
            next_tok = next_tok.to(torch.int32)
        else:
            next_tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        return next_tok, new_state

    return serve_step
