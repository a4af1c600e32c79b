"""Config registry: ``--arch <id>`` -> exact public configuration.

Port of ``repro.configs``: the ten architectures and the paper's SymED
settings, as data.  The port's models build all ten.
"""
from __future__ import annotations

from repro_torch.configs import (
    codeqwen1_5_7b,
    command_r_35b,
    gemma3_27b,
    jamba_1_5_large_398b,
    mixtral_8x7b,
    nemotron_4_15b,
    olmoe_1b_7b,
    paligemma_3b,
    whisper_small,
    xlstm_125m,
)
from repro_torch.configs.base import SHAPES, LayerSpec, ModelConfig, ShapeSpec, shapes_for
from repro_torch.configs.symed_paper import PAPER_SYMED, PAPER_TOL_SWEEP

ARCHS = {
    m.CONFIG.name: m.CONFIG
    for m in (
        paligemma_3b, jamba_1_5_large_398b, whisper_small, gemma3_27b,
        codeqwen1_5_7b, nemotron_4_15b, command_r_35b, mixtral_8x7b,
        olmoe_1b_7b, xlstm_125m,
    )
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = [
    "ARCHS", "get_config", "SHAPES", "shapes_for", "ModelConfig", "LayerSpec",
    "ShapeSpec", "PAPER_SYMED", "PAPER_TOL_SWEEP",
]
