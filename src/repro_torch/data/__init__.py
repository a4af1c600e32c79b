"""Data substrate: synthetic UCR-like streams, SymED tokenizer, pipeline.

Port of ``repro.data``'s re-exports.
"""
from repro_torch.data.pipeline import SymbolPipeline, TokenBatcher
from repro_torch.data.synthetic import FAMILIES, make_dataset, make_fleet
from repro_torch.data.tokenizer import SymbolTokenizer

__all__ = [
    "FAMILIES", "make_dataset", "make_fleet", "SymbolTokenizer",
    "SymbolPipeline", "TokenBatcher",
]
