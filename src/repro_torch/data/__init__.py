"""Data substrate: synthetic UCR-like streams.

Port of ``repro.data``'s re-exports.  The SymED tokenizer and the training
pipeline (``SymbolTokenizer``, ``SymbolPipeline``, ``TokenBatcher``) come
with the training slice.
"""
from repro_torch.data.synthetic import FAMILIES, make_dataset, make_fleet

__all__ = ["FAMILIES", "make_dataset", "make_fleet"]
