"""Roofline terms of a dry-run cell on the card.

The counterpart of ``repro.utils.hlo``'s ``HW`` and ``roofline_terms``.  The
reference's HLO parser (its collective inventory from the compiled program's
text) has its counterpart in ``utils.collectives``, which counts the
collectives a ``DTensor`` trace issues; the dry run passes their wire bytes
here for a serving cell.  A train cell has no inventory yet (``wire=None``).
"""
from __future__ import annotations

from typing import Dict, Optional

__all__ = ["HW", "roofline_terms"]

# NVIDIA H100 SXM (nvidia-smi: "NVIDIA H100 80GB HBM3", power limit 700.00
# W): the data sheet's dense peaks at that limit, not measurements.
HW = {
    "peak_flops": 989.4e12,    # bf16 FLOP/s per card, dense
    "hbm_bw": 3.35e12,         # HBM3 bytes/s per card
    "nvlink_bw": 900e9,        # NVLink bytes/s per card, all links
}


def roofline_terms(flops_per_dev: float, hbm_bytes_per_dev: float,
                   wire_bytes_per_dev: Optional[float] = None
                   ) -> Dict[str, object]:
    """The roofline terms in seconds (inputs per device).  With no wire
    bytes, ``collective_s`` is ``None`` and ``dominant`` is the larger of
    the other two."""
    terms = {
        "compute": flops_per_dev / HW["peak_flops"],
        "memory": hbm_bytes_per_dev / HW["hbm_bw"],
        "collective": (None if wire_bytes_per_dev is None
                       else wire_bytes_per_dev / HW["nvlink_bw"]),
    }
    dominant = max(((k, v) for k, v in terms.items() if v is not None),
                   key=lambda kv: kv[1])[0]
    return {
        "compute_s": terms["compute"],
        "memory_s": terms["memory"],
        "collective_s": terms["collective"],
        "dominant": dominant,
    }
