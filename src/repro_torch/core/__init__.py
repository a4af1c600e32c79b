"""SymED core in PyTorch: the re-exports of ``repro.core``, name for name.

Sender (Alg. 1): ``normalize`` (EWMA/EWMV) + ``compress`` (O(1) bridge error).
Receiver (Alg. 2/3): ``receiver`` (wire -> pieces) + ``digitize`` (online
k-means).  ``reconstruct``/``metrics`` close the loop; ``symed`` wires
everything end to end.  ``abba`` is the paper's offline baseline
(``AbbaResult``, ``abba_encode``).
"""
from repro_torch.core.abba import AbbaResult, abba_encode
from repro_torch.core.compress import (
    CompressorState,
    PieceEvent,
    bridge_error_direct,
    compress_stream,
    compressor_finalize,
    compressor_init,
    compressor_step,
)
from repro_torch.core.digitize import (
    DigitizerState,
    digitize_pieces,
    digitize_span,
    digitizer_init,
    digitizer_step,
    masked_kmeans,
    max_cluster_variance,
    scale_coords,
)
from repro_torch.core.metrics import (
    compression_rate_abba,
    compression_rate_symed,
    drr,
    dtw_ref,
)
from repro_torch.core.normalize import (
    EwmState, ewm_init, ewm_scan, ewm_step, standardize,
)
from repro_torch.core.receiver import (
    append_tail,
    compact_chunk,
    compact_events,
    pieces_from_wire,
)
from repro_torch.core.reconstruct import (
    inverse_compression,
    inverse_digitization,
    quantize_lengths,
    reconstruct_from_pieces,
    reconstruct_from_symbols,
)
from repro_torch.core.symed import (
    ReceiverState,
    SymEDConfig,
    symbols_to_string,
    symed_batch,
    symed_encode,
    symed_encode_chunk,
    symed_finish,
    symed_receive_chunk,
    symed_receive_finish,
    symed_step_chunk,
)

__all__ = [k for k in dir() if not k.startswith("_")]
