"""Hand-written CUDA kernels for SymED's compute hot spots, on the card.

  * ``ewma``   -- EWMA/EWMV recurrence scan (``csrc/ewma.cu``)
  * ``kmeans`` -- fused Lloyd assign half-step and the whole Lloyd loop
                  (``csrc/kmeans_assign.cu``)
  * ``dtw``    -- banded DTW (``csrc/dtw.cu``)

Port of ``repro.kernels``: ``ops`` holds the public entry points (a CUDA
tensor launches the kernel, a CPU tensor takes the plain version), ``ref``
the plain PyTorch versions the tests hold the kernels to.  Importing builds
nothing: each kernel is compiled on its first launch (``_build.load``).
"""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
