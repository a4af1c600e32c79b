"""One intra-op and one inter-op torch thread for the port's CPU tests.

Every ``tests/test_torch_*.py`` imports this module before anything else.
Under pytest-xdist the port's tests share the cores with the JAX package's
tests, and torch's default pool (a thread per core) makes each small eager
op wait on threads that have no core: a test of a few seconds alone then
takes minutes.  The port's CPU paths write out their summation orders, so
their results do not depend on the thread count: the bitwise tests pass at
one thread and at torch's default.
"""
import torch

torch.set_num_threads(1)
try:
    torch.set_num_interop_threads(1)
except RuntimeError:  # set once per process; later calls raise
    pass
