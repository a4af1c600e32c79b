"""Ambient mesh context for activation sharding constraints.

Port of ``repro.sharding.ctx``.  Model code calls ``constrain(x, "batch",
None, "heads")`` with *logical* axis names.  With no mesh context it returns
``x``.  With one, the names resolve to a spec on the mesh (with the
divisibility fallback) and the active dry-run recorder, if any, receives
``(logical, shape, spec)``; ``x`` comes back itself.  The reference's
constraint is a layout hint to the partitioner; in one process the tensor is
whole, so the port records the layout and never changes a value.

``exclude`` removes mesh axes from resolution -- the compressed train step's
``pod`` axis, over which the pods exchange their gradients themselves.
``disable`` turns *logical* names into ``None`` -- ``seq_block`` turns off
sequence parallelism.
"""
from __future__ import annotations

import contextlib
import contextvars
import sys
from typing import List, Optional, Tuple

from repro_torch.sharding.partition import logical_to_spec

__all__ = ["constrain", "current_mesh", "recording", "use_mesh_rules"]

_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_mesh_ctx", default=None)
_RECORDER: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_constrain_recorder", default=None)


@contextlib.contextmanager
def use_mesh_rules(mesh, exclude: Tuple[str, ...] = (),
                   disable: Tuple[str, ...] = ()):
    """``exclude``: mesh axes constraints may not touch.  ``disable``:
    *logical* names to resolve as ``None``."""
    token = _CTX.set((mesh, tuple(exclude), tuple(disable)))
    try:
        yield
    finally:
        _CTX.reset(token)


def current_mesh():
    ctx = _CTX.get()
    return ctx[0] if ctx else None


@contextlib.contextmanager
def recording():
    """Collect every resolved ``constrain`` as ``(logical names as the site
    gave them, shape, spec)`` in the yielded list."""
    sites: List[tuple] = []
    token = _RECORDER.set(sites)
    try:
        yield sites
    finally:
        _RECORDER.reset(token)


def constrain(x, *logical: Optional[str]):
    """The logical-axis constraint on ``x``: resolved and recorded when a
    mesh context is active; ``x`` itself either way, but a ``DTensor``,
    which comes back redistributed to the resolved spec."""
    ctx = _CTX.get()
    if ctx is None:
        return x
    mesh, exclude, disable = ctx
    names = tuple(None if n in disable else n for n in logical)
    spec = logical_to_spec(names, tuple(x.shape), mesh, exclude=exclude)
    sites = _RECORDER.get()
    if sites is not None:
        sites.append((tuple(logical), tuple(x.shape), spec))
    # a DTensor exists only once its module is imported: plain runs never
    # import it here
    dt = sys.modules.get("torch.distributed.tensor")
    if dt is not None and isinstance(x, dt.DTensor):
        from repro_torch.utils.collectives import placements

        return x.redistribute(x.device_mesh, placements(
            spec, x.device_mesh.mesh_dim_names))
    return x
