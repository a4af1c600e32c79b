"""Count host syncs as they happen, by Python site and by entry.

The deep tier's sync counter (SL006) and its check on the card.  A host
sync is a call that makes the host wait for the device: reading a device
value on the host, a blocking copy between the host and the device, or an
op whose output size depends on the device's data.  ``SyncCounter`` sees
them through two PyTorch modes at once:

  * a ``TorchFunctionMode`` sees the host transfers as Python calls:
    ``item``, ``tolist``, ``numpy``, ``__bool__``, ``__int__``,
    ``__float__``, ``__index__``, ``__array__`` of a tensor on the drive's
    device, and the blocking copies between the CPU and a CUDA drive device
    (``to``, ``cpu``, ``cuda``, ``copy_``, ``torch.tensor``/``as_tensor``/
    ``asarray`` of host data);
  * a ``TorchDispatchMode`` sees the ops that wait on the device under CUDA
    wherever they are called from: ``aten._local_scalar_dense``,
    ``nonzero``, ``masked_select``, ``index``/``index_put_`` with a boolean
    index, the ``unique`` family, ``repeat_interleave`` without
    ``output_size``, ``equal``, and blocking copies across.

Each sync counts once: while a transfer the function mode counted runs,
the dispatch mode counts nothing (``bool(t)`` shows in both).  On a CUDA
drive a read counts only where its tensor lives on the card; on the CPU
every tensor lives on the drive's device, so the count also holds reads of
host-made tensors: each device has its own budgets.

A sync is keyed by ``(entry, site, caller)``: ``site`` is the innermost
frame in the port's source (``path:line``; the analysis package itself is
skipped), ``caller`` the next one up, ``entry`` the innermost registered
entry on the stack (of those the counter was given), ``"-"`` outside them.
``SyncDebugRecorder`` keys the warnings of
``torch.cuda.set_sync_debug_mode("warn")`` the same way, so that the two
can be held against each other on the card, op for op.

Imports ``torch`` on use; importing this module does not.
"""
from __future__ import annotations

import collections
import os
import sys
import warnings
from pathlib import Path
from typing import Counter, Dict, Iterable, Optional, Tuple

__all__ = ["Attributor", "SyncCounter", "SyncDebugRecorder", "NO_ENTRY"]

NO_ENTRY = "-"
_PKG = Path(__file__).resolve().parent.parent      # src/repro_torch
_SELF = Path(__file__).resolve().parent            # src/repro_torch/analysis
_READS = frozenset({"item", "tolist", "numpy", "__bool__", "__int__",
                    "__float__", "__index__", "__array__"})
_COPIES = frozenset({"to", "cpu", "cuda", "copy_"})
_FACTORIES = frozenset({"tensor", "as_tensor", "asarray"})
_WATCHED = _READS | _COPIES | _FACTORIES
#: dispatch-level ops that wait on the device (by overload packet name)
_DEVICE_WAITS = frozenset({
    "_local_scalar_dense", "nonzero", "masked_select", "unique_dim",
    "_unique", "_unique2", "unique_consecutive", "unique_dim_consecutive",
    "equal", "repeat_interleave",
})
_BOOL_INDEXED = frozenset({"index", "index_put", "index_put_",
                           "_index_put_impl_"})
_DISPATCH_COPIES = frozenset({"_to_copy", "copy_"})
_OP_NAMES = _DEVICE_WAITS | _BOOL_INDEXED | _DISPATCH_COPIES

Key = Tuple[str, str, str]


class Attributor:
    """Turns the current Python stack into an ``(entry, site, caller)`` key.

    ``entries`` maps code objects to entry labels; ``root`` is the
    directory paths are shown relative to (the repository); ``sources``
    are files outside the port's package whose frames count as sites too
    (the swept copies a test loads from elsewhere).
    """

    def __init__(self, entries: Dict[object, str], root: Path,
                 sources: Iterable[str] = ()):
        self.entries = dict(entries)
        self.root = str(Path(root).resolve())
        self._pkg = str(_PKG) + os.sep
        self._self = str(_SELF) + os.sep
        self._sources = {str(Path(s).resolve()) for s in sources}
        self._cache: Dict[str, Optional[str]] = {}

    def _rel(self, filename: str) -> Optional[str]:
        """The shown path of a frame's file, or None for a frame that is
        not a site (torch, the standard library, this package)."""
        got = self._cache.get(filename, False)
        if got is not False:
            return got
        path = os.path.realpath(filename)
        ok = ((path.startswith(self._pkg) or path in self._sources)
              and not path.startswith(self._self))
        rel = None
        if ok:
            rel = (os.path.relpath(path, self.root)
                   if path.startswith(self.root + os.sep) else path)
            rel = rel.replace(os.sep, "/")
        self._cache[filename] = rel
        return rel

    def locate(self, frame) -> Key:
        entry, sites = None, []
        while frame is not None:
            if entry is None:
                entry = self.entries.get(frame.f_code)
            if len(sites) < 2:
                rel = self._rel(frame.f_code.co_filename)
                if rel is not None:
                    sites.append(f"{rel}:{frame.f_lineno}")
            if entry is not None and len(sites) == 2:
                break
            frame = frame.f_back
        sites += ["-"] * (2 - len(sites))
        return (entry or NO_ENTRY, sites[0], sites[1])


class _Tally:
    """Counts by key, with per-entry and per-site views."""

    def __init__(self):
        self.counts: Counter[Key] = collections.Counter()

    def by_entry(self) -> Dict[str, int]:
        out: Dict[str, int] = collections.Counter()
        for (entry, _, _), n in self.counts.items():
            out[entry] += n
        return dict(out)

    @property
    def total(self) -> int:
        return sum(self.counts.values())


class SyncCounter(_Tally):
    """Context manager: count the host syncs of the code it wraps.

    ``device`` is the drive's device (``"cpu"`` or ``"cuda"``).  Counting
    costs a Python call per torch function and per op while it is on."""

    def __init__(self, device, attributor: Attributor):
        super().__init__()
        import torch
        from torch.overrides import TorchFunctionMode
        from torch.utils._python_dispatch import TorchDispatchMode

        self._torch = torch
        self.device_type = torch.device(device).type
        self.attributor = attributor
        self._depth = 0
        owner = self

        class _Functions(TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                if (getattr(func, "__name__", None) in _WATCHED
                        and owner._function_syncs(func.__name__, args,
                                                  kwargs)):
                    owner._hit()
                    owner._depth += 1
                    try:
                        return func(*args, **kwargs)
                    finally:
                        owner._depth -= 1
                return func(*args, **kwargs)

        watched: Dict[object, bool] = {}

        class _Ops(TorchDispatchMode):
            @classmethod
            def _should_skip_dynamo(cls):
                # the port compiles nothing: keep the handler out of
                # torch._disable_dynamo's wrapper, which costs each op
                return False

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                may = watched.get(func)
                if may is None:
                    may = watched[func] = (func.overloadpacket.__name__
                                           in _OP_NAMES)
                if (may and owner._depth == 0
                        and owner._op_syncs(func, args, kwargs)):
                    owner._hit()
                return func(*args, **kwargs)

        self._modes = (_Functions(), _Ops())

    # -- what syncs --------------------------------------------------------

    def _here(self, t) -> bool:
        return (isinstance(t, self._torch.Tensor)
                and t.device.type == self.device_type)

    def _crosses(self, src, dst, non_blocking) -> bool:
        """A blocking copy between the CPU and a CUDA drive device."""
        if non_blocking or self.device_type == "cpu" or dst is None:
            return False
        return ({src.type, self._torch.device(dst).type}
                == {"cpu", self.device_type})

    def _function_syncs(self, name, args, kwargs) -> bool:
        torch = self._torch
        if name in _FACTORIES:
            data = args[0] if args else kwargs.get("data", kwargs.get("obj"))
            dst = kwargs.get("device")
            if dst is None or isinstance(data, torch.Tensor) and (
                    data.device.type == torch.device(dst).type):
                return False
            src = (data.device if isinstance(data, torch.Tensor)
                   else torch.device("cpu"))
            return self._crosses(src, dst, False)
        if not args or not isinstance(args[0], torch.Tensor):
            return False
        t = args[0]
        if name in _READS:
            return self._here(t)
        if name == "cpu":
            return self._crosses(t.device, "cpu", False)
        if name == "cuda":
            return self._crosses(t.device, kwargs.get(
                "device", args[1] if len(args) > 1 else "cuda"),
                kwargs.get("non_blocking", False))
        if name == "copy_":
            src = args[1] if len(args) > 1 else kwargs.get("src")
            if not isinstance(src, torch.Tensor):
                return False
            return self._crosses(src.device, t.device, kwargs.get(
                "non_blocking", args[2] if len(args) > 2 else False))
        if name == "to":
            if len(args) > 1 and isinstance(args[1], torch.Tensor):
                dst, non_blocking = args[1].device, kwargs.get(
                    "non_blocking", False)
            else:
                dst, _, non_blocking, _ = torch._C._nn._parse_to(
                    *args[1:], **kwargs)
            return self._crosses(t.device, dst, non_blocking)
        return False

    def _op_syncs(self, func, args, kwargs) -> bool:
        name = func.overloadpacket.__name__
        torch = self._torch
        if name in _DEVICE_WAITS:
            if name == "repeat_interleave" and (
                    kwargs.get("output_size") is not None
                    or func._overloadname not in ("Tensor", "self_Tensor")):
                return False  # the output's size is known on the host
            return any(self._here(a) for a in args)
        if name in _BOOL_INDEXED:
            idx = args[1] if len(args) > 1 else kwargs.get("indices", ())
            return self._here(args[0]) and any(
                isinstance(i, torch.Tensor)
                and i.dtype in (torch.bool, torch.uint8) for i in idx or ())
        if name in _DISPATCH_COPIES:
            if name == "copy_":
                return self._crosses(args[1].device, args[0].device,
                                     kwargs.get("non_blocking", False))
            return self._crosses(args[0].device, kwargs.get("device"),
                                 kwargs.get("non_blocking", False))
        return False

    def _hit(self) -> None:
        self.counts[self.attributor.locate(sys._getframe(2))] += 1

    # -- context -----------------------------------------------------------

    def __enter__(self) -> "SyncCounter":
        for mode in self._modes:
            mode.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        for mode in reversed(self._modes):
            mode.__exit__(*exc)


class SyncDebugRecorder(_Tally):
    """Context manager: ``torch.cuda.set_sync_debug_mode("warn")``, with
    every "synchronizing CUDA operation" warning counted under the
    ``Attributor``'s key of the stack that raised it (other warnings pass
    through).  Only CUDA work raises these."""

    _MESSAGE = "synchronizing CUDA operation"

    def __init__(self, attributor: Attributor):
        super().__init__()
        self.attributor = attributor
        self._prev = None
        self._catch = None

    def _show(self, message, category, filename, lineno, file=None,
              line=None):
        if self._MESSAGE in str(message):
            self.counts[self.attributor.locate(sys._getframe(1))] += 1
        else:
            self._orig(message, category, filename, lineno, file, line)

    def __enter__(self) -> "SyncDebugRecorder":
        import torch

        self._catch = warnings.catch_warnings()
        self._catch.__enter__()
        warnings.simplefilter("always")
        self._orig = warnings.showwarning
        warnings.showwarning = self._show
        self._prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc) -> None:
        import torch

        torch.cuda.set_sync_debug_mode(self._prev)
        self._catch.__exit__(*exc)
