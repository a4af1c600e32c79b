"""Shared pass: where device values come from in the port's source.

The counterpart of ``repro.analysis.jaxinfo``.  JAX marks its device code
with ``jax.jit``; eager PyTorch has no such mark, so SL004 asks this module
which expressions give a value that lives on the device:

  * a call into ``torch.`` (``torch.where``, ``torch.zeros(..., device=)``),
    except the host-side API (``torch.from_numpy``, ``torch.device``,
    ``torch.cuda.*``, ...);
  * ``.to(<device>)`` and ``.cuda()``, whatever they are called on (a
    ``.to(torch.int32)`` is a cast, not a source);
  * a call of a registered entry (``# symlint-torch: entry(...)``), by bare
    name across the sweep, as the reference resolves its jitted functions;
  * a parameter of a hot-path function annotated ``torch.Tensor``.

A method called on a device value gives a device value (the dataflow
module follows receivers); static metadata never does: ``.shape``,
``.dtype``, ``.device``, ``.ndim``, ``.size()``, ``len()``.
"""
from __future__ import annotations

import ast
from typing import Callable, FrozenSet, Tuple

from repro_torch.analysis.astutil import dotted

__all__ = ["HOST_TORCH_CALLS", "device_call_predicate", "tensor_params"]

#: ``torch.`` callables whose results live on the host (or are not tensors)
HOST_TORCH_CALLS = frozenset({
    "torch.from_numpy", "torch.device", "torch.Size", "torch.is_tensor",
    "torch.iinfo", "torch.finfo", "torch.get_default_dtype",
    "torch.no_grad", "torch.inference_mode", "torch.enable_grad",
    "torch.manual_seed", "torch.set_num_threads", "torch.get_num_threads",
    "torch.is_floating_point", "torch.numel", "torch.promote_types",
    "torch.result_type", "torch.can_cast",
})
#: ``torch.`` namespaces of host-side API
HOST_TORCH_PREFIXES = ("torch.cuda.", "torch.backends.", "torch.utils.",
                       "torch.overrides.", "torch.distributed.",
                       "torch.profiler.", "torch.testing.", "torch.version.",
                       "torch.autograd.", "torch.multiprocessing.")
_DTYPE_NAMES = frozenset({
    "float16", "bfloat16", "float32", "float64", "half", "float", "double",
    "int8", "int16", "int32", "int64", "uint8", "bool", "long", "int",
    "complex64", "complex128",
})
_TENSOR_ANNOTATIONS = frozenset({"torch.Tensor", "Tensor"})


def _moves_to_device(call: ast.Call) -> bool:
    """``.cuda()`` or ``.to(x)`` where ``x`` names a device (not a dtype
    and not the CPU)."""
    if not isinstance(call.func, ast.Attribute):
        return False
    if call.func.attr == "cuda":
        return True
    if call.func.attr != "to":
        return False
    target = call.args[0] if call.args else next(
        (k.value for k in call.keywords if k.arg == "device"), None)
    if target is None:
        return False
    if isinstance(target, ast.Constant):
        return (isinstance(target.value, str)
                and target.value.split(":")[0] != "cpu")
    path = dotted(target) or ""
    if path.startswith("torch.") and path.split(".")[-1] in _DTYPE_NAMES:
        return False
    if (isinstance(target, ast.Call) and dotted(target.func) == "torch.device"
            and target.args and isinstance(target.args[0], ast.Constant)):
        return str(target.args[0].value).split(":")[0] != "cpu"
    return True


def device_call_predicate(
        entry_names: FrozenSet[str]) -> Callable[[ast.Call], bool]:
    """``call -> bool``: does this call give a device value by itself?"""

    def is_device_call(call: ast.Call) -> bool:
        callee = dotted(call.func) or ""
        if callee.startswith("torch."):
            return not (callee in HOST_TORCH_CALLS
                        or callee.startswith(HOST_TORCH_PREFIXES))
        if _moves_to_device(call):
            return True
        return callee.split(".")[-1] in entry_names

    return is_device_call


def tensor_params(node: ast.AST) -> Tuple[str, ...]:
    """Parameters of a def annotated ``torch.Tensor`` (or ``Tensor``)."""
    a = node.args
    return tuple(p.arg for p in a.posonlyargs + a.args + a.kwonlyargs
                 if p.annotation is not None
                 and dotted(p.annotation) in _TENSOR_ANNOTATIONS)
