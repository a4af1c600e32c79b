"""Shared AST plumbing for the port's symlint rules (a copy of
``repro.analysis.astutil``: the port imports nothing of ``repro``).

Everything here is pure syntax -- no file in the sweep is ever imported or
executed.  The helpers cover the three things every rule needs: resolving
dotted expressions (``a.b.c``) to strings, walking functions with their
qualified names (``Class.method``), and reading the per-line comment channel
(suppressions and annotations ride on comments, extracted with ``tokenize``
so a ``#`` inside a string literal never counts).
"""
from __future__ import annotations

import ast
import io
import tokenize
from typing import Dict, Iterator, List, Optional, Tuple

__all__ = [
    "dotted", "parent_map", "iter_functions", "line_comments",
    "call_keywords", "walk_in_order",
]


def dotted(node: ast.AST) -> Optional[str]:
    """``Name``/``Attribute`` chain as ``"a.b.c"``; None for anything else."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def parent_map(tree: ast.AST) -> Dict[ast.AST, ast.AST]:
    """Child -> parent for every node (ast has no parent pointers)."""
    parents: Dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    return parents


def iter_functions(
    tree: ast.AST,
) -> Iterator[Tuple[str, ast.AST]]:
    """Yield ``(qualname, node)`` for every def/lambda, outermost first.

    Qualnames follow ``Class.method`` / ``outer.<locals>.inner`` shape (the
    ``<locals>`` hop is dropped for readability: ``outer.inner``).
    """

    def visit(node: ast.AST, prefix: str) -> Iterator[Tuple[str, ast.AST]]:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}{child.name}"
                yield qual, child
                yield from visit(child, f"{qual}.")
            elif isinstance(child, ast.ClassDef):
                yield from visit(child, f"{prefix}{child.name}.")
            elif isinstance(child, ast.Lambda):
                yield f"{prefix}<lambda>", child
                yield from visit(child, f"{prefix}<lambda>.")
            else:
                yield from visit(child, prefix)

    yield from visit(tree, "")


def line_comments(text: str) -> Dict[int, str]:
    """Line number -> comment text (sans ``#``), via the tokenizer."""
    out: Dict[int, str] = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(text).readline):
            if tok.type == tokenize.COMMENT:
                out[tok.start[0]] = tok.string.lstrip("#").strip()
    except tokenize.TokenError:  # unterminated something: best effort
        pass
    return out


def call_keywords(call: ast.Call) -> Dict[str, ast.expr]:
    """Keyword arguments of a call as ``{name: value}`` (no ``**kwargs``)."""
    return {kw.arg: kw.value for kw in call.keywords if kw.arg is not None}


def walk_in_order(node: ast.AST) -> Iterator[ast.AST]:
    """Depth-first, *source-order* walk (``ast.walk`` is breadth-first)."""
    yield node
    for child in ast.iter_child_nodes(node):
        yield from walk_in_order(child)
