"""SL005 wire-protocol consistency: encoder and decoder must agree, by bytes.

The counterpart of ``repro.analysis.rules.wire``, the same checks over the
port's codecs: the frame layouts of ``repro_torch/launch/transport.py`` and
the payload codecs of ``repro_torch/core/receiver.py`` (the reference's
tool cannot check them: it takes the first match of each name in sorted
order, which is under ``src/repro/``).  They are two halves of one
contract, written in two files.  A one-sided edit -- widening a count field,
reordering a header, changing a dtype -- type-checks, imports, and fails only
when real bytes cross the wire (or worse, *doesn't* fail and silently
mis-decodes).  This rule cross-checks the halves statically:

  * **token match** -- each codec pair must use the same multiset of struct
    format strings, dtype literals, record layouts, and pack/unpack helper
    calls (``encode_closed`` packs ``"!IIB"`` + a delta blob, so
    ``decode_closed`` must unpack ``"!IIB"`` + a delta blob);
  * **offset check** -- every fixed offset the decoder reads at
    (``unpack_from(fmt, buf, k)``, ``frombuffer(..., offset=k)``,
    ``payload[k:]``) must land on a boundary of the encoder's cumulative
    struct layout;
  * **pairing** -- if one half of a pair exists in the sweep and the other
    does not, that is itself a finding (inline decodes drift);
  * **constant contracts** -- the accounting constants
    (``DELTA_SYMBOL_BYTES`` etc.) must equal the byte width of the record
    layout they describe.

Functions are located by name anywhere in the sweep, so the rule (and its
mutation test) runs unchanged on fixture copies of the codec files.
"""
from __future__ import annotations

import ast
import re
import struct as struct_mod
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.analysis.astutil import dotted, iter_functions, walk_in_order
from repro_torch.analysis.engine import Finding, Project, register

RULE = "SL005"

#: (encoder name, decoder name, check_offsets) -- bare function names,
#: resolved anywhere in the sweep
CODEC_PAIRS: Tuple[Tuple[str, str, bool], ...] = (
    ("encode_open", "decode_open", True),
    ("encode_data_raw", "decode_data_raw", True),
    ("encode_data_pieces", "decode_data_pieces", True),
    ("encode_close", "decode_close", True),
    ("encode_closed", "decode_closed", True),
    ("pack_delta_frame", "unpack_delta_frame", True),
    ("pack_piece_tuples", "unpack_piece_tuples", True),
    # framing layer: feed() parses length prefix before the body header, so
    # token order differs by design and offsets are dynamic (sid_len)
    ("_frame", "feed", False),
)

#: accounting constants tied to a record layout's byte width
CONST_REC_CONTRACTS = (
    ("DELTA_SYMBOL_BYTES", "_DELTA_REC"),
    ("PIECE_TUPLE_BYTES", "_PIECE_REC"),
)
#: accounting constants tied to an encoder's struct header width
CONST_HEADER_CONTRACTS = (
    ("DELTA_FRAME_HEADER_BYTES", "pack_delta_frame"),
)

_STRUCT_CALLS = {"struct.pack", "struct.unpack", "struct.unpack_from",
                 "struct.pack_into"}
_DTYPE_RE = re.compile(r"^[<>=|]?[a-zA-Z]\d+$")
_DTYPE_SINKS = ("frombuffer", "astype", "asarray", "empty", "zeros",
                "dtype", "array")


def _dtype_size(s: str) -> Optional[int]:
    m = re.match(r"^[<>=|]?[a-zA-Z](\d+)$", s)
    return int(m.group(1)) if m else None


def _calcsize(fmt: str) -> Optional[int]:
    try:
        return struct_mod.calcsize(fmt)
    except struct_mod.error:
        return None


def _rec_defs(project: Project) -> Dict[str, Tuple[str, ...]]:
    """Module-level ``NAME = np.dtype([("f", "u1"), ...])`` -> field dtypes."""
    recs: Dict[str, Tuple[str, ...]] = {}
    for rel, sf in sorted(project.files.items()):
        for node in sf.tree.body:
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Call)
                    and dotted(node.value.func) in ("np.dtype", "numpy.dtype")
                    and node.value.args):
                continue
            fields = node.value.args[0]
            if not isinstance(fields, (ast.List, ast.Tuple)):
                continue
            dts = []
            for f in fields.elts:
                if (isinstance(f, ast.Tuple) and len(f.elts) >= 2
                        and isinstance(f.elts[1], ast.Constant)
                        and isinstance(f.elts[1].value, str)):
                    dts.append(f.elts[1].value)
            recs[node.targets[0].id] = tuple(dts)
    return recs


class _Codec:
    """One codec function's extracted wire-shape evidence."""

    def __init__(self, rel: str, qual: str, node: ast.AST):
        self.rel = rel
        self.qual = qual
        self.node = node
        self.tokens: List[str] = []     # fmt:… / dtype:… / rec:… / blob:…
        self.fmts: List[str] = []       # struct formats, source order
        self.offsets: List[Tuple[int, ast.AST]] = []  # decoder read offsets

    def boundaries(self) -> Optional[set]:
        """Cumulative byte boundaries of the struct-format layout."""
        out, acc = {0}, 0
        for fmt in self.fmts:
            size = _calcsize(fmt)
            if size is None:
                return None
            acc += size
            out.add(acc)
        return out


def _int_const(node: Optional[ast.expr]) -> Optional[int]:
    if (isinstance(node, ast.Constant) and isinstance(node.value, int)
            and not isinstance(node.value, bool)):
        return node.value
    return None


def _extract(rel: str, qual: str, node: ast.AST,
             recs: Dict[str, Tuple[str, ...]]) -> _Codec:
    c = _Codec(rel, qual, node)
    for n in walk_in_order(node):
        if isinstance(n, ast.Subscript):
            sl = n.slice
            if (isinstance(sl, ast.Slice) and sl.upper is None
                    and sl.step is None):
                k = _int_const(sl.lower)
                if k is not None:
                    c.offsets.append((k, n))
            continue
        if not isinstance(n, ast.Call):
            continue
        callee = dotted(n.func) or ""
        bare = callee.split(".")[-1]
        if callee in _STRUCT_CALLS and n.args and isinstance(
                n.args[0], ast.Constant) and isinstance(n.args[0].value, str):
            fmt = n.args[0].value
            c.fmts.append(fmt)
            c.tokens.append(f"fmt:{fmt}")
            if bare == "unpack_from":
                k = _int_const(n.args[2]) if len(n.args) > 2 else None
                if k is None:
                    for kw in n.keywords:
                        if kw.arg == "offset":
                            k = _int_const(kw.value)
                if k is not None:
                    c.offsets.append((k, n))
            continue
        if bare.startswith(("pack_", "unpack_")):
            c.tokens.append(
                "blob:" + bare.split("_", 1)[1])
            continue
        if bare in _DTYPE_SINKS:
            for arg in list(n.args) + [kw.value for kw in n.keywords]:
                if (isinstance(arg, ast.Constant)
                        and isinstance(arg.value, str)
                        and _DTYPE_RE.match(arg.value)):
                    c.tokens.append(f"dtype:{arg.value}")
                elif isinstance(arg, ast.Name) and arg.id in recs:
                    c.tokens.append(
                        "rec[" + ",".join(recs[arg.id]) + "]")
            if bare == "frombuffer":
                for kw in n.keywords:
                    if kw.arg == "offset":
                        k = _int_const(kw.value)
                        if k is not None:
                            c.offsets.append((k, n))
    return c


def _find_codec(project: Project, name: str,
                recs) -> Optional[_Codec]:
    for rel, sf in sorted(project.files.items()):
        for qual, node in iter_functions(sf.tree):
            if qual.split(".")[-1] == name and isinstance(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return _extract(rel, qual, node, recs)
    return None


@register(
    RULE, "wire-consistency",
    "Sender encoders and receiver decoders must agree on struct formats, "
    "dtypes, record layouts, and fixed payload offsets; accounting "
    "constants must match the layouts they describe.",
)
def check(project: Project) -> Iterable[Finding]:
    recs = _rec_defs(project)
    findings: List[Finding] = []

    for enc_name, dec_name, check_offsets in CODEC_PAIRS:
        enc = _find_codec(project, enc_name, recs)
        dec = _find_codec(project, dec_name, recs)
        if enc is None and dec is None:
            continue
        if enc is None or dec is None:
            have = enc or dec
            missing = dec_name if dec is None else enc_name
            findings.append(Finding(
                rule=RULE, path=have.rel, line=have.node.lineno,
                col=have.node.col_offset, context=have.qual,
                message=(f"codec `{have.qual}` has no `{missing}` "
                         f"counterpart in the sweep: inline or missing "
                         f"{'decoders' if dec is None else 'encoders'} "
                         f"drift from the wire layout -- define the pair "
                         f"side by side")))
            continue

        if sorted(enc.tokens) != sorted(dec.tokens):
            enc_only = _diff(enc.tokens, dec.tokens)
            dec_only = _diff(dec.tokens, enc.tokens)
            findings.append(Finding(
                rule=RULE, path=dec.rel, line=dec.node.lineno,
                col=dec.node.col_offset, context=dec.qual,
                message=(f"wire layout mismatch between `{enc.qual}` and "
                         f"`{dec.qual}`: encoder-only {enc_only or '[]'}, "
                         f"decoder-only {dec_only or '[]'}")))

        if check_offsets:
            bounds = enc.boundaries()
            if bounds is not None:
                for k, n in dec.offsets:
                    if k not in bounds:
                        findings.append(Finding(
                            rule=RULE, path=dec.rel, line=n.lineno,
                            col=n.col_offset, context=dec.qual,
                            message=(f"`{dec.qual}` reads at fixed offset "
                                     f"{k}, but `{enc.qual}`'s struct "
                                     f"layout has boundaries "
                                     f"{sorted(bounds)}")))

    findings.extend(_constant_contracts(project, recs))
    return findings


def _diff(a: List[str], b: List[str]) -> List[str]:
    out = list(a)
    for t in b:
        if t in out:
            out.remove(t)
    return sorted(set(out))


def _num_consts(sf) -> Dict[str, Tuple[float, int]]:
    out = {}
    for node in sf.tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, (int, float))
                and not isinstance(node.value.value, bool)):
            out[node.targets[0].id] = (float(node.value.value), node.lineno)
    return out


def _constant_contracts(project: Project, recs) -> List[Finding]:
    findings: List[Finding] = []
    for rel, sf in sorted(project.files.items()):
        consts = _num_consts(sf)
        for const_name, rec_name in CONST_REC_CONTRACTS:
            if const_name not in consts or rec_name not in recs:
                continue
            value, line = consts[const_name]
            sizes = [_dtype_size(d) for d in recs[rec_name]]
            if any(s is None for s in sizes):
                continue
            width = sum(sizes)
            if value != width:
                findings.append(Finding(
                    rule=RULE, path=rel, line=line, col=0,
                    message=(f"`{const_name}` is {value:g} but record "
                             f"layout `{rec_name}` is {width} bytes wide: "
                             f"wire accounting diverges from the bytes")))
        for const_name, enc_name in CONST_HEADER_CONTRACTS:
            if const_name not in consts:
                continue
            enc = _find_codec(project, enc_name, recs)
            if enc is None or not enc.fmts:
                continue
            width = _calcsize(enc.fmts[-1])
            if width is None:
                continue
            value, line = consts[const_name]
            if value != width:
                findings.append(Finding(
                    rule=RULE, path=rel, line=line, col=0,
                    message=(f"`{const_name}` is {value:g} but "
                             f"`{enc.qual}`'s header format "
                             f"`{enc.fmts[-1]}` is {width} bytes: wire "
                             f"accounting diverges from the bytes")))
    return findings
