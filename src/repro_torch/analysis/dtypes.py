"""FLC005 — dtype-hazard lint for transform and kernel code; the
counterpart of ``src/repro/analysis/dtypes.py``.

Scope (see ``rules.py``): ``src/repro_torch/{core,kernels,serving}/``.
The delta-transform stack and the CUDA cells' wrappers are the numerically
load-bearing device code: quantization grids, DP noise scales, mask
cancellation and kernel-vs-reference parity are pinned at float32
tolerance, so a silent precision change breaks real guarantees.  Host-side
numpy fp64 (metric accumulators, the event clock) is fine and NOT flagged:
the rules target torch tensors only.

Flagged constructs:

* ``torch.float64`` / ``torch.double`` (as a dtype anywhere, e.g.
  ``dtype=torch.double``), ``.double()``, or ``dtype="float64"`` in a
  ``torch.*`` call: fp64 on the device path runs at 1/64 of the H100's
  fp32 rate and doubles the bytes the latency model charges.
* arithmetic directly on a narrowing integer cast (``.to(torch.int8) +
  ...``, ``.char()``, ``.byte()``, ``.short()``): int8 wraps at +-127;
  quantized-delta math accumulates in int32 / float and casts at the wire.

The reference's third rule (a narrowing cast feeding a contraction without
``preferred_element_type``) has no torch counterpart: torch's products of
bf16 operands accumulate in fp32 and ``mm(out_dtype=)`` is explicit.
"""
from __future__ import annotations

import ast
from typing import List, Optional

from repro_torch.analysis.rules import Finding, Suppressions

__all__ = ["check_source"]

_FP64 = frozenset({"float64", "double", "f8"})
_NARROW_INTS = frozenset({"int8", "uint8", "int16", "uint16", "short"})
_NARROW_METHODS = frozenset({"char", "byte", "short"})


def _dotted(node: ast.AST) -> Optional[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _dtype_token(node: ast.AST) -> Optional[str]:
    """'torch.float64' -> 'float64', "int8" -> 'int8', else None."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    name = _dotted(node)
    if name and "." in name:
        mod, last = name.rsplit(".", 1)
        if mod == "torch":
            return last
    return None


def _is_narrow_int_cast(node: ast.AST) -> bool:
    """x.to(torch.int8) / x.char() / torch.zeros(..., dtype=torch.int8)."""
    if not isinstance(node, ast.Call):
        return False
    if isinstance(node.func, ast.Attribute) and \
            node.func.attr in _NARROW_METHODS and not node.args:
        return True
    name = _dotted(node.func) or ""
    last = name.rsplit(".", 1)[-1] if name else getattr(node.func, "attr", "")
    if last in ("to", "type", "as_tensor", "tensor", "full", "zeros",
                "ones", "empty"):
        args = node.args + [kw.value for kw in node.keywords]
        return any(_dtype_token(a) in _NARROW_INTS for a in args)
    return False


class _Lint(ast.NodeVisitor):
    def __init__(self, rel: str, sup: Suppressions):
        self.rel, self.sup = rel, sup
        self.findings: List[Finding] = []

    def _emit(self, line: int, msg: str) -> None:
        self.findings.append(self.sup.apply("FLC005", self.rel, line, msg))

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if _dotted(node) in ("torch.float64", "torch.double"):
            self._emit(node.lineno,
                       f"{_dotted(node)} on the device path — fp64 runs at "
                       "a fraction of the fp32 rate and doubles the wire "
                       "bytes; use explicit float32")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr == "double" and not node.args:
            self._emit(node.lineno,
                       ".double() on the device path — promotes to fp64; "
                       "stay in float32")
        name = _dotted(node.func) or ""
        if name.startswith("torch."):
            for kw in node.keywords:
                if kw.arg == "dtype" and isinstance(kw.value, ast.Constant) \
                        and _dtype_token(kw.value) in _FP64:
                    self._emit(node.lineno,
                               f"dtype={kw.value.value!r} in {name}() — "
                               "device code stays float32")
        self.generic_visit(node)

    def visit_BinOp(self, node: ast.BinOp) -> None:
        if isinstance(node.op, (ast.Add, ast.Sub, ast.Mult)) and (
                _is_narrow_int_cast(node.left)
                or _is_narrow_int_cast(node.right)):
            self._emit(node.lineno,
                       "arithmetic on a narrowing int cast — int8/int16 "
                       "wrap silently; accumulate in int32/float and cast "
                       "at the wire boundary")
        self.generic_visit(node)


def check_source(source: str, rel: str) -> List[Finding]:
    """Run the dtype-hazard rule over one module's source."""
    tree = ast.parse(source)
    lint = _Lint(rel, Suppressions(source))
    lint.visit(tree)
    return lint.findings
