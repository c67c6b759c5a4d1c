"""FLC006-FLC009 — serving-tier concurrency lint; the counterpart of
``src/repro/analysis/concurrency.py``.

Scope (see ``rules.py``): ``src/repro_torch/serving/`` only.  The serving tier is
the one part of the repo written for a MULTI-THREADED front (the ROADMAP's
serving item): a registry that hot-swaps model handles under readers, an
engine that batches concurrent forecast requests, consumer caches that grow
with traffic.  The rest of the repo is single-threaded simulation, so these
rules do not fire there.

The rules are lexical heuristics, deliberately conservative:

``FLC006`` (locked-class unlocked mutation)
    In a class that OWNS a lock (``self.x = threading.Lock()/RLock()/
    Condition()``), any mutation of shared container state initialized in
    ``__init__`` (keyed assign, mutating method call, rebinding) outside a
    ``with self.<lock>:`` block.  A class that takes a lock for SOME writes
    has declared its state shared; the unlocked write is the bug.
``FLC007`` (non-atomic handle fetch / TOCTOU)
    Two ``.handle(<same slot>)`` fetches on the same receiver in one
    function, or a ``.generation(...)`` probe followed by ``.handle(...)``
    — the registry can hot-swap between the two calls, so decisions made on
    the first fetch do not hold for the second.  Fetch ONE snapshot and
    read everything off it.
``FLC008`` (unbounded cache growth)
    A mapping attribute with keyed inserts (``self.m[k] = v`` /
    ``.setdefault`` / ``.update``) but no eviction (``.pop/.popitem/
    .clear`` / ``del``) and no size check (``len(...)`` over the attr)
    anywhere in the class: per-key state that only ever grows leaks under
    real traffic.  Bounded caches evict; if growth is intentionally
    unbounded (e.g. a fixed slot universe), suppress with the rationale.
``FLC009`` (Python branch on a tensor result)
    ``if``/``while`` whose test calls ``torch.*`` (a tensor result): its
    truth value is read from the device, a sync per request in eager
    serving code; use ``torch.where`` or hoist an explicit host read
    (``.item()``) out of the request path.  ``torch.is_*``, ``torch.cuda``,
    ``torch.backends`` and ``torch.distributed`` answer on the host and are
    not flagged.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.rules import Finding, Suppressions

__all__ = ["check_source"]

_LOCK_CTORS = {"threading.Lock", "threading.RLock", "threading.Condition"}
_CONTAINER_CTORS = {"dict", "list", "set", "collections.OrderedDict",
                    "OrderedDict", "collections.defaultdict", "defaultdict",
                    "collections.deque", "deque"}
_MUTATORS = {"setdefault", "update", "pop", "popitem", "clear", "append",
             "extend", "add", "remove", "discard", "insert", "appendleft"}
# torch calls that answer on the host (no tensor result, no sync)
_HOST_TORCH = ("torch.is_", "torch.cuda.", "torch.backends.",
               "torch.distributed.", "torch.device", "torch.Size",
               "torch.get_", "torch.are_")
_INSERTERS = {"setdefault", "update"}          # keyed growth (FLC008)
_EVICTORS = {"pop", "popitem", "clear"}        # keyed shrink (FLC008)


def _dotted(node: ast.AST) -> Optional[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _self_attr(node: ast.AST) -> Optional[str]:
    """``self.<name>`` -> ``name`` (else None)."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _is_mapping_ctor(node: ast.AST) -> bool:
    if isinstance(node, ast.Dict):
        return True
    if isinstance(node, ast.Call):
        return _dotted(node.func) in ("dict", "collections.OrderedDict",
                                      "OrderedDict", "collections.defaultdict",
                                      "defaultdict")
    return False


def _is_container_ctor(node: ast.AST) -> bool:
    if isinstance(node, (ast.Dict, ast.List, ast.Set)):
        return True
    if isinstance(node, ast.Call):
        return _dotted(node.func) in _CONTAINER_CTORS
    return False


class _ClassInfo:
    """First-pass facts about one class body."""

    def __init__(self) -> None:
        self.locks: Set[str] = set()          # lock-valued self attrs
        self.containers: Set[str] = set()     # container attrs set in init
        self.mappings: Set[str] = set()       # dict-valued subset
        # FLC008 bookkeeping (whole-class):
        self.inserts: Dict[str, int] = {}     # attr -> first insert line
        self.evicts: Set[str] = set()         # attrs with any evict/len/del


def _scan_class(cls: ast.ClassDef) -> _ClassInfo:
    info = _ClassInfo()
    for node in ast.walk(cls):
        # both plain and annotated attribute assignments declare state
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            attr, value = _self_attr(node.targets[0]), node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            attr, value = _self_attr(node.target), node.value
        else:
            continue
        if attr:
            if isinstance(value, ast.Call) and \
                    _dotted(value.func) in _LOCK_CTORS:
                info.locks.add(attr)
            elif _is_container_ctor(value):
                info.containers.add(attr)
                if _is_mapping_ctor(value):
                    info.mappings.add(attr)
    for node in ast.walk(cls):
        # keyed insert: self.m[k] = v  |  self.m.setdefault/update(...)
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Subscript):
                    attr = _self_attr(tgt.value)
                    if attr in info.mappings:
                        info.inserts.setdefault(attr, node.lineno)
        elif isinstance(node, ast.Call):
            if isinstance(node.func, ast.Attribute):
                attr = _self_attr(node.func.value)
                if attr in info.mappings:
                    if node.func.attr in _INSERTERS:
                        info.inserts.setdefault(attr, node.lineno)
                    elif node.func.attr in _EVICTORS:
                        info.evicts.add(attr)
            elif isinstance(node.func, ast.Name) and node.func.id == "len":
                # any len() whose argument mentions the attr counts as a
                # size check (len(self.m) or len(self.m[k]) alike)
                for sub in ast.walk(node):
                    attr = _self_attr(sub)
                    if attr in info.mappings:
                        info.evicts.add(attr)
        elif isinstance(node, ast.Delete):
            for tgt in node.targets:
                base = tgt.value if isinstance(tgt, ast.Subscript) else tgt
                attr = _self_attr(base)
                if attr in info.mappings:
                    info.evicts.add(attr)
    return info


class _FuncLint(ast.NodeVisitor):
    """Per-function pass: FLC006 (lock discipline), FLC007 (TOCTOU),
    FLC009 (traced branch).  Tracks ``with self.<lock>:`` nesting."""

    def __init__(self, rel: str, sup: Suppressions, info: _ClassInfo,
                 in_init: bool, findings: List[Finding]):
        self.rel, self.sup, self.info = rel, sup, info
        self.in_init = in_init
        self.findings = findings
        self.lock_depth = 0
        # FLC007: (receiver, arg-src) -> first .handle line; receivers with
        # a .generation probe
        self.handle_seen: Dict[Tuple[str, str], int] = {}
        self.gen_probed: Dict[str, int] = {}

    def _emit(self, code: str, line: int, msg: str) -> None:
        self.findings.append(self.sup.apply(code, self.rel, line, msg))

    # --- lock tracking -------------------------------------------------
    def visit_With(self, node: ast.With) -> None:
        locked = any(_self_attr(item.context_expr) in self.info.locks
                     for item in node.items)
        if locked:
            self.lock_depth += 1
        self.generic_visit(node)
        if locked:
            self.lock_depth -= 1

    def _unlocked_mutation(self, attr: Optional[str], line: int,
                           what: str) -> None:
        if (attr in self.info.containers and self.info.locks
                and self.lock_depth == 0 and not self.in_init):
            self._emit("FLC006", line,
                       f"unlocked {what} of shared 'self.{attr}' in a class "
                       f"that guards state with "
                       f"'self.{sorted(self.info.locks)[0]}' — wrap the "
                       "mutation in 'with self."
                       f"{sorted(self.info.locks)[0]}:' or document why "
                       "this write races safely")

    def visit_Assign(self, node: ast.Assign) -> None:
        for tgt in node.targets:
            if isinstance(tgt, ast.Subscript):
                self._unlocked_mutation(_self_attr(tgt.value), node.lineno,
                                        "keyed assignment")
            else:
                attr = _self_attr(tgt)
                if attr in self.info.containers:
                    self._unlocked_mutation(attr, node.lineno, "rebinding")
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        tgt = node.target
        base = tgt.value if isinstance(tgt, ast.Subscript) else tgt
        self._unlocked_mutation(_self_attr(base), node.lineno,
                                "augmented assignment")
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        for tgt in node.targets:
            base = tgt.value if isinstance(tgt, ast.Subscript) else tgt
            self._unlocked_mutation(_self_attr(base), node.lineno, "delete")
        self.generic_visit(node)

    # --- calls: FLC006 mutators + FLC007 handle fetches ----------------
    def visit_Call(self, node: ast.Call) -> None:
        if isinstance(node.func, ast.Attribute):
            recv = _dotted(node.func.value)
            if node.func.attr in _MUTATORS:
                self._unlocked_mutation(_self_attr(node.func.value),
                                        node.lineno,
                                        f".{node.func.attr}() mutation")
            if recv is not None and node.func.attr == "handle":
                arg = ast.unparse(node.args[0]) if node.args else "()"
                key = (recv, arg)
                if key in self.handle_seen:
                    self._emit(
                        "FLC007", node.lineno,
                        f"second {recv}.handle({arg}) fetch in one function "
                        f"(first at line {self.handle_seen[key]}) — the "
                        "registry can hot-swap between fetches; take ONE "
                        "handle snapshot and reuse it")
                else:
                    self.handle_seen[key] = node.lineno
                    if recv in self.gen_probed:
                        self._emit(
                            "FLC007", node.lineno,
                            f"{recv}.handle({arg}) after a "
                            f"{recv}.generation(...) probe (line "
                            f"{self.gen_probed[recv]}) — check-then-fetch "
                            "races a hot swap; fetch the handle and read "
                            ".generation off the snapshot")
            if recv is not None and node.func.attr == "generation":
                self.gen_probed.setdefault(recv, node.lineno)
        self.generic_visit(node)

    # --- FLC009: Python branch on a tensor result ----------------------
    def _traced_test(self, test: ast.AST) -> Optional[str]:
        for sub in ast.walk(test):
            if isinstance(sub, ast.Call):
                name = _dotted(sub.func)
                if name and name.startswith("torch.") and \
                        not name.startswith(_HOST_TORCH):
                    return name
        return None

    def visit_If(self, node: ast.If) -> None:
        name = self._traced_test(node.test)
        if name:
            self._emit("FLC009", node.lineno,
                       f"Python 'if' on a tensor result ({name}(...)) — "
                       "reads the device per request in eager serving "
                       "code; use torch.where or hoist an explicit host "
                       "read")
        self.generic_visit(node)

    def visit_While(self, node: ast.While) -> None:
        name = self._traced_test(node.test)
        if name:
            self._emit("FLC009", node.lineno,
                       f"Python 'while' on a tensor result ({name}(...)) "
                       "— a device sync every iteration; bound the loop on "
                       "the host or hoist an explicit host read")
        self.generic_visit(node)


def check_source(source: str, rel: str) -> List[Finding]:
    """Run the serving-concurrency rules over one module's source."""
    tree = ast.parse(source)
    sup = Suppressions(source)
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        info = _scan_class(node)
        for item in node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                lint = _FuncLint(rel, sup, info,
                                 in_init=item.name == "__init__",
                                 findings=findings)
                lint.visit(item)
        # FLC008: grow-only mappings (whole-class view)
        for attr, line in sorted(info.inserts.items()):
            if attr not in info.evicts:
                findings.append(sup.apply(
                    "FLC008", rel, line,
                    f"'self.{attr}' grows per key with no eviction or size "
                    "check anywhere in the class — per-key serving state "
                    "leaks under real traffic; bound it (evict/len) or "
                    "suppress with the rationale for unbounded growth"))
    # module-level FLC009 (functions outside classes)
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            lint = _FuncLint(rel, sup, _ClassInfo(), in_init=False,
                             findings=findings)
            lint.visit(node)
    return findings
