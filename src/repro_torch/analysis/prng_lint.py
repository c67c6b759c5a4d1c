"""PRNG-hygiene AST lint: FLC001 (raw literal keys and seeds), FLC002 (key
reuse), FLC003 (arithmetic seed derivation); the counterpart of
``src/repro/analysis/prng_lint.py`` for the port's idioms.

Every random draw of the engine (client selection, transform noise,
stochastic rounding, pairwise masks, straggler / churn schedules) is a
pure function of ``(FLConfig.seed, round, slot, attempt)`` so runs replay
and checkpoints resume bit for bit.  The port draws its keyed bits from
``core/prng.py`` (threefry keys as ``jax.random`` makes them) and its
initial weights from a seeded ``torch.Generator``.  The failure modes:

* **FLC001** ``prng.PRNGKey(0)``, ``torch.manual_seed(0)`` or
  ``torch.Generator().manual_seed(0)``: a literal forks a root stream that
  ignores the config seed, shared by every run and colliding with any other
  literal stream.
* **FLC002** one key fed to two of ``prng.uniform`` / ``normal`` / ``bits``
  / ``randint`` yields perfectly correlated draws; ``fold_in`` / ``split``
  first.
* **FLC003** ``PRNGKey(seed + cid)``, ``seeded_generator(seed + cid)`` or
  ``manual_seed(seed + cid)`` collide across configs: ``(seed=0, cid=1)``
  and ``(seed=1, cid=0)`` are one stream.  ``prng.fold_in(PRNGKey(seed),
  cid)``, ``seeded_generator(seed, cid)`` and ``SeedSequence([seed, cid])``
  mix injectively.

All checks are flow-light heuristics over the AST; findings carry inline
``# flcheck: disable=CODE (reason)`` suppressions (see ``rules.py``).
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional

from repro_torch.analysis.rules import Finding, Suppressions

__all__ = ["check_source"]

# core/prng.py samplers that CONSUME a key (fold_in / split derive)
_CONSUMERS = frozenset({"uniform", "normal", "bits", "randint"})
_KEY_MAKERS = frozenset({"PRNGKey"})
_SEEDERS = frozenset({"manual_seed", "manual_seed_all"})
_SEEDED_CTORS = frozenset({"default_rng", "SeedSequence", "seeded_generator"})


def _dotted(node: ast.AST) -> Optional[str]:
    """'prng.normal' for an Attribute chain, 'hash' for a Name."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _last(func: ast.AST) -> str:
    """The called name: ``manual_seed`` for ``torch.Generator().manual_seed``
    (whose receiver is a call, not a dotted name)."""
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


def _is_consumer(call: ast.Call) -> bool:
    name = _dotted(call.func)
    if name is None or "." not in name:
        return False
    mod, last = name.rsplit(".", 1)
    return last in _CONSUMERS and (mod == "prng" or mod.endswith(".prng"))


def _is_arith(node: ast.AST) -> bool:
    return isinstance(node, ast.BinOp) and isinstance(
        node.op, (ast.Add, ast.Sub, ast.Mult, ast.FloorDiv, ast.Mod,
                  ast.BitXor, ast.BitOr, ast.LShift))


class _Lint(ast.NodeVisitor):
    def __init__(self, rel: str, sup: Suppressions):
        self.rel, self.sup = rel, sup
        self.findings: List[Finding] = []

    def _emit(self, code: str, line: int, msg: str) -> None:
        self.findings.append(self.sup.apply(code, self.rel, line, msg))

    # ---------------------------------------------- FLC001 / FLC003 (calls)
    def visit_Call(self, node: ast.Call) -> None:
        last = _last(node.func)
        arg0 = node.args[0] if node.args else None
        if last in _KEY_MAKERS | _SEEDERS and arg0 is not None:
            if isinstance(arg0, ast.Constant):
                self._emit(
                    "FLC001", node.lineno,
                    f"raw {last}({arg0.value!r}) — derive from the config "
                    "seed (prng.fold_in, seeded_generator(seed, ...)) or "
                    "suppress with a rationale")
            elif _is_arith(arg0):
                self._emit(
                    "FLC003", node.lineno,
                    f"arithmetic seed fed to {last}(...) — (seed, i) pairs "
                    "collide under +/-; use prng.fold_in(PRNGKey(seed), i)"
                    " or seeded_generator(seed, i)")
        elif last in _SEEDED_CTORS and arg0 is not None and _is_arith(arg0):
            self._emit(
                "FLC003", node.lineno,
                f"arithmetic seed fed to {last}(...) — pass the parts "
                "instead (seeded_generator(seed, i), SeedSequence([seed, "
                "i])): injective mixing")
        self.generic_visit(node)

    # ------------------------------------------------------ FLC002 (reuse)
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._scan_block(node.body, {})
        # nested defs get their own fresh scan via generic_visit recursion
        self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef

    def _assigned_names(self, node: ast.AST) -> List[str]:
        return [n.id for n in ast.walk(node)
                if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store)]

    def _consumes_in(self, node: ast.AST):
        """(line, key_name) for every key-consuming prng call in ``node``
        whose key is a plain name."""
        out = []
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call) and _is_consumer(sub) and sub.args \
                    and isinstance(sub.args[0], ast.Name):
                out.append((sub.lineno, sub.args[0].id))
        return out

    def _scan_block(self, stmts: List[ast.stmt], consumed: Dict[str, int]):
        """Straight-line key-reuse scan: ``consumed`` maps key name -> line
        of its (only allowed) consumption; any rebind clears it.  Compound
        statements are scanned with a copy of the state (branches cannot
        alias each other) and forget it afterwards, except loops, which get
        the cross-iteration check below."""
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                continue  # separate scope; visited independently
            if isinstance(st, (ast.For, ast.While)):
                self._check_loop_reuse(st)
                for body in (st.body, st.orelse):
                    self._scan_block(body, dict(consumed))
                for name in self._assigned_names(st):
                    consumed.pop(name, None)
                continue
            if isinstance(st, (ast.If, ast.Try, ast.With)):
                for body in [getattr(st, "body", [])] + \
                        [h.body for h in getattr(st, "handlers", [])] + \
                        [getattr(st, "orelse", []),
                         getattr(st, "finalbody", [])]:
                    self._scan_block(body, dict(consumed))
                for name in self._assigned_names(st):
                    consumed.pop(name, None)
                continue
            comp_targets = {
                n for sub in ast.walk(st)
                if isinstance(sub, (ast.ListComp, ast.SetComp, ast.DictComp,
                                    ast.GeneratorExp))
                for gen in sub.generators
                for n in self._assigned_names(gen.target)}
            for line, key in self._consumes_in(st):
                if key in comp_targets:
                    continue
                if key in consumed:
                    self._emit(
                        "FLC002", line,
                        f"key {key!r} already consumed at line "
                        f"{consumed[key]} — fold_in/split before drawing "
                        "again (reused keys give identical bits)")
                else:
                    consumed[key] = line
            for name in self._assigned_names(st):
                consumed.pop(name, None)

    def _check_loop_reuse(self, loop: ast.stmt) -> None:
        """A key consumed inside a loop body without being (re)assigned in
        that body is the same bits every iteration."""
        assigned = set(self._assigned_names(loop))
        for line, key in self._consumes_in(loop):
            if key not in assigned:
                self._emit(
                    "FLC002", line,
                    f"key {key!r} consumed inside a loop without a "
                    "per-iteration fold_in/split — every iteration draws "
                    "the same bits")


def check_source(source: str, rel: str) -> List[Finding]:
    """Run the PRNG-hygiene rules over one module's source."""
    tree = ast.parse(source)
    lint = _Lint(rel, Suppressions(source))
    lint.visit(tree)
    return lint.findings
