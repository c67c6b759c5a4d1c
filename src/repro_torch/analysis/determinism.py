"""FLC004 — nondeterminism lint for replay-critical code; the counterpart
of ``src/repro/analysis/determinism.py``.

Scope (see ``rules.py``): ``src/repro_torch/{core,data,serving}/``.
Everything the round engine does must be a pure function of
``(FLConfig.seed, round, slot, attempt)`` — the event clock, churn draws,
transform keys and sampler streams all replay bit-identically under a fixed
seed, and checkpoint/resume depends on it (tests/test_torch_async.py pins
a kill-and-resume run bit-identical).  Wall-clock reads, global rng state,
torch's global generator, Python's salted ``hash`` and unordered-set
iteration all silently break that.  ``launch/`` and the drivers
legitimately measure wall-clock time, so the rule does not apply there.

Flagged constructs:

* ``time.time()`` / ``time.monotonic()`` / ``datetime.now()`` — simulated
  rounds must use the event clock (``core/latency.py``); host-side timing
  belongs in launch/bench code (and should be ``perf_counter`` there).
* global numpy rng (``np.random.rand`` etc.) and stdlib ``random.*`` —
  hidden shared state; use ``np.random.default_rng(SeedSequence([...]))``.
* torch's global generator: ``torch.rand`` / ``rand_like`` / ``randn`` /
  ``randn_like`` / ``randint`` / ``randint_like`` / ``randperm`` /
  ``normal`` / ``bernoulli`` / ``multinomial``, and the in-place
  ``normal_`` / ``uniform_`` / ``bernoulli_`` / ``exponential_`` /
  ``random_``, called without ``generator=`` — the draw depends on whatever
  ran before it in the process; pass a seeded ``torch.Generator``
  (``seeded_generator(seed, ...)``) or draw from ``core/prng.py``.
* builtin ``hash()`` — salted per process (PYTHONHASHSEED).
* ``for ... in set(...)`` / set literals — iteration order is unspecified;
  feeding it into arrays reorders results across runs.
"""
from __future__ import annotations

import ast
from typing import List, Optional

from repro_torch.analysis.rules import Finding, Suppressions

__all__ = ["check_source"]

_WALLCLOCK = {"time.time", "time.monotonic", "time.monotonic_ns",
              "time.time_ns", "datetime.now", "datetime.utcnow",
              "datetime.datetime.now", "datetime.datetime.utcnow"}
# numpy legacy global-state samplers (module-level np.random.*); the
# Generator API (default_rng / SeedSequence) is the sanctioned replacement
_NP_GLOBAL = frozenset({
    "seed", "rand", "randn", "random", "randint", "random_sample",
    "ranf", "sample", "normal", "uniform", "choice", "shuffle",
    "permutation", "standard_normal", "poisson", "beta", "gamma",
    "binomial", "exponential", "lognormal", "pareto",
})
# torch samplers that draw from the global generator unless given one
_TORCH_SAMPLERS = frozenset({
    "rand", "rand_like", "randn", "randn_like", "randint", "randint_like",
    "randperm", "normal", "bernoulli", "multinomial", "poisson",
})
_INPLACE_SAMPLERS = frozenset({
    "normal_", "uniform_", "bernoulli_", "exponential_", "random_",
    "cauchy_", "log_normal_", "geometric_",
})
_STDLIB_RANDOM = frozenset({
    "random", "randint", "seed", "choice", "choices", "shuffle", "uniform",
    "gauss", "sample", "randrange", "betavariate", "expovariate",
    "normalvariate",
})


def _dotted(node: ast.AST) -> Optional[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _has_generator(call: ast.Call) -> bool:
    return any(kw.arg == "generator" for kw in call.keywords)


class _Lint(ast.NodeVisitor):
    def __init__(self, rel: str, sup: Suppressions):
        self.rel, self.sup = rel, sup
        self.findings: List[Finding] = []
        self.has_stdlib_random = False

    def _emit(self, line: int, msg: str) -> None:
        self.findings.append(self.sup.apply("FLC004", self.rel, line, msg))

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            if alias.name == "random" and (alias.asname or "random") == \
                    "random":
                self.has_stdlib_random = True
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        self._inplace_sampler(node)
        name = _dotted(node.func)
        if name is not None:
            if name in _WALLCLOCK:
                self._emit(node.lineno,
                           f"wall-clock read {name}() in replay-critical "
                           "code — simulated rounds must use the event "
                           "clock (core/latency.py)")
            else:
                parts = name.split(".")
                if len(parts) >= 2 and parts[-2] == "random" and \
                        parts[0] in ("np", "numpy") and \
                        parts[-1] in _NP_GLOBAL:
                    self._emit(node.lineno,
                               f"global numpy rng {name}() — hidden shared "
                               "state; use np.random.default_rng("
                               "SeedSequence([seed, ...]))")
                elif parts[-1] in _TORCH_SAMPLERS and \
                        parts[0] == "torch" and not _has_generator(node):
                    self._emit(node.lineno,
                               f"{name}() without generator= draws from "
                               "torch's global generator — pass a seeded "
                               "torch.Generator or use core/prng.py")
                elif self.has_stdlib_random and len(parts) == 2 and \
                        parts[0] == "random" and parts[1] in _STDLIB_RANDOM:
                    self._emit(node.lineno,
                               f"stdlib {name}() draws from global state — "
                               "use a seeded np.random.Generator")
            if name == "hash":
                self._emit(node.lineno,
                           "builtin hash() is salted per process "
                           "(PYTHONHASHSEED) — use a stable digest "
                           "(hashlib) or integer tags")
        self.generic_visit(node)

    def _inplace_sampler(self, node: ast.Call) -> None:
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in _INPLACE_SAMPLERS and \
                not _has_generator(node):
            self._emit(node.lineno,
                       f".{node.func.attr}() without generator= draws from "
                       "torch's global generator — pass a seeded "
                       "torch.Generator")

    def visit_For(self, node: ast.For) -> None:
        it = node.iter
        is_set_call = (isinstance(it, ast.Call)
                       and _dotted(it.func) in ("set", "frozenset"))
        if is_set_call or isinstance(it, ast.Set):
            self._emit(node.lineno,
                       "iterating a set — order is unspecified and will "
                       "reorder anything array-shaped; sort first")
        self.generic_visit(node)


def check_source(source: str, rel: str) -> List[Finding]:
    """Run the determinism rule over one module's source."""
    tree = ast.parse(source)
    lint = _Lint(rel, Suppressions(source))
    lint.visit(tree)
    return lint.findings
