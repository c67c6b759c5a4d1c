"""flcheck rule registry, findings, and inline suppression parsing; the
counterpart of ``src/repro/analysis/rules.py``.

Every lint rule has a stable ``FLCxxx`` code, a one-line summary, and a
*scope* — the repo-relative path prefixes it applies to (``()`` = everywhere
the linter is pointed).  Scoping is part of the rule, not the caller: the
determinism rule FLC004 is load-bearing in ``core/``/``data/`` (replayable
rounds, resumable checkpoints) but wall-clock timing in ``launch/`` and the
drivers is legitimate, so the rule simply does not fire there.

Suppression syntax (inline, same line or the line directly above)::

    t0 = time.time()  # flcheck: disable=FLC004 (driver timing, not round math)

The parenthesized rationale is REQUIRED: a ``disable`` without one does not
suppress — the finding stays fatal and carries a note asking for the reason.
Multiple codes: ``disable=FLC001,FLC003 (reason)``.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Tuple

__all__ = ["Rule", "Finding", "RULES", "Suppressions", "relpath"]


@dataclasses.dataclass(frozen=True)
class Rule:
    code: str
    name: str
    summary: str
    # repo-relative path prefixes the rule fires under; () = everywhere
    scope: Tuple[str, ...] = ()

    def in_scope(self, rel: str) -> bool:
        rel = rel.replace("\\", "/")
        return not self.scope or any(rel.startswith(p) for p in self.scope)


RULES: Dict[str, Rule] = {r.code: r for r in (
    Rule("FLC001", "raw-prng-key",
         "raw prng.PRNGKey(<literal>) or manual_seed(<literal>) outside "
         "whitelisted init/test code — derive keys from the config seed "
         "(prng.fold_in) so streams are replayable and never collide"),
    Rule("FLC002", "key-reuse",
         "the same PRNG key fed to two prng draws (uniform / normal / bits "
         "/ randint) without an intervening fold_in/split — the draws are "
         "perfectly correlated"),
    Rule("FLC003", "arithmetic-seed",
         "arithmetic seed derivation (seed + i style) feeding PRNGKey, "
         "seeded_generator or manual_seed: (seed, 1) and (seed+1, 0) "
         "collide — use fold_in, seeded_generator(seed, i) or "
         "SeedSequence([seed, i])"),
    Rule("FLC004", "nondeterminism",
         "nondeterministic construct in replay-critical code (wall clock, "
         "global numpy/stdlib rng state, torch's global generator — "
         "torch.rand*/randn/randint/randperm/normal_/bernoulli without "
         "generator= — builtin hash, unordered-set iteration) — rounds "
         "must be pure functions of (seed, round, slot, attempt)",
         scope=("src/repro_torch/core/", "src/repro_torch/data/",
                "src/repro_torch/serving/")),
    Rule("FLC005", "dtype-hazard",
         "dtype hazard (torch.float64 / .double() on the device path, "
         "arithmetic on a narrowing integer cast) in transform/kernel code",
         scope=("src/repro_torch/core/", "src/repro_torch/kernels/",
                "src/repro_torch/serving/")),
    Rule("FLC006", "unlocked-shared-mutation",
         "mutation of shared container state outside the class's own lock "
         "— a class that guards SOME writes with a threading lock has "
         "declared its state shared; the unlocked write is a race",
         scope=("src/repro_torch/serving/",)),
    Rule("FLC007", "non-atomic-handle-fetch",
         "two registry .handle() fetches (or a .generation() probe then a "
         ".handle() fetch) in one function — a hot swap between them "
         "invalidates the first look; take one handle snapshot (TOCTOU)",
         scope=("src/repro_torch/serving/",)),
    Rule("FLC008", "unbounded-cache-growth",
         "per-key mapping state that only ever grows (keyed inserts, no "
         "eviction or size check anywhere in the class) — leaks under real "
         "serving traffic; bound it or suppress with the rationale",
         scope=("src/repro_torch/serving/",)),
    Rule("FLC009", "python-branch-on-tensor",
         "Python if/while on a torch.* tensor result — reading the tensor's "
         "truth forces a device sync per request in eager serving code; "
         "use torch.where or an explicit, hoisted host read",
         scope=("src/repro_torch/serving/",)),
)}


@dataclasses.dataclass(frozen=True)
class Finding:
    code: str
    path: str                 # repo-relative
    line: int
    message: str
    suppressed: bool = False
    suppress_reason: str = ""

    def render(self) -> str:
        tag = " [suppressed: %s]" % self.suppress_reason if self.suppressed \
            else ""
        return f"{self.path}:{self.line}: {self.code} {self.message}{tag}"


_SUPPRESS_RE = re.compile(
    r"#\s*flcheck:\s*disable=([A-Z0-9,\s]+?)\s*(?:\(([^)]*)\))?\s*$")


class Suppressions:
    """Per-file map of line -> (codes, rationale) from inline comments.

    A finding at line L is suppressed when line L or line L-1 carries a
    matching ``# flcheck: disable=CODE (reason)`` comment WITH a non-empty
    rationale.  ``disable`` comments without a rationale are collected in
    ``missing_reason`` so the CLI can complain precisely.
    """

    def __init__(self, source: str):
        self.by_line: Dict[int, Tuple[List[str], str]] = {}
        self.missing_reason: List[int] = []
        for i, text in enumerate(source.splitlines(), start=1):
            m = _SUPPRESS_RE.search(text)
            if not m:
                continue
            codes = [c.strip() for c in m.group(1).split(",") if c.strip()]
            reason = (m.group(2) or "").strip()
            if not reason:
                self.missing_reason.append(i)
            self.by_line[i] = (codes, reason)

    def lookup(self, code: str, line: int) -> Tuple[bool, str]:
        for ln in (line, line - 1):
            entry = self.by_line.get(ln)
            if entry and code in entry[0] and entry[1]:
                return True, entry[1]
        return False, ""

    def apply(self, code: str, path: str, line: int, message: str) -> Finding:
        hit, reason = self.lookup(code, line)
        return Finding(code, path, line, message, suppressed=hit,
                       suppress_reason=reason)


def relpath(path: str, root: str) -> str:
    """Repo-relative, forward-slash path (rule scopes key off this)."""
    import os
    rel = os.path.relpath(os.path.abspath(path), os.path.abspath(root))
    return rel.replace("\\", "/")
