"""``flcheck_torch`` command line: lint + taint + hot-path guards + cost
audit of the port; the counterpart of ``src/repro/analysis/cli.py``.

Usage (from the repo root)::

    tools/flcheck_torch src/repro_torch        # level-2 AST lint (no torch)
    tools/flcheck_torch --taint                # level-1 taint proofs
    tools/flcheck_torch --hot-path             # recompile + host-read guards
    tools/flcheck_torch --cost --baseline \
        src/repro_torch/analysis/baselines/round_costs.json  # level-3 gate
    tools/flcheck_torch --cost --update-baseline   # rewrite the baseline
    tools/flcheck_torch --all src/repro_torch  # everything
    tools/flcheck_torch --list-rules

The dynamic passes (``--taint``, ``--hot-path``, ``--cost``) run the real
round on the card; ``--device cpu`` runs them on the CPU, only when asked.
Without a card and without ``--device cpu`` they fail.  The mesh
topologies (flat over 8 ranks, hierarchical 2 x 4) run on 8 gloo ranks
that the pass spawns.

Exit status: 0 when every selected pass is clean (suppressed findings with a
rationale are clean; ``disable`` comments WITHOUT a rationale are fatal),
1 on any finding/violation, 2 on usage errors — including a missing or
Python-free lint target ('nothing to lint' is an error, not a pass).
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Iterable, List, Tuple

from repro_torch.analysis import concurrency, determinism, dtypes, prng_lint
from repro_torch.analysis.rules import RULES, Finding, Suppressions, relpath

_CHECKERS = (prng_lint.check_source, determinism.check_source,
             dtypes.check_source, concurrency.check_source)


def _iter_py(paths: Iterable[str]) -> Iterable[str]:
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
        else:
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(d for d in dirnames
                                     if d not in ("__pycache__", ".git"))
                for f in sorted(filenames):
                    if f.endswith(".py"):
                        yield os.path.join(dirpath, f)


def check_paths(paths: List[str]) -> List[str]:
    """Fatal path errors: a missing target, or a directory with no Python
    under it.  'nothing to lint' must never silently pass as 'clean' —
    a typo'd path would otherwise green-light CI."""
    errors = []
    for p in paths:
        if not os.path.exists(p):
            errors.append(f"flcheck: path does not exist: {p}")
        elif os.path.isfile(p) and not p.endswith(".py"):
            errors.append(f"flcheck: not a Python file: {p}")
        elif os.path.isdir(p) and not any(_iter_py([p])):
            errors.append(f"flcheck: no Python files under: {p}")
    return errors


def find_repo_root(start: str) -> str:
    """Nearest ancestor holding a ``.git`` or ``pyproject.toml`` (or, in a
    checkout without git metadata, ``src/repro_torch``) — rule scopes are
    keyed on repo-relative paths like ``src/repro_torch/core/``."""
    d = os.path.abspath(start)
    while True:
        if any(os.path.exists(os.path.join(d, m))
               for m in (".git", "pyproject.toml",
                         os.path.join("src", "repro_torch"))):
            return d
        parent = os.path.dirname(d)
        if parent == d:
            return os.path.abspath(start)
        d = parent


def lint_file(path: str, root: str) -> Tuple[List[Finding], List[str]]:
    """All level-2 findings for one file, plus fatal suppression-syntax
    errors (``disable`` without a rationale)."""
    with open(path, "r", encoding="utf-8") as f:
        source = f.read()
    rel = relpath(path, root)
    try:
        findings = [f for check in _CHECKERS for f in check(source, rel)]
    except SyntaxError as e:
        return [Finding("FLC000", rel, e.lineno or 0,
                        f"syntax error: {e.msg}")], []
    findings = [f for f in findings if RULES[f.code].in_scope(rel)]
    errors = [f"{rel}:{ln}: flcheck disable without a (rationale) — "
              "suppressions must say why"
              for ln in Suppressions(source).missing_reason]
    return findings, errors


def run_lint(paths: List[str], root: str, show_suppressed: bool = False
             ) -> int:
    n_files = 0
    fatal: List[str] = []
    suppressed: List[Finding] = []
    for path in _iter_py(paths):
        n_files += 1
        findings, errors = lint_file(path, root)
        fatal.extend(errors)
        for f in findings:
            if f.suppressed:
                suppressed.append(f)
            else:
                fatal.append(f.render())
    for line in fatal:
        print(line)
    if show_suppressed:
        for f in suppressed:
            print(f.render())
    print(f"flcheck lint: {n_files} files, {len(fatal)} findings, "
          f"{len(suppressed)} suppressed")
    return 1 if fatal else 0


def run_taint(quick: bool = False, device=None) -> int:
    """Prove sanitize-before-boundary on the real round bodies.

    The full transform + secure stack (clip 1.0, noise 0.5, the 8-bit ring
    quantizer, masking) must carry all four labels to every boundary; a
    clip-only config must carry ``clip``.  ``quick`` limits the proofs to
    the in-process topologies (local round, semi-sync dispatch); otherwise
    the flat and hierarchical rounds run on 8 spawned gloo ranks.
    """
    from repro_torch.analysis import taint

    full_t, secure, clip_t = taint.full_stack(), taint.secure(), \
        taint.clip_only()
    cases = [("vmap", full_t, secure), ("vmap", clip_t, None),
             ("semi_sync", full_t, secure)]
    reports = [(topo, taint.verify_pipeline(topo, t, s, device=device))
               for topo, t, s in cases]
    if not quick:
        mesh_cases = [("flat", full_t, secure), ("flat", clip_t, None),
                      ("hier", full_t, secure)]
        per_rank = taint.on_ranks(taint.mesh_proofs, taint.MESH_RANKS,
                                  mesh_cases, device)
        for i, (topo, _, _) in enumerate(mesh_cases):
            for r, reps in enumerate(per_rank):
                reports.append((f"{topo} rank {r}", reps[i]))
    rc = 0
    for label, report in reports:
        head = f"[{label}] required={sorted(report.required)}"
        if report.proved:
            print(f"flcheck taint OK {head}: sources={report.sources} "
                  f"tainted-crossings={report.checked}")
        else:
            rc = 1
            print(f"flcheck taint FAILED {head}:")
            print("  " + report.render().replace("\n", "\n  "))
    return rc


def resolve_baseline(arg: str, root: str) -> str:
    """Baseline path resolution: as given if it exists or is absolute,
    else relative to the repo root (CI passes the repo-relative path from
    any working directory)."""
    if os.path.isabs(arg) or os.path.exists(arg):
        return arg
    return os.path.join(root, arg)


def run_cost(root: str, baseline: str = None, update: bool = False,
             device=None) -> int:
    """Level-3 cost audit + baseline gate (see ``analysis/costs.py``).

    Always runs the fatal wire proof (quantize-on uploads must reach every
    boundary as int8-grid + fp32-scale on every traced path).  With
    ``--baseline``, diffs the fresh report against the committed JSON and
    fails on any wire-byte / boundary-dtype / stage-FLOP drift; with
    ``--update-baseline``, rewrites the JSON instead (do this ONLY in the
    same change that intentionally moved the cost).
    """
    import json

    from repro_torch.analysis import costs

    report = costs.cost_report(device=device)
    print(costs.render_summary(report))
    rc = 0
    for msg in costs.check_report(report):
        rc = 1
        print(f"flcheck cost FATAL: {msg}")
    path = resolve_baseline(baseline or costs.DEFAULT_BASELINE, root)
    if update:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            f.write(costs.canonical_json(report))
        print(f"flcheck cost: baseline written to {path}")
        return rc
    if baseline is not None:
        if not os.path.exists(path):
            print(f"flcheck cost FATAL: baseline not found: {path} "
                  "(generate it with --cost --update-baseline)")
            return 1
        with open(path, "r", encoding="utf-8") as f:
            base = json.load(f)
        errors, warnings = costs.diff_reports(base, report)
        for w in warnings:
            print(f"flcheck cost note: {w}")
        for e in errors:
            rc = 1
            print(f"flcheck cost DRIFT: {e}")
        if not errors:
            print(f"flcheck cost: report matches baseline {path}")
        else:
            print("flcheck cost: wire/FLOP drift against the committed "
                  "baseline — if the change is intentional, rerun with "
                  "--cost --update-baseline and commit the JSON")
    return rc


def run_hot_path(device=None) -> int:
    from repro_torch.analysis import recompile

    report, host_err, launches = recompile.check_round_hot_path(
        device=device)
    print("flcheck hot-path: " + report.render())
    rc = 0 if report.ok else 1
    if host_err is None:
        print("flcheck hot-path: host-read guard OK (no host read or sync "
              f"in the round after warm-up; {launches} kernel launches "
              "inside the guard)")
    else:
        rc = 1
        print("flcheck hot-path: host-read guard FAILED: " + host_err)
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="flcheck_torch",
        description="Static + dataflow analysis for the port's federated "
                    "pipeline")
    ap.add_argument("paths", nargs="*", help="files/dirs to lint "
                    "(default: src/repro_torch under the repo root)")
    ap.add_argument("--taint", action="store_true",
                    help="run the taint proofs on the round bodies")
    ap.add_argument("--quick-taint", action="store_true",
                    help="taint proofs of the in-process paths only")
    ap.add_argument("--hot-path", action="store_true",
                    help="run the recompile + host-read guards")
    ap.add_argument("--cost", action="store_true",
                    help="run the level-3 wire-format & cost audit")
    ap.add_argument("--baseline", metavar="JSON",
                    help="with --cost: diff the report against this "
                         "committed baseline and fail on drift")
    ap.add_argument("--update-baseline", action="store_true",
                    help="with --cost: rewrite the baseline JSON instead "
                         "of diffing")
    ap.add_argument("--all", action="store_true",
                    help="lint + taint + hot-path + cost audit")
    ap.add_argument("--no-lint", action="store_true",
                    help="skip the AST lint (with --taint/--hot-path)")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="also print suppressed findings with rationales")
    ap.add_argument("--device", default=None,
                    help="device of the dynamic passes (default: the CUDA "
                         "card; 'cpu' only when asked)")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule in RULES.values():
            scope = ", ".join(rule.scope) if rule.scope else "everywhere"
            print(f"{rule.code} {rule.name} [{scope}]\n    {rule.summary}")
        return 0

    if (args.baseline or args.update_baseline) and not args.cost:
        print("flcheck: --baseline/--update-baseline require --cost",
              file=sys.stderr)
        return 2

    root = find_repo_root(args.paths[0] if args.paths else os.getcwd())
    paths = args.paths or [os.path.join(root, "src", "repro_torch")]
    do_taint = args.taint or args.quick_taint or args.all
    do_hot = args.hot_path or args.all
    do_cost = args.cost or args.all
    do_lint = not args.no_lint or not (do_taint or do_hot or do_cost)

    if do_lint:
        path_errors = check_paths(paths)
        if path_errors:
            for e in path_errors:
                print(e, file=sys.stderr)
            return 2

    rc = 0
    if do_lint:
        rc |= run_lint(paths, root, show_suppressed=args.show_suppressed)
    if do_taint:
        rc |= run_taint(quick=args.quick_taint and not (args.taint
                                                        or args.all),
                        device=args.device)
    if do_cost:
        rc |= run_cost(root, baseline=args.baseline,
                       update=args.update_baseline, device=args.device)
    if do_hot:
        rc |= run_hot_path(device=args.device)
    return rc


if __name__ == "__main__":
    sys.exit(main())
