"""``flcheck`` for the port: static and dataflow analysis of the federated
pipeline's load-bearing invariants; the counterpart of
``src/repro/analysis/``.

Three levels:

* **Level 1 — dataflow taint** (``taint.py``): run the real round bodies
  under a ``TorchDispatchMode``, taint the per-client local models at their
  source, and prove that no tainted value reaches a boundary or a
  cross-rank collective without first flowing through every configured
  transform stage (clip -> noise -> quantize -> mask).  Plus the round's
  hot-path guards (``recompile.py``): no new kernel build, launch plan or
  CUDA graph capture per round, and no host read or device sync inside
  the round after warm-up.
* **Level 2 — AST lint** (``prng_lint.py``, ``determinism.py``,
  ``dtypes.py``, ``concurrency.py``): PRNG hygiene (raw literal keys and
  seeds, key reuse, arithmetic seed derivation), nondeterminism in
  ``core/`` / ``data/`` / ``serving/``, dtype hazards in ``core/`` /
  ``kernels/`` / ``serving/``, and serving-tier concurrency hazards
  (unlocked shared mutation, TOCTOU handle fetches, unbounded cache growth,
  Python branches on tensor results) in ``serving/``.  Rule catalog and
  inline suppression syntax: ``rules.py``.
* **Level 3 — wire-format and cost audit** (``costs.py``): read the
  declared wire encoding off every boundary crossing of the run round,
  derive exact per-client upload bytes and per-stage FLOP / byte totals,
  and gate them against ``baselines/round_costs.json``.

CLI: ``python -m repro_torch.analysis src/repro_torch`` or
``tools/flcheck_torch src/repro_torch``.

This package is import-light on purpose: ``repro_torch.core`` modules
import ``repro_torch.analysis.taint`` for the (production no-op) markers,
so nothing here imports ``repro_torch.core`` at module level.
"""
