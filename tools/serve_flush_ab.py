#!/usr/bin/env python3
"""Compare the forecast-serving flush of two versions of the port on one
card: ``chip_smoke.py``'s phase 3 (the LSTM and the 2-layer GRU serving
2,048 requests, then one profiled full flush) run against the port of each
source tree given, in the order given.

    python3 tools/serve_flush_ab.py build/parent . . build/parent

Each TREE is a checkout of the repository (for another commit, e.g. one
unpacked with ``git archive``); its ``src/repro_torch`` serves, each in a
process of its own, so its kernels build into its own ``build/``.  The
phases and the profile are this checkout's ``chip_smoke.serve_slice``.
Prints, per run, a line ``{"tree": ...}`` and then that run's two
``"phase": "serve"`` lines (mean full-flush wall, launches per flush, the
flush's device busy share and activities).  Needs one CUDA card.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CHILD = """
import sys
sys.path[:0] = [{src!r}, {root!r}]
import torch
import chip_smoke
from repro_torch.configs.base import ForecasterConfig
from repro_torch.kernels import ops
torch.backends.cuda.matmul.allow_tf32 = False
ops.build()
for cfg in (ForecasterConfig(), ForecasterConfig(cell="gru", n_layers=2)):
    chip_smoke.serve_slice(cfg, 0)
"""


def main(trees):
    if not trees:
        sys.exit(__doc__)
    for tree in trees:
        src = Path(tree).resolve() / "src"
        if not (src / "repro_torch" / "__init__.py").exists():
            sys.exit(f"serve_flush_ab: {src / 'repro_torch'} not found")
        print(json.dumps({"tree": str(tree)}), flush=True)
        subprocess.run([sys.executable, "-c",
                        CHILD.format(src=str(src), root=str(ROOT))],
                       check=True, timeout=900)


if __name__ == "__main__":
    main(sys.argv[1:])
