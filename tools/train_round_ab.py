#!/usr/bin/env python3
"""Compare the federated-training round of two versions of the port on one
card: ``launch/train.py`` with its defaults (100 CA buildings x 365 days,
all per round, B=64, E=1, lr 0.05, ew_mse beta 2) and the rounds cut to 3,
``chip_smoke.py``'s phase-6 main path, run against the port of each source
tree given, in the order given.

    python3 tools/train_round_ab.py build/parent . . build/parent

Each TREE is a checkout of the repository (for another commit, e.g. one
unpacked with ``git archive``); its ``src/repro_torch`` trains, each in a
process of its own, so its kernels build into its own ``build/``.  Prints,
per run, a line ``{"tree": ...}`` and then that run's own output, whose
last line is launch/train.py's JSON summary (wall seconds per round, local
steps, held-out accuracy, launches).  Needs one CUDA card.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

CHILD = """
import sys
sys.path[:0] = [{src!r}]
import torch
from repro_torch.kernels import ops
from repro_torch.launch import train
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
ops.build()
train.main(["--rounds", "3", "--seed", "0"])
"""


def main(trees):
    if not trees:
        sys.exit(__doc__)
    for tree in trees:
        src = Path(tree).resolve() / "src"
        if not (src / "repro_torch" / "__init__.py").exists():
            sys.exit(f"train_round_ab: {src / 'repro_torch'} not found")
        print(json.dumps({"tree": str(tree)}), flush=True)
        subprocess.run([sys.executable, "-c", CHILD.format(src=str(src))],
                       check=True, timeout=900)


if __name__ == "__main__":
    main(sys.argv[1:])
