"""The port stands alone: no module of ``src/repro_torch/``, no
``examples/torch_*.py``, not ``tools/flcheck_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, so the port runs on a
machine that has neither."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted((REPO / "src" / "repro_torch").rglob("*.py")) + \
        sorted((REPO / "examples").glob("torch_*.py")) + \
        [REPO / "tools" / "flcheck_torch", REPO / "chip_smoke.py"]


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_sources_import_neither_jax_nor_repro():
    files = _port_files()
    assert len(files) > 10 and all(f.exists() for f in files)
    bad = [f"{f.relative_to(REPO)}: {root}" for f in files
           for root in _imported_roots(f) if root in FORBIDDEN]
    assert bad == []


def test_importing_the_serving_path_loads_no_jax():
    code = ("import sys, repro_torch.serving, repro_torch.launch.serve, "
            "repro_torch.launch.lm_steps, repro_torch.models.transformer, "
            "repro_torch.launch.train, repro_torch.core.fedavg, "
            "repro_torch.core.sarima, repro_torch.sharding, "
            "repro_torch.launch.dryrun, repro_torch.launch.costmodel, "
            "repro_torch.launch.roofline, repro_torch.launch.mesh, "
            "repro_torch.analysis.cli, repro_torch.analysis.costs, "
            "repro_torch.analysis.recompile, repro_torch.analysis.taint; "
            "import torch.distributed as dist; "
            "bad = [m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]; "
            "print(bad, dist.is_initialized()); "
            "sys.exit(1 if bad or dist.is_initialized() else 0)")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
