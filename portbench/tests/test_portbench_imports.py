"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names; the reference loads nothing of the program."""
import json
import subprocess
import sys

from benchlib import harness

PRELUDE = f"""
import sys, json
sys.path[:0] = [{str(harness.BENCH)!r}, {str(harness.ROOT / 'src')!r}]
"""


def _modules(body):
    code = PRELUDE + body + "\nprint(json.dumps(sorted(sys.modules)))"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return {m.split(".")[0] for m in json.loads(out.stdout.splitlines()[-1])}


def test_a_run_loads_no_jax():
    tops = _modules("""
sys.path.insert(0, %r)
import _small
from benchlib import harness
for w in _small.workloads(with_open=True):
    out = _small.run(_small.ctx(w))
    assert harness.judge(out.checks)
assert not harness.forbidden_modules()
import importlib.util
spec = importlib.util.spec_from_file_location("pb_run", %r)
m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m)
""" % (str(harness.BENCH / "tests"), str(harness.BENCH / "run.py")))
    assert "repro_torch" in tops
    assert not tops & set(harness.FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    tops = _modules("""
from benchlib import harness, data, compare, arith, weights
harness.load_module(harness.BENCH / "configs" / "forecaster_ref.py", "r")
""")
    assert "torch" in tops
    assert not tops & (set(harness.FORBIDDEN) | {"repro_torch"})


def test_forbidden_names_compared_whole():
    names = ["repro_torch", "repro_torch.core.fedavg", "reprox", "jaxtyping",
             "repro", "repro.core", "jax.numpy", "jaxlib", "flax.linen"]
    assert harness.forbidden_modules(names) == [
        "flax.linen", "jax.numpy", "jaxlib", "repro", "repro.core"]
