"""The dry run's trip-count rule (``repro_torch.launch.costmodel``):
under the dry run's fake tensors the model's loops of identical trips
(``repro_torch.models.scan.loop``: the sLSTM's steps, a stack's
identical layers, the microbatches) run three trips and count the middle
one for the rest, as the reference's ``jaxpr_cost`` multiplies a scan
body by its length.  Held to the
unrolled trace (every trip traced) on ``.reduced()`` configs: global
FLOPs and bytes and the collective bytes a device, by kind and by op,
exactly, the predicted peak within 12a's 5 %; its products' FLOPs to the
live reference's scan-aware count on the same forward; and its host time
to the unrolled trace's, which grows with the trip count."""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.launch import costmodel, dryrun  # noqa: E402
from repro_torch.models import scan  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_costmodel import _jax_dot_flops  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
PEAK_TOL = 0.05           # phase 12a's bound on the predicted peak
# (arch, shape, global batch, seq, layers, microbatches, fake mesh of the
# 4 ranks): each loop of the rule at more than three trips somewhere
CASES = {
    # 4 layers, 4 microbatches
    "qwen3_train": ("qwen3-14b", "train_4k", 4, 32, 4, 4, "2x2"),
    # 16 sLSTM steps, 4 microbatches
    "xlstm_train": ("xlstm-1.3b", "train_4k", 4, 16, 2, 4, "2x2"),
    # 4 groups of (mLSTM, sLSTM), 128 sLSTM steps, no grad
    "xlstm_prefill": ("xlstm-1.3b", "prefill_32k", 4, 128, 8, None, "2x2"),
    # 4 microbatches of its dense + MoE layer, MTP, Adafactor
    "deepseek_train": ("deepseek-v3-671b", "train_4k", 4, 16, 2, 4, "2x2"),
}
# the case whose host times are compared: DTensor's caches warmed first
TIMED = "xlstm_prefill"

_SCRIPT = r"""
import json, sys, time
from repro_torch.launch import dryrun
cases, timed = json.loads(sys.argv[1]), sys.argv[3:]
out = {}
# one process, one fake group of 4 ranks for every case (DTensor's caches
# carry over); the timed case's rule run first, to warm them
with dryrun.fake_process_group(4):
    for case, (arch, shape, batch, seq, layers, mb, mesh) in cases.items():
        runs = (("warm", True),) * (case in timed) + (
            ("unrolled", False), ("rule", True))
        out[case] = {}
        for name, rule in runs:
            t0 = time.perf_counter()
            rec = dryrun.run_one(
                arch, shape, reduced=True, layers=layers, batch=batch,
                seq=seq, microbatches=mb, out_dir=sys.argv[2], quiet=True,
                mesh_shape=tuple(int(n) for n in mesh.split("x")),
                trip_rule=rule)
            rec["wall_s"] = time.perf_counter() - t0
            out[case][name] = rec
print(json.dumps(out))
"""


def trace_cases(cases, out_dir, timed=()):
    """{case: {"unrolled", "rule"(, "warm" for a case in ``timed``):
    its dry-run record and wall}} of ``cases``, traced in one process."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT, json.dumps(cases), str(out_dir),
         *timed], env=env, capture_output=True, text=True, timeout=400)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return trace_cases(CASES, tmp_path_factory.mktemp("tripcount"),
                       (TIMED,))


def _peak(rec):
    return sum(rec["memory"].values())


def check_the_rule_equals_the_unrolled_trace(r):
    """A case's rule run against its unrolled run: FLOPs, bytes and
    collectives exactly, the predicted peak within PEAK_TOL."""
    rule, full = r["rule"], r["unrolled"]
    assert rule["trip_rule"] and not full["trip_rule"]
    for k in ("flops_global", "bytes_global", "collective_bytes_per_device",
              "collective_bytes_by_op"):
        assert rule[k] == full[k], (k, rule[k], full[k])
    assert rule["collective_bytes_per_device"], "no collective on the mesh"
    assert abs(_peak(rule) / _peak(full) - 1) <= PEAK_TOL, (
        _peak(rule), _peak(full))


@pytest.mark.parametrize("case", list(CASES))
def test_the_rule_equals_the_unrolled_trace(runs, case):
    check_the_rule_equals_the_unrolled_trace(runs[case])


def test_the_rule_cuts_the_traced_wall(runs):
    """128 sLSTM steps and 4 groups traced as three each: the unrolled
    trace's host time grows with the steps, the rule's does not."""
    r = runs[TIMED]
    walls = {k: r[k]["global_s"] + r[k]["sharded_s"]
             for k in ("rule", "unrolled")}
    assert walls["unrolled"] > 6 * walls["rule"], walls


@pytest.mark.parametrize("arch,layers,seq", [
    ("xlstm-1.3b", 8, 64), ("deepseek-v3-671b", 6, 32),
    ("qwen3-14b", 6, 32)])
def test_the_rules_products_equal_the_references_scan_count(arch, layers,
                                                            seq):
    """The forward (layers and sLSTM steps under the rule) on un-sharded
    fake tensors: its products' FLOPs equal ``dot_general``'s over the
    reference's jaxpr, times every scan length.  (The train step's
    backward lowers differently in the two packages: the reference
    checkpoints each attention chunk, and recomputes its scores.)"""
    shape = InputShape("x", seq, 2, "prefill")
    jcfg = dataclasses.replace(jget(arch).reduced(), n_layers=layers)
    tcfg = dataclasses.replace(get_config(arch).reduced(), n_layers=layers)
    specs = dryrun.input_specs(tcfg, shape)
    jparams = jax.eval_shape(lambda: jtf.init_model(
        jax.random.PRNGKey(0), jcfg, dtype=jnp.float32))
    jbatch = {k: jax.ShapeDtypeStruct(s, jnp.int32) for k, (s, _) in
              specs.items()}
    want = _jax_dot_flops(jax.make_jaxpr(lambda p, b: jtf.forward(
        p, b, jcfg, dtype=jnp.float32, remat=False))(jparams, jbatch).jaxpr)
    with FakeTensorMode():
        params = dryrun.global_tree(dryrun.shape_tree(
            tf.init_model(torch.Generator(), tcfg)))
        batch = {k: torch.zeros(s, dtype=torch.long, device=dryrun.DEVICE)
                 for k, (s, _) in specs.items()}
        got = costmodel.step_cost(lambda: tf.forward(
            params, batch, tcfg, dtype=torch.float32, remat=False,
            attn_impl="torch"), trip_rule=True)
    assert want > 0 and got["dot_flops"] == want


def test_a_short_loop_runs_every_trip():
    """Three trips or fewer: the rule has nothing to skip."""
    seen = []

    def body(i, c):
        seen.append(i)
        return c + 1, i
    with FakeTensorMode(), costmodel.StepTracker(trip_rule=True):
        assert scan.loop(3, body, 0) == (3, [0, 1, 2])
        seen.clear()
        assert scan.loop(6, body, 0) == (3, [0, 1, 1, 1, 1, 5])
    assert seen == [0, 1, 5]
    # real tensors run every trip, rule or not
    with costmodel.StepTracker(trip_rule=True):
        assert scan.loop(6, lambda i, c: (c + 1, i), 0)[0] == 6
