"""The port's dry run (``repro_torch.launch.dryrun``) on a fake process
group, in a process of its own (the group is process-global): records
with every key ``roofline.REQUIRED`` names, argument bytes equal to the
local bytes that the reference's specs give each device, the roofline
table rendered from them, and a local-SGD round whose pod mean is one
all-reduce of the local shards."""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
ARCH = "qwen3-14b"
# (shape name, global batch, sequence) of each record, cut to run fast
RUNS = [("train_4k", 32, 256), ("prefill_32k", 16, 256),
        ("decode_32k", 16, 512)]

_SCRIPT = r"""
import json, sys
from repro_torch.launch import dryrun
out, arch, runs = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
recs = []
with dryrun.fake_process_group(256):
    for shape, batch, seq in runs:
        recs.append(dryrun.run_one(arch, shape, reduced=True, batch=batch,
                                   seq=seq, out_dir=out, quiet=True))
print(json.dumps(recs))
"""

_LOCAL_SGD = r"""
import json, torch
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import costmodel, dryrun
from repro_torch.models.layers import tree_leaves
with dryrun.fake_process_group(8):
    mesh = dryrun.mesh_of((2, 2, 2))
    with FakeTensorMode():
        st = dryrun.build_local_sgd(
            "qwen3-14b", InputShape("train_4k", 128, 16, "train"),
            inner_steps=2, microbatches=1,
            cfg=get_config("qwen3-14b").reduced(), mesh=mesh)
        params = st.args[0]
        local = sum(t.to_local().numel() * t.to_local().element_size()
                    for t in tree_leaves(params))
        with costmodel.StepTracker() as tr, \
                dryrun.dtensor_bookkeeping_apart(tr):
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
                st.fn(*st.args)
print(json.dumps({"collectives": tr.collectives, "local": local}))
"""


def _run(code, *args, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code, *args], env=env,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    return out, _run(_SCRIPT, str(out), ARCH, json.dumps(RUNS))


def _local_bytes(shape, spec, sizes, itemsize):
    n = 1
    for d, m in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        axes = () if m is None else (m if isinstance(m, tuple) else (m,))
        k = int(np.prod([sizes[a] for a in axes])) if axes else 1
        assert d % k == 0
        n *= d // k
    return n * itemsize


def _tree_bytes(shapes, specs, sizes, itemsize=None):
    flat = jax.tree_util.tree_leaves(shapes)
    sflat = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(flat) == len(sflat)
    return sum(_local_bytes(a.shape, s, sizes,
                            itemsize or a.dtype.itemsize)
               for a, s in zip(flat, sflat))


def test_every_record_has_the_references_keys(records):
    _, recs = records
    assert [r["shape"] for r in recs] == [r[0] for r in RUNS]
    for r in recs:
        assert all(k in r for k in roofline.REQUIRED), r
        assert r["mesh"] == "16x16" and r["n_chips"] == 256
        mem = r["memory"]
        assert set(mem) == {"argument_bytes", "output_bytes", "temp_bytes"}
        assert min(mem.values()) >= 0 and mem["argument_bytes"] > 0
        assert r["flops_global"] > 0 and r["bytes_global"] > 0
    # the sharded train step gathers FSDP weights and reduces gradients
    coll = recs[0]["collective_bytes_per_device"]
    assert coll.get("all-gather", 0) > 0 and set(coll) <= {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute"}


def test_argument_bytes_are_the_references_local_bytes(records):
    """Per device: the params (bf16) and, for training, Adam's fp32 moments
    laid out by the reference's ``pspec_tree``, its int32 step count, the
    batch's int64 ids split by ``batch_pspec_tree``; for decode the caches
    laid out by ``cache_pspec_tree``."""
    saved = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as jdr        # sets XLA_FLAGS for itself
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    from repro.configs.base import InputShape
    _, recs = records
    cfg = jget(ARCH).reduced()
    mesh = jax.sharding.AbstractMesh((16, 16), ("data", "model"))
    sizes = {"data": 16, "model": 16}
    params = jax.eval_shape(lambda: jtf.init_model(
        jax.random.PRNGKey(0), cfg, dtype=jnp.bfloat16))
    for rec, (name, batch, seq) in zip(recs, RUNS):
        from repro.configs import SHAPES_BY_NAME
        shape = InputShape(name, seq, batch, SHAPES_BY_NAME[name].kind)
        rules = jmesh.make_rules(mesh, shard_batch=batch % 16 == 0)
        p_specs = rules.pspec_tree(params)
        want = _tree_bytes(params, p_specs, sizes)
        if shape.kind == "train":
            want += 2 * _tree_bytes(params, p_specs, sizes, 4) + 4
        bspecs = jdr.input_specs(cfg, shape)
        b_specs = jdr.batch_pspec_tree(bspecs, mesh, rules)
        want += _tree_bytes(bspecs, b_specs, sizes, 8)     # int64 ids
        if shape.kind == "decode":
            cap = jdr.cache_capacity(cfg, shape)
            caches = jax.eval_shape(lambda: jtf.init_cache(cfg, batch, cap))
            want += _tree_bytes(caches, jdr.cache_pspec_tree(
                caches, mesh, rules), sizes)
        assert rec["memory"]["argument_bytes"] == want, name


def test_the_roofline_table_renders_the_records(records):
    out, recs = records
    loaded = roofline.load_records(str(out))
    assert len(loaded) == len(RUNS)
    text = roofline.table(loaded)
    lines = text.splitlines()
    assert lines[0].startswith("| arch | shape | mesh |")
    assert len(lines) == 2 + len(RUNS)
    for (name, _, _), line in zip(sorted(RUNS), lines[2:]):
        assert f"| {ARCH} | {name} | 16x16 |" in line
    t = roofline.terms(loaded[0])
    assert t["dominant"] in ("compute", "memory", "collective")
    assert 0 < t["useful_ratio"] and t["fits"]


def test_local_sgd_round_means_the_pods_in_one_all_reduce_a_leaf():
    out = _run(_LOCAL_SGD)
    # the pod mean: one all-reduce of every local shard (the inner steps'
    # own all-reduces come on top)
    assert out["collectives"]["all-reduce"] >= out["local"] > 0
