"""The sharded LM step partitions the CE and the norms as the reference's
GSPMD does: ``chunked_weighted_ce`` on vocab-sharded logits keeps each
rank's block of the vocabulary and crosses the ranks in small all-reduces
of row statistics, and ``rms_norm`` / ``layer_norm`` over a split d
all-reduce their statistics instead of gathering d.  Held to the
un-sharded port and to the live JAX functions on four gloo ranks (a
2 x 2 ``("data", "model")`` mesh), and, on a fake 16 x 16 group, a
``.reduced()`` qwen3-14b train step whose records show neither a
``_log_softmax`` collective nor a gather inside a norm."""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import losses as jlosses  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch import checkpoint  # noqa: E402
from repro_torch.core import losses  # noqa: E402
from repro_torch.models import layers  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
import _torch_dist_workers as workers  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
TOL = 1e-5
# hidden states (B, S, d), a head (d, V) whose vocabulary splits in two
# blocks of 32, two chunks of the sequence, beta != 1 and a mask
B, S, D, V, CHUNK, BETA = 4, 32, 16, 64, 16, 1.7


def _ce_inputs():
    rng = np.random.default_rng(22)
    labels = rng.integers(0, V, (B, S))
    # a label in each rank's block of the vocabulary, in every chunk
    labels[:, 0], labels[:, CHUNK] = 3, V - 5
    return {"h": rng.normal(size=(B, S, D)).astype(np.float32),
            "w_head": (rng.normal(size=(D, V)) * D ** -0.5
                       ).astype(np.float32),
            "labels": labels, "mask": rng.random((B, S)) > 0.25,
            "beta": BETA, "chunk": CHUNK}


def _norm_inputs():
    rng = np.random.default_rng(23)
    return {"x": (rng.normal(size=(B, 8, D)) * 3 + 0.5).astype(np.float32),
            "r": rng.normal(size=(B, 8, D)).astype(np.float32),
            "scale": (1 + 0.1 * rng.normal(size=(D,))).astype(np.float32),
            "bias": (0.1 * rng.normal(size=(D,))).astype(np.float32)}


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    out = tmp_path_factory.mktemp("split")
    files = workers.spawn(workers.split_ce_and_norms, 4, out, _ce_inputs(),
                          _norm_inputs(), timeout_s=240.0)
    flat, _ = checkpoint.load_arrays(files[0])
    return flat


def _close(got, want, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, (name, err, scale)


def _plain_ce(inp):
    h = torch.from_numpy(inp["h"]).requires_grad_(True)
    w = torch.from_numpy(inp["w_head"]).requires_grad_(True)
    loss = losses.chunked_weighted_ce(
        h, w, torch.from_numpy(inp["labels"]), inp["beta"],
        torch.from_numpy(inp["mask"]), chunk=inp["chunk"])
    gh, gw = torch.autograd.grad(loss, [h, w])
    return {"loss": loss.detach(), "h": gh, "w_head": gw}


def _jax_ce(inp):
    import jax

    def f(h, w):
        return jlosses.chunked_weighted_ce(
            h, w, jnp.asarray(inp["labels"]), inp["beta"],
            jnp.asarray(inp["mask"]), chunk=inp["chunk"])
    loss, (gh, gw) = jax.value_and_grad(f, argnums=(0, 1))(
        jnp.asarray(inp["h"]), jnp.asarray(inp["w_head"]))
    return {"loss": loss, "h": gh, "w_head": gw}


@pytest.mark.parametrize("ref", ["unsharded", "jax"])
def test_vocab_parallel_ce_equals_the_whole_vocab_ce(split, ref):
    inp = _ce_inputs()
    # the head's vocabulary really was split over the model axis
    assert bool(split["ce/w_layout"][1])
    want = (_plain_ce if ref == "unsharded" else _jax_ce)(inp)
    np.testing.assert_allclose(float(split["ce/loss"]),
                               float(want["loss"]), rtol=TOL)
    for k in ("h", "w_head"):
        _close(split[f"ce/{k}"], want[k], k)


def _plain_norm(name, inp):
    x = torch.from_numpy(inp["x"]).requires_grad_(True)
    ps = [torch.from_numpy(inp[k]).requires_grad_(True)
          for k in (("scale",) if name == "rms" else ("scale", "bias"))]
    fn = layers.rms_norm if name == "rms" else layers.layer_norm
    y = fn(x, *ps)
    grads = torch.autograd.grad(torch.sum(y * torch.from_numpy(inp["r"])),
                                [x, *ps])
    return y.detach(), grads


@pytest.mark.parametrize("name", ["rms", "layer"])
def test_norms_over_a_split_d_equal_the_plain_norms(split, name):
    inp = _norm_inputs()
    assert all(split[f"{name}/y_split"][1:])      # d stayed split
    y, grads = _plain_norm(name, inp)
    _close(split[f"{name}/y"], y, "y")
    for k, g in zip(("x", "scale", "bias"), grads):
        _close(split[f"{name}/g_{k}"], g, f"g_{k}")
    # and the plain norm is the JAX package's
    jfn = (jlayers.rms_norm(jnp.asarray(inp["x"]), jnp.asarray(inp["scale"]))
           if name == "rms" else jlayers.layer_norm(
               jnp.asarray(inp["x"]), jnp.asarray(inp["scale"]),
               jnp.asarray(inp["bias"])))
    _close(y, jfn, "jax")


_FAKE_MESH = r"""
import json, traceback
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import SHAPES_BY_NAME, get_config
from repro_torch.launch import costmodel, dryrun
from repro_torch.launch import mesh as mesh_mod
import dataclasses

NORMS = {"rms_norm", "layer_norm", "_split_norm"}


class Recorder(costmodel.StepTracker):
    # the Python frames under each all-gather of the forward
    gathers = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func._overloadpacket is costmodel._c10d.all_gather_into_tensor:
            self.gathers.append(
                [f.name for f in traceback.extract_stack()])
        return super().__torch_dispatch__(func, types, args, kwargs)


with dryrun.fake_process_group(256):
    mesh = mesh_mod.make_production_mesh(device_type=dryrun.DEVICE)
    # activation FSDP on, as train_4k at full width has it: d split
    rules = mesh_mod.make_rules(mesh, shard_activations=True)
    dryrun.step_rules = lambda *a, **k: rules
    shape = dataclasses.replace(SHAPES_BY_NAME["train_4k"],
                                global_batch=32, seq_len=128)
    with FakeTensorMode():
        step = dryrun.build_step("qwen3-14b", shape, mesh=mesh,
                                 cfg=get_config("qwen3-14b").reduced())
        tr = Recorder()
        with torch.enable_grad(), dryrun.dtensor_bookkeeping_apart(tr), \
                tr, implicit_replication():
            step.fn(*step.args)
print(json.dumps({
    "by_op": tr.collectives_by_op,
    "norm_gathers": [s for s in tr.gathers if NORMS & set(s)],
    "gathers": len(tr.gathers)}))
"""


def test_fake_mesh_step_has_no_log_softmax_or_norm_gather():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", _FAKE_MESH], env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    by_op = rec["by_op"]
    assert not [k for k in by_op if "log_softmax" in k], by_op
    # the new all-reduces are booked under their own names
    assert by_op.get("vocab_parallel_ce", 0) > 0, by_op
    assert by_op.get("norm_stats", 0) > 0, by_op
    assert rec["gathers"] > 0 and rec["norm_gathers"] == []
