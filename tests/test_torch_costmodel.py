"""The port's cost model (``repro_torch.launch.costmodel``) against the
reference's (``repro.launch.costmodel``): the products' FLOPs of every
arch's ``.reduced()`` forward equal the reference's ``dot_general`` FLOPs
over the same shapes; loops count every trip; a gradient adds the
products' backward; a DTensor all-gather counts at its result bytes."""
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
import torch  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.launch import costmodel, dryrun  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent


def _jax_dot_flops(jaxpr) -> float:
    """``dot_general`` FLOPs of a jaxpr, 2·M·N·K·batch, through every
    sub-jaxpr and times every ``scan`` length: the products' part of the
    reference's ``jaxpr_cost`` (its totals also charge one FLOP per
    element of every other op, which the two frameworks lower into
    different elementwise ops: casts, broadcasts, one-hot compares)."""
    total = 0.0
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name == "dot_general":
            ((lc, _), (lb, _)) = eqn.params["dimension_numbers"]
            a, b = eqn.invars[0].aval, eqn.invars[1].aval
            batch = int(np.prod([a.shape[i] for i in lb])) if lb else 1
            k = int(np.prod([a.shape[i] for i in lc])) if lc else 1
            m = int(np.prod(a.shape)) // max(batch * k, 1)
            n = int(np.prod(b.shape)) // max(batch * k, 1)
            total += 2.0 * batch * m * n * k
            continue
        n_trips = eqn.params["length"] if name == "scan" else 1
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else (v,)):
                if hasattr(sub, "jaxpr") and hasattr(sub.jaxpr, "eqns"):
                    total += n_trips * _jax_dot_flops(sub.jaxpr)
                elif hasattr(sub, "eqns"):
                    total += n_trips * _jax_dot_flops(sub)
    return total


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_dot_flops_equal_the_references(arch):
    shape = InputShape("x", 128, 2, "prefill")
    jcfg, tcfg = jget(arch).reduced(), get_config(arch).reduced()
    specs = dryrun.input_specs(tcfg, shape)
    jparams = jax.eval_shape(lambda: jtf.init_model(
        jax.random.PRNGKey(0), jcfg, dtype=jnp.float32))
    jbatch = {k: jax.ShapeDtypeStruct(s, jnp.int32 if dt == torch.long
                                      else jnp.float32)
              for k, (s, dt) in specs.items()}
    jaxpr = jax.make_jaxpr(lambda p, b: jtf.forward(
        p, b, jcfg, dtype=jnp.float32, remat=False))(jparams, jbatch)
    want = _jax_dot_flops(jaxpr.jaxpr)

    params = tf.init_model(torch.Generator().manual_seed(0), tcfg)
    batch = {k: torch.zeros(s, dtype=dt if dt == torch.long
                            else torch.float32)
             for k, (s, dt) in specs.items()}
    got = costmodel.step_cost(lambda: tf.forward(
        params, batch, tcfg, dtype=torch.float32, remat=False,
        attn_impl="torch"))
    assert want > 0 and got["dot_flops"] == want
    assert got["flops"] > got["dot_flops"] and got["bytes"] > 0


def test_a_loop_counts_every_trip():
    W, x = torch.ones((32, 32)), torch.ones((4, 32))

    def f():
        c = x
        for _ in range(7):
            c = c @ W
        return c.sum()
    got = costmodel.step_cost(f)
    assert got["dot_flops"] == 7 * 2 * 4 * 32 * 32
    # the sum: one FLOP per output element
    assert got["flops"] == got["dot_flops"] + 1


@pytest.mark.parametrize("wrt_x", [False, True], ids=["wgrad", "wgrad+dgrad"])
def test_a_gradient_adds_the_products_backward(wrt_x):
    """The reference's grad of sum(x @ w) in w is 1.5-2.6x the forward
    (its dgrad is dead code); here the products' FLOPs are exactly 2x,
    and 3x when x wants a gradient too."""
    W = torch.ones((64, 64), requires_grad=True)
    x = torch.ones((8, 64), requires_grad=wrt_x)
    fwd = costmodel.step_cost(lambda: torch.sum(x @ W))["dot_flops"]
    bwd = costmodel.step_cost(lambda: torch.autograd.grad(
        torch.sum(x @ W), [W, x] if wrt_x else [W]))["dot_flops"]
    assert bwd == (3 if wrt_x else 2) * fwd


def test_views_and_casts_cost_nothing():
    x = torch.ones((16, 32))
    got = costmodel.step_cost(lambda: x.t().reshape(8, 64).to(torch.bfloat16)
                              .unsqueeze(0).expand(3, 8, 64))
    assert got == {"flops": 0.0, "bytes": 0.0, "dot_flops": 0.0}


_FSDP = r"""
import json, torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate, Shard
from repro_torch.launch import costmodel, dryrun
from repro_torch.sharding.rules import AbstractMesh, P
with dryrun.fake_process_group(4):
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
    with FakeTensorMode():
        w = dryrun.sharded_full((1024, 512), torch.bfloat16, P("data", None),
                                mesh)
        x = dryrun.sharded_full((8, 1024), torch.bfloat16, P("data", None),
                                mesh)
        coll = costmodel.collective_bytes(
            lambda: x.redistribute(mesh, [Replicate()])
            @ w.redistribute(mesh, [Replicate()]))
        print(json.dumps({"coll": coll,
                          "local": list(w.to_local().shape)}))
"""


def test_an_fsdp_all_gather_counts_its_result_bytes():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", _FSDP], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["local"] == [256, 512]
    # per device: the gathered (1024, 512) weight and (8, 1024) input, bf16
    assert out["coll"] == {"all-gather": (1024 * 512 + 8 * 1024) * 2}
