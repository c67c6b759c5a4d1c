"""The port's sharding rules (``repro_torch.sharding``) against the
reference's (``repro.sharding.rules``, ``repro.launch.dryrun``): the same
rule table, the same per-dim mesh axes for every leaf of params,
optimizer state, caches and batch of all ten archs on both production
meshes; and a ``.reduced()`` qwen3 forward and train step on four gloo
ranks (a 2 x 2 ``("data", "model")`` mesh) equal to the unsharded run."""
import dataclasses
import os
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.sharding import ShardingRules as JRules  # noqa: E402
from repro_torch.configs import (ARCH_IDS, SHAPES_BY_NAME,  # noqa: E402
                                 get_config)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.layers import tree_map  # noqa: E402
from repro_torch.sharding import (AbstractMesh, ShardingRules,  # noqa: E402
                                  constrain, placements, safe_spec)
from repro_torch.sharding.rules import P, _map_with_path  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
import _torch_dist_workers as workers  # noqa: E402


def _jdryrun():
    """``repro.launch.dryrun`` sets XLA_FLAGS for itself on import; the
    backend is already locked (conftest), and the variable is put back so
    no later subprocess sees it."""
    saved = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as jdr
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    return jdr


# ------------------------------------------------------------- rules
def test_safe_spec_drops_indivisible_axes():
    mesh = AbstractMesh((1,), ("model",))
    # single-device axes (size 1) always pass through
    assert safe_spec((56, 64), P("model", None), mesh) == P("model", None)
    mesh = AbstractMesh((16,), ("model",))
    assert safe_spec((56, 64), P("model", None), mesh) == P(None, None)
    assert safe_spec((64, 56), P("model", None), mesh) == P("model", None)


def test_constrain_noop_without_rules():
    x = torch.ones((4, 4))
    assert constrain(x, "batch", None) is x


def test_param_pspec_rules():
    mesh = AbstractMesh((1,), ("data",))
    rules = ShardingRules(mesh, tensor_axis="model", fsdp_axis="data")
    assert rules.param_pspec(("blocks", "attn", "wq"), (1024, 2048)) == \
        P("data", "model")
    assert rules.param_pspec(("blocks", "attn", "wo"), (2048, 1024)) == \
        P("model", "data")
    # stacked layer axis is never sharded
    assert rules.param_pspec(("blocks", "moe", "moe_w_in"),
                             (24, 16, 512, 128)) == \
        P(None, "model", "data", None)
    assert rules.param_pspec(("final_norm",), (1024,)) == P(None)


def test_shard_batch_off_disables_batch_axes():
    mesh = AbstractMesh((1,), ("data",))
    rules = ShardingRules(mesh, shard_batch=False)
    assert rules.logical["batch"] is None


def test_placements_of_a_pod_data_fsdp_spec():
    """("pod", "data") on one dim is Shard of that dim on both mesh dims,
    pod major; axes out of the mesh's order are refused."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert placements(P(("pod", "data"), "model"), mesh) == \
        [Shard(0), Shard(0), Shard(1)]
    assert placements(P(None, None), mesh) == [Replicate()] * 3
    with pytest.raises(ValueError):
        placements(P(("data", "pod")), mesh)


# ------------------------------------------ the specs of every arch's leaves
def _short(cfg):
    """The arch at full width, its stacks cut to the fewest layers that
    keep every group of its tree (the stacked layer axis is never
    sharded)."""
    if cfg.arch_type == "moe":
        n = cfg.dense_layers + 2
    elif cfg.arch_type == "hybrid":
        n = cfg.attn_every + 1
    elif cfg.arch_type == "ssm":
        n = cfg.xlstm.slstm_every
    else:
        n = 2
    return dataclasses.replace(cfg, n_layers=n)


def _jflat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return {tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp):
            tuple(v) for kp, v in flat}


def _tflat(tree):
    out = {}
    _map_with_path(lambda path, s: out.__setitem__(path, tuple(s))
                   if s is not None else None, tree,
                   is_leaf=lambda x: isinstance(x, P))
    return out


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_the_references(arch, multi_pod):
    jdr = _jdryrun()
    shape, names = tmesh.production_shape(multi_pod)
    jm = jax.sharding.AbstractMesh(shape, names)
    tm = AbstractMesh(shape, names)
    jcfg = _short(jget(arch))
    tcfg = _short(get_config(arch))
    jparams = jax.eval_shape(lambda: jtf.init_model(
        jax.random.PRNGKey(0), jcfg, dtype=jnp.bfloat16))
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        tparams = dryrun.shape_tree(tf.init_model(torch.Generator(), tcfg,
                                                  dtype=torch.bfloat16))
    for name, ishape in SHAPES_BY_NAME.items():
        # the rules of build_lowerable, on both sides
        jr = jmesh.make_rules(jm, **_rule_flags(jdr, arch, jcfg, ishape, jm))
        tr = dryrun.step_rules(arch, tcfg, ishape, tm)
        assert tr.logical == {k: v for k, v in jr.logical.items()}, name
        jp, tp = jr.pspec_tree(jparams), tr.pspec_tree(tparams)
        assert _tflat(tp) == _jflat(jp), (name, "params")
        jo = jdr._opt_state_pspecs(arch, jp, jparams)
        to = dryrun._opt_state_pspecs(arch, tp, tparams)
        assert _tflat(to) == _jflat(jo), (name, "opt state")
        jb = jdr.batch_pspec_tree(jdr.input_specs(jcfg, ishape), jm, jr)
        tb = dryrun.batch_pspec_tree(dryrun.input_specs(tcfg, ishape), tm,
                                     tr)
        assert {k: tuple(v) for k, v in tb.items()} == \
            {k: tuple(v) for k, v in jb.items()}, (name, "batch")
        if ishape.kind != "decode":
            continue
        cap = jdr.cache_capacity(jcfg, ishape)
        assert dryrun.cache_capacity(tcfg, ishape) == cap
        jc = jdr.cache_pspec_tree(jax.eval_shape(lambda: jtf.init_cache(
            jcfg, ishape.global_batch, cap)), jm, jr)
        tc = dryrun.cache_pspec_tree(dryrun.shape_tree(tf.init_cache(
            tcfg, ishape.global_batch, cap, device="meta")), tm, tr)
        assert _tflat(tc) == _jflat(jc), (name, "caches")


def _rule_flags(jdr, arch, cfg, shape, mesh):
    """``build_lowerable``'s shard_batch and shard_activations (:197-201)."""
    shard_batch = shape.global_batch % mesh.shape["data"] == 0
    mb_n = (jdr.MICROBATCHES.get(arch, 1) if shape.kind == "train" else 1)
    per_dev_b = max(shape.global_batch // mb_n // mesh.shape["data"], 1)
    saved_x = cfg.n_layers * per_dev_b * shape.seq_len * cfg.d_model * 2
    return {"shard_batch": shard_batch,
            "shard_activations": (shape.kind == "train"
                                  and saved_x > 3 * 2 ** 30)}


# ---------------------------------------------- a sharded step on 4 ranks
def _close(got, want, rel=2e-4):
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max())
    assert err <= rel * scale, (err, scale)


def test_four_gloo_ranks_equal_the_unsharded_step(tmp_path):
    from repro_torch import checkpoint, optim
    arch = "qwen3-14b"
    cfg = get_config(arch).reduced()
    params = tf.init_model(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (8, 64))
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    np_params = tree_map(lambda t: t.numpy(), params)
    files = workers.spawn(workers.sharded_lm, 4, tmp_path, arch, np_params,
                          batch, 0.1, timeout_s=240.0)
    flat, _ = checkpoint.load_arrays(files[0])

    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits, _, _ = tf.forward(params, tb, cfg, dtype=torch.float32,
                              remat=False, attn_impl="torch")
    _close(flat["logits"], logits)
    opt = optim.sgd()
    step = tf.make_train_step(cfg, opt, dtype=torch.float32, microbatches=2)
    new, _, m = step(params, opt.init(params), tb, 0.1)
    _close(flat["loss"], m["loss"])
    leaves = {}
    _map_with_path(lambda path, t: leaves.__setitem__("/".join(path), t),
                   new)
    for k, v in leaves.items():
        _close(flat[f"params/{k}"], v)
