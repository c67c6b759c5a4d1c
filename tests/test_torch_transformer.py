"""The port's dense decoder against the JAX package's, from the same weights.

JAX makes the parameters (torch cannot replay ``jax.random``); they cross
as numpy arrays through ``transformer.params_from_numpy``.  Three reduced
dense configs: ``qwen3-14b.reduced()`` (qk-norm, MQA after the reduction),
``qwen1.5-0.5b.reduced()`` (MHA, QKV bias, tied embeddings) and
``qwen3-14b.reduced()`` with 2 KV heads (GQA 2:1).  At fp32:

* ``forward`` logits on the plain route at rtol/atol 2e-4, the tolerance
  ``tests/test_kernels.py`` holds the JAX flash path to;
* the kernel route (the flash kernel's plain version on the CPU) against
  JAX with ``USE_FLASH_KERNEL`` (the Pallas kernel in interpret mode), 2e-4;
* a prefill of S-3 tokens, then 3 ``decode_step``s, at 1e-4, on both
  routes and with a sliding window;
* the building blocks (``rms_norm``, ``apply_rope``, ``mlp``, ``embed``);
* the configs of all ten architecture ids: fields, ``reduced()``,
  parameter counts and input shapes; each id resolves in the port and its
  reduced tree builds with JAX's keys and shapes (the other families are
  held against JAX in ``tests/test_torch_archs.py``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

B = 2


def _cfg_pair(name):
    """(JAX config, port config) of one of the three reduced dense cases."""
    arch, kv = {"qwen3": ("qwen3-14b", None), "qwen1.5": ("qwen1.5-0.5b", None),
                "qwen3-gqa2": ("qwen3-14b", 2)}[name]
    j, t = jreg.get_config(arch).reduced(), treg.get_config(arch).reduced()
    if kv:
        j, t = (dataclasses.replace(j, n_kv_heads=kv),
                dataclasses.replace(t, n_kv_heads=kv))
    return j, t


CFGS = ["qwen3", "qwen1.5", "qwen3-gqa2"]


def _model(name, seed=0):
    jcfg, tcfg = _cfg_pair(name)
    jp = jtf.init_model(jax.random.PRNGKey(seed), jcfg)
    tp = ttf.params_from_numpy(jax.tree.map(np.asarray, jp))
    return jcfg, tcfg, jp, tp


def _tokens(cfg, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), rtol=tol, atol=tol)


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_dense_configs_are_copies(arch):
    j, t = jreg.get_config(arch), treg.get_config(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())
    assert t.num_params() == j.num_params()
    assert t.active_params() == j.active_params()
    assert t.resolved_head_dim == j.resolved_head_dim


def _port_config(jcfg):
    """The port's ModelConfig with a JAX config's fields, sub-configs
    rebuilt from the port's copies."""
    subs = {"moe": tbase.MoEConfig, "mla": tbase.MLAConfig,
            "ssm": tbase.SSMConfig, "xlstm": tbase.XLSTMConfig,
            "frontend": tbase.FrontendConfig}
    kw = {}
    for f in dataclasses.fields(jcfg):
        v = getattr(jcfg, f.name)
        kw[f.name] = (subs[f.name](**dataclasses.asdict(v))
                      if f.name in subs and v is not None else v)
    return tbase.ModelConfig(**kw)


@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_model_config_copy_counts_and_reduces_like_jax(arch):
    """Every field and method of the copied ModelConfig and its
    sub-configs, on every architecture of the JAX package."""
    j = jreg.get_config(arch)
    t = _port_config(j)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.num_params() == j.num_params()
    assert t.active_params() == j.active_params()
    assert t.uses_attention == j.uses_attention
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())
    assert t.reduced().num_params() == j.reduced().num_params()


def test_sub_config_defaults_and_input_shapes_are_copies():
    pairs = [(tbase.MoEConfig(8, 2, 64), jbase.MoEConfig(8, 2, 64)),
             (tbase.MLAConfig(), jbase.MLAConfig()),
             (tbase.SSMConfig(), jbase.SSMConfig()),
             (tbase.XLSTMConfig(), jbase.XLSTMConfig()),
             (tbase.FrontendConfig("vlm"), jbase.FrontendConfig("vlm"))]
    for t, j in pairs:
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert [dataclasses.asdict(s) for s in tbase.INPUT_SHAPES] == \
        [dataclasses.asdict(s) for s in jbase.INPUT_SHAPES]
    assert set(tbase.SHAPES_BY_NAME) == set(jbase.SHAPES_BY_NAME)


def test_registry_holds_every_arch_of_the_jax_package():
    assert treg.ARCH_IDS == jreg.ARCH_IDS
    assert set(treg.all_configs()) == set(jreg.ARCH_IDS)


@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_every_arch_builds_its_reduced_tree(arch):
    """``init_model`` of each reduced config: JAX's keys and shapes (from
    ``jax.eval_shape``, nothing drawn on the JAX side)."""
    jcfg = jreg.get_config(arch).reduced()
    tcfg = treg.get_config(arch).reduced()
    want = jax.eval_shape(lambda: jtf.init_model(jax.random.PRNGKey(0),
                                                 jcfg))
    mine = ttf.init_model(torch.Generator().manual_seed(0), tcfg)
    shapes = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
              jax.tree_util.tree_flatten_with_path(mine)[0]}
    assert shapes == {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
                      jax.tree_util.tree_flatten_with_path(want)[0]}


@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_unknown_arch_ids_raise_key_error(arch):
    for bad in (arch + "-x", arch.upper()):
        with pytest.raises(KeyError):
            treg.get_config(bad)
        with pytest.raises(KeyError):
            jreg.get_config(bad)


# ------------------------------------------------------------------ layers
def test_layers_match_jax():
    r = np.random.default_rng(5)
    x = r.normal(size=(2, 7, 3, 16)).astype(np.float32)
    scale = r.normal(size=(16,)).astype(np.float32)
    _close(tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)),
           jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale)), 1e-5)
    pos = np.arange(7)[None, :] + 4090
    _close(tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                              1e6),
           jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6), 1e-4)
    xb = r.normal(size=(2, 7, 32)).astype(np.float32)
    p = {k: r.normal(size=s).astype(np.float32) * 0.2 for k, s in
         (("w_in", (32, 48)), ("w_gate", (32, 48)), ("w_out", (48, 32)))}
    _close(tlayers.mlp({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(xb)),
           jlayers.mlp({k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(xb)), 1e-5)
    table = r.normal(size=(50, 8)).astype(np.float32)
    tok = r.integers(0, 50, (2, 5))
    _close(tlayers.embed(torch.from_numpy(table), torch.from_numpy(tok),
                         torch.bfloat16),
           jlayers.embed(jnp.asarray(table), jnp.asarray(tok), jnp.bfloat16),
           0)


@pytest.mark.parametrize("name", CFGS)
def test_param_tree_layout_matches_jax(name):
    jcfg, tcfg, jp, tp = _model(name)
    mine = ttf.init_model(torch.Generator().manual_seed(0), tcfg)
    flat_j = {jax.tree_util.keystr(k): np.shape(v) for k, v in
              jax.tree_util.tree_flatten_with_path(jp)[0]}
    for tree in (tp, mine):
        flat_t = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
                  jax.tree_util.tree_flatten_with_path(tree)[0]}
        assert flat_t == flat_j
    assert tp["blocks"]["attn"]["wq"].shape == (
        tcfg.n_layers, tcfg.d_model, tcfg.n_heads * tcfg.resolved_head_dim)
    module = ttf.Transformer(tcfg, tp)
    assert sum(p.numel() for p in module.parameters()) == \
        sum(int(np.prod(s)) for s in flat_j.values())


# ------------------------------------------------------------------ forward
@pytest.mark.parametrize("name", CFGS)
def test_forward_plain_route_matches_jax(name):
    jcfg, tcfg, jp, tp = _model(name, 1)
    toks = _tokens(tcfg, 64, 1)
    want, _, _ = jtf.forward(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                             jcfg, dtype=jnp.float32, remat=False)
    got, aux, _ = ttf.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                              dtype=torch.float32, remat=False,
                              attn_impl="torch")
    assert got.shape == (B, 64, tcfg.vocab_size) and float(aux) == 0.0
    _close(got, want, 2e-4)


@pytest.mark.parametrize("name", CFGS)
def test_forward_kernel_route_matches_jax_flash_path(name):
    jcfg, tcfg, jp, tp = _model(name, 2)
    toks = _tokens(tcfg, 128, 2)
    jattn.USE_FLASH_KERNEL = True
    try:
        want, _, _ = jtf.forward(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                                 jcfg, dtype=jnp.float32, remat=False)
    finally:
        jattn.USE_FLASH_KERNEL = False
    module = ttf.Transformer(tcfg, tp)
    got, _, _ = module({"tokens": torch.from_numpy(toks)},
                       dtype=torch.float32)
    _close(got, want, 2e-4)


@pytest.mark.parametrize("window", [0, 16], ids=["full", "window16"])
@pytest.mark.parametrize("attn_impl", ["kernel", "torch"])
@pytest.mark.parametrize("name", CFGS)
def test_prefill_then_decode_matches_jax(name, attn_impl, window):
    S = 64
    jcfg, tcfg, jp, tp = _model(name, 3)
    toks = _tokens(tcfg, S, 3)
    jc = jtf.init_cache(jcfg, B, S, dtype=jnp.float32)
    jl, _, (jc, _, _) = jtf.forward(
        jp, {"tokens": jnp.asarray(toks[:, :S - 3], jnp.int32)}, jcfg,
        dtype=jnp.float32, window=window, caches=jc, remat=False)
    tc = ttf.init_cache(tcfg, B, S, dtype=torch.float32)
    tl, _, (tc2, _, _) = ttf.forward(
        tp, {"tokens": torch.from_numpy(toks[:, :S - 3])}, tcfg,
        dtype=torch.float32, window=window, caches=tc, remat=False,
        attn_impl=attn_impl)
    assert tc2 is tc                                      # filled in place
    _close(tl, jl, 2e-4)
    for key in ("k", "v", "pos_ids"):
        _close(tc[key], jc[key], 1e-5)
    for pos in range(S - 3, S):
        tok = toks[:, pos:pos + 1]
        jl, jc = jtf.decode_step(jp, jc, {"tokens": jnp.asarray(tok,
                                                                jnp.int32)},
                                 jnp.int32(pos), jcfg, dtype=jnp.float32,
                                 window=window)
        tl, tc = ttf.decode_step(tp, tc, {"tokens": torch.from_numpy(tok)},
                                 pos, tcfg, dtype=torch.float32,
                                 window=window)
        assert tl.shape == (B, 1, tcfg.vocab_size)
        _close(tl, jl, 1e-4)
