"""The port's LLM training path against the JAX package's, from the same
weights and batches.

* ``weighted_ce`` / ``chunked_weighted_ce`` (position weights β = 1 and 2,
  with and without a mask, two 512-position chunks and an unchunked S):
  values rtol 1e-5, grads w.r.t. the logits, ``h`` and ``w_head`` within
  2e-4 of each one's largest |value|;
* ``data/tokens.py``: bit-equal batches for every arch;
* the plain attention's q-chunks under checkpoint (S = 4096): output and
  grads against the reference's ``jax.checkpoint``-ed chunks;
* the train step's loss and grads for every arch at ``.reduced()``, fp32,
  from JAX-made params (``params_from_numpy``), microbatches 1 and 2:
  within 2e-4 of each leaf's largest |value| (the forward tolerance of
  ``tests/test_torch_archs.py``); the port's ``accumulate_grads`` (the gradient half of its
  step) against the reference's ``make_train_step``, whose grads are read
  out by an optimizer whose state is the gradient tree;
* the whole step with ``sgd``, updating the params in place: params rtol
  1e-4 / atol 1e-5 at lr 0.05, the tolerances and learning rate of
  ``tests/test_pallas_parity.py:40-46``;
* a bf16 gradient accumulator (deepseek's): 2e-2;
* ``_mtp_loss`` alone at deepseek ``.reduced()``: 2e-4;
* inside the port: remat on and off give the same loss and grads, and
  the ``--train`` command runs on the CPU.

The widest reduced configs (deepseek, xlstm, codeqwen) cost most of the
JAX compile time; as in ``tests/test_archs_smoke.py`` they run under
``-m slow``.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.core import losses as jlosses  # noqa: E402
from repro.data import tokens as jtokens  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim.sgd import Optimizer as JOptimizer  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.core import losses as tlosses  # noqa: E402
from repro_torch.data import tokens as ttokens  # noqa: E402
from repro_torch.launch import lm_steps  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.layers import tree_map  # noqa: E402

TOL = 2e-4
SGD_LR = 0.05
B, S = 4, 64
HEAVY_ARCHS = {"deepseek-v3-671b", "xlstm-1.3b", "codeqwen1.5-7b"}
ARCH_PARAMS = [pytest.param(a, marks=pytest.mark.slow) if a in HEAVY_ARCHS
               else a for a in ARCH_IDS]


def _flat(tree, prefix=""):
    """{path: leaf} of a tree of dicts (JAX or port)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _leaf_close(t, j, tol, name=""):
    """max |t - j| within tol of the reference's largest |value|."""
    t, j = _np(t), _np(j)
    assert t.shape == j.shape, (name, t.shape, j.shape)
    assert np.isfinite(t).all(), name
    err = float(np.abs(t - j).max()) if t.size else 0.0
    assert err <= tol * float(np.abs(j).max()), (name, err,
                                                 float(np.abs(j).max()))


def _trees_close(t, j, tol):
    ft, fj = _flat(t), _flat(j)
    assert ft.keys() == fj.keys()
    for k in fj:
        _leaf_close(ft[k], fj[k], tol, k)


# ------------------------------------------------------------------ CE
def _ce_inputs(seed, S_, mask):
    r = np.random.default_rng(seed)
    d, V = 32, 97
    h = r.normal(size=(2, S_, d)).astype(np.float32)
    w = (r.normal(size=(d, V)) * d ** -0.5).astype(np.float32)
    lbl = r.integers(0, V, (2, S_))
    m = (r.random((2, S_)) < 0.7) if mask else None
    return h, w, lbl, m


@pytest.mark.parametrize("beta", [1.0, 2.0])
@pytest.mark.parametrize("mask", [False, True], ids=["nomask", "mask"])
def test_weighted_ce_and_grad_match_jax(beta, mask):
    h, w, lbl, m = _ce_inputs(0, 48, mask)
    logits = h @ w
    jm = None if m is None else jnp.asarray(m)
    jv, jg = jax.value_and_grad(
        lambda x: jlosses.weighted_ce(x, jnp.asarray(lbl), beta, jm))(
        jnp.asarray(logits))
    tl = torch.from_numpy(logits).requires_grad_(True)
    tv = tlosses.weighted_ce(tl, torch.from_numpy(lbl), beta,
                             None if m is None else torch.from_numpy(m))
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    _leaf_close(tl.grad, jg, TOL)


@pytest.mark.parametrize("S_", [1024, 300], ids=["two_chunks", "one_chunk"])
@pytest.mark.parametrize("beta", [1.0, 2.0])
@pytest.mark.parametrize("mask", [False, True], ids=["nomask", "mask"])
def test_chunked_weighted_ce_and_grads_match_jax(S_, beta, mask):
    h, w, lbl, m = _ce_inputs(1, S_, mask)
    jm = None if m is None else jnp.asarray(m)
    jv, (jgh, jgw) = jax.value_and_grad(
        lambda a, b: jlosses.chunked_weighted_ce(a, b, jnp.asarray(lbl),
                                                 beta, jm),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    th = torch.from_numpy(h).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    tm = None if m is None else torch.from_numpy(m)
    tv = tlosses.chunked_weighted_ce(th, tw, torch.from_numpy(lbl), beta, tm)
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    _leaf_close(th.grad, jgh, TOL)
    _leaf_close(tw.grad, jgw, TOL)
    # the chunked CE is weighted_ce of the full logits
    full = tlosses.weighted_ce(torch.from_numpy(h @ w), torch.from_numpy(lbl),
                               beta, tm)
    np.testing.assert_allclose(float(tv.detach()), float(full), rtol=1e-5)


# ------------------------------------------------------------------ tokens
def test_zipf_and_delay_pattern_are_bit_equal():
    a = jtokens.zipf_tokens(np.random.default_rng(3), (3, 4, 50), 1000)
    b = ttokens.zipf_tokens(np.random.default_rng(3), (3, 4, 50), 1000)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jtokens.apply_delay_pattern(a, 7),
                                  ttokens.apply_delay_pattern(b, 7))
    np.testing.assert_array_equal(jtokens.undelay_pattern(a),
                                  ttokens.undelay_pattern(b))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_make_lm_batch_is_bit_equal(arch):
    for reduced in (True, False):
        jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
        if reduced:
            jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
        seq = 64 if reduced else 3000
        a = jtokens.make_lm_batch(jcfg, 2, seq, seed=5)
        b = ttokens.make_lm_batch(tcfg, 2, seq, seed=5)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


# ------------------------------------------------------------------ attention
def test_chunked_plain_attention_under_checkpoint_matches_jax():
    r = np.random.default_rng(4)
    S_, H, Hkv, hd = tattn.CHUNK_THRESHOLD, 2, 1, 16
    q = r.normal(size=(1, S_, H, hd)).astype(np.float32)
    k = r.normal(size=(1, S_, Hkv, hd)).astype(np.float32)
    v = r.normal(size=(1, S_, Hkv, hd)).astype(np.float32)
    c = r.normal(size=(1, S_, H, hd)).astype(np.float32)
    scale = hd ** -0.5

    def jf(q, k, v):
        o = jattn._causal_attend(q, k, v, scale, 0, jnp.float32)
        return jnp.sum(o * c), o
    (_, jo), jg = jax.value_and_grad(jf, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    o = tattn._causal_attend_plain(tq, tk, tv, scale, 0, torch.float32)
    torch.sum(o * torch.from_numpy(c)).backward()
    _leaf_close(o, jo, TOL)
    for t, j in zip((tq, tk, tv), jg):
        _leaf_close(t.grad, j, TOL)
    with torch.no_grad():
        o2 = tattn._causal_attend_plain(tq, tk, tv, scale, 0, torch.float32)
    assert torch.equal(o, o2)


# ------------------------------------------------------------------ train step
@pytest.fixture(scope="module")
def models():
    """arch -> (JAX cfg, port cfg, JAX params, port params), fp32."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg = jreg.get_config(arch).reduced()
            tcfg = treg.get_config(arch).reduced()
            jp = jtf.init_model(jax.random.PRNGKey(1), jcfg)
            tp = ttf.params_from_numpy(jax.tree.map(np.asarray, jp))
            cache[arch] = (jcfg, tcfg, jp, tp)
        return cache[arch]
    return get


def _batches(cfg, seed):
    nb = jtokens.make_lm_batch(cfg, B, S, seed)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    tb = {k: torch.from_numpy(v).long() if v.dtype.kind == "i"
          else torch.from_numpy(v) for k, v in nb.items()}
    return jb, tb


# an optimizer whose new state is the gradient tree: the step's grads read
# out unchanged, the params left where they were
_JGRAB = JOptimizer(lambda p: jax.tree.map(jnp.zeros_like, p),
                    lambda g, s, p, lr: (jax.tree.map(jnp.zeros_like, g), g))


def _step_grads(models, arch, microbatches, accum_j=jnp.float32,
                accum_t=torch.float32, seed=0):
    jcfg, tcfg, jp, tp = models(arch)
    jb, tb = _batches(jcfg, seed)
    jstep = jax.jit(jtf.make_train_step(jcfg, _JGRAB, dtype=jnp.float32,
                                        microbatches=microbatches,
                                        accum_dtype=accum_j))
    _, jg, jm = jstep(jp, _JGRAB.init(jp), jb, jnp.float32(0))
    loss, parts, tg = ttf.accumulate_grads(tp, tb, tcfg, dtype=torch.float32,
                                           microbatches=microbatches,
                                           accum_dtype=accum_t)
    return jg, jm, tg, {"loss": loss, **parts}


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ARCH_PARAMS)
def test_train_step_loss_and_grads_match_jax(models, arch, microbatches):
    jg, jm, tg, tm = _step_grads(models, arch, microbatches)
    for k in ("loss", "ce", "aux"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=TOL,
                                   atol=TOL * abs(float(jm["loss"])))
    _trees_close(tg, jg, TOL)


@pytest.mark.parametrize("arch", ARCH_PARAMS)
def test_sgd_train_step_matches_jax_end_to_end(models, arch):
    jcfg, tcfg, jp, tp = models(arch)
    jb, tb = _batches(jcfg, 1)
    jstep = jax.jit(jtf.make_train_step(jcfg, joptim.sgd(), dtype=jnp.float32,
                                        microbatches=2))
    jp2, _, jm = jstep(jp, (), jb, jnp.float32(SGD_LR))
    tstep = ttf.make_train_step(tcfg, toptim.sgd(), dtype=torch.float32,
                                microbatches=2)
    mine = tree_map(torch.clone, tp)
    tp2, _, tm = tstep(mine, (), tb, SGD_LR)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    ft, fj = _flat(tp2), _flat(jp2)
    assert ft.keys() == fj.keys()
    for k in fj:
        np.testing.assert_allclose(_np(ft[k]), _np(fj[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    # the step updates the given tensors in place
    assert all(a is b for a, b in zip(_flat(tp2).values(),
                                      _flat(mine).values()))


@pytest.mark.parametrize("arch", [
    "dbrx-132b", pytest.param("deepseek-v3-671b", marks=pytest.mark.slow)])
def test_bf16_gradient_accumulator_matches_jax(models, arch):
    jg, jm, tg, tm = _step_grads(models, arch, 2, jnp.bfloat16,
                                 torch.bfloat16, seed=2)
    for leaf in _flat(tg).values():
        assert leaf.dtype == torch.bfloat16
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=TOL)
    _trees_close(tg, jg, 2e-2)


def test_mtp_loss_matches_jax(models):
    jcfg, tcfg, jp, tp = models("deepseek-v3-671b")
    nb = jtokens.make_lm_batch(jcfg, 2, 64, seed=3)
    h = np.random.default_rng(3).normal(size=(2, 64, jcfg.d_model)
                                        ).astype(np.float32)
    jv, (jgp, jgh) = jax.value_and_grad(
        lambda p, x: jtf._mtp_loss(p, x, {"labels": jnp.asarray(
            nb["labels"])}, jcfg, 2.0), argnums=(0, 1))(jp, jnp.asarray(h))
    leaves = _flat(tp)
    live = {k: v.clone().requires_grad_(True) for k, v in leaves.items()}

    def rebuild(node, prefix=""):
        return {k: rebuild(v, f"{prefix}{k}/") if isinstance(v, dict)
                else live[f"{prefix}{k}"] for k, v in node.items()}
    tree = rebuild(tp)
    th = torch.from_numpy(h).requires_grad_(True)
    tv = ttf._mtp_loss(tree, th, {"labels": torch.from_numpy(nb["labels"])
                                  .long()}, tcfg, 2.0)
    grads = torch.autograd.grad(tv, list(live.values()) + [th],
                                allow_unused=True)
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=TOL)
    _leaf_close(grads[-1], jgh, TOL, "h")
    fj = _flat(jgp)
    for (k, t), g in zip(live.items(), grads[:-1]):
        _leaf_close(torch.zeros_like(t) if g is None else g, fj[k], TOL, k)


@pytest.mark.parametrize("arch", ["qwen3-14b", "dbrx-132b", "zamba2-7b",
                                  "xlstm-1.3b", "musicgen-medium",
                                  "llava-next-34b"])
def test_remat_gives_the_same_loss_and_grads(models, arch):
    _, tcfg, _, tp = models(arch)
    _, tb = _batches(models(arch)[0], 4)
    l1, p1, g1 = ttf.value_and_grad(tp, tb, tcfg, dtype=torch.float32,
                                    remat=True)
    l0, p0, g0 = ttf.value_and_grad(tp, tb, tcfg, dtype=torch.float32,
                                    remat=False)
    assert torch.equal(l1, l0)
    for k, v in _flat(g1).items():
        assert torch.equal(v, _flat(g0)[k]), k


def test_forward_without_head_returns_h_only(models):
    _, tcfg, _, tp = models("qwen3-14b")
    _, tb = _batches(models("qwen3-14b")[0], 5)
    with torch.no_grad():
        logits, _, (_, h, _) = ttf.forward(tp, tb, tcfg, dtype=torch.float32,
                                           attn_impl="torch")
        none, _, (_, h2, _) = ttf.forward(tp, tb, tcfg, dtype=torch.float32,
                                          attn_impl="torch", head=False)
    assert none is None and torch.equal(h, h2)
    assert torch.equal(logits, torch.matmul(h, tp["lm_head"]))


# ------------------------------------------------------------------ command
@pytest.mark.parametrize("argv", [
    ["--arch", "qwen1.5-0.5b", "--steps", "3", "--lr", "1e-3"],
    ["--arch", "dbrx-132b", "--steps", "4", "--pods", "2",
     "--inner-steps", "2", "--microbatches", "2"],
], ids=["steps", "local_sgd"])
def test_train_command_on_the_cpu(capsys, argv):
    lm_steps.main(["--train", "--device", "cpu", "--reduced", "--batch", "2",
                   "--prompt-len", "32", *argv])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu" and out["flash_launches"] == 0
    assert out["peak_gib"] is None and out["peak_share"] is None
    if out["pods"] == 1:
        assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
        assert out["losses"][-1] < out["losses"][0]
    else:
        assert len(out["round_ms"]) == 2
        assert np.asarray(out["pod_losses"]).shape == (2, 2, 2)
        assert all(d > 0 for d in out["drift"])


def test_build_train_step_follows_the_arch_table():
    for arch in ARCH_IDS:
        cfg = treg.get_config(arch).reduced()
        opt, _ = lm_steps.build_train_step(cfg)
        state = opt.init({"w": torch.zeros(3, 2)})
        if arch in lm_steps.ADAFACTOR_ARCHS:
            assert isinstance(state[0]["w"], tuple)      # factors
        else:
            assert len(state) == 3                       # adam (m, v, t)
    assert lm_steps.MICROBATCHES["qwen3-14b"] == 4
