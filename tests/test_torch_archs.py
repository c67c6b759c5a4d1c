"""The port's decoder against the JAX package's for the eight architectures
of the later slice, from the same weights.

JAX makes the parameters of each ``.reduced()`` config (torch cannot
replay ``jax.random``); they cross as numpy arrays through
``transformer.params_from_numpy``.  MoE (dbrx, deepseek with MLA and MTP),
the Mamba2 hybrid (zamba2), xLSTM, VLM (llava, media prepended) and audio
(musicgen, 4 codebooks), and the two dense configs (codeqwen, qwen2).  At
fp32, every output within 2e-4 of the reference's largest |value|, the
tolerance ``tests/test_torch_transformer.py`` holds the dense decoder to:

* the parameter tree: keys and shapes equal to JAX's, for the JAX-made
  tree and for the port's own ``init_model``;
* ``forward`` logits and the MoE aux loss on the plain route;
* the kernel route (the flash kernel's plain version on the CPU) against
  JAX with ``USE_FLASH_KERNEL`` (the Pallas kernel in interpret mode) at
  S = 128;
* a prefill of S - 3 tokens into ``init_cache`` trees, then 3
  ``decode_step``s, against JAX's ``forward(caches=...)`` then
  ``decode_step``.
"""
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

B = 2
TOL = 2e-4
ARCHS = ["codeqwen1.5-7b", "qwen2-72b", "dbrx-132b", "deepseek-v3-671b",
         "zamba2-7b", "xlstm-1.3b", "llava-next-34b", "musicgen-medium"]


@functools.lru_cache(maxsize=None)
def _model(arch, seed=0):
    jcfg = jreg.get_config(arch).reduced()
    tcfg = treg.get_config(arch).reduced()
    jp = jtf.init_model(jax.random.PRNGKey(seed), jcfg)
    tp = ttf.params_from_numpy(jax.tree.map(np.asarray, jp))
    return jcfg, tcfg, jp, tp


def _batch(cfg, S, seed):
    """(numpy batch, JAX batch, torch batch) of total length S."""
    r = np.random.default_rng(seed)
    if cfg.arch_type == "audio":
        toks = r.integers(0, cfg.vocab_size, (B, cfg.frontend.n_codebooks, S))
        nb = {"tokens": toks}
    elif cfg.arch_type == "vlm":
        nm = cfg.frontend.n_media_tokens
        nb = {"tokens": r.integers(0, cfg.vocab_size, (B, S - nm)),
              "media": r.normal(size=(B, nm, cfg.frontend.embed_dim)
                                ).astype(np.float32)}
    else:
        nb = {"tokens": r.integers(0, cfg.vocab_size, (B, S))}
    jb = {k: jnp.asarray(v, jnp.int32 if k == "tokens" else jnp.float32)
          for k, v in nb.items()}
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    return nb, jb, tb


def _close(t, j, tol=TOL):
    """max |t - j| within tol of the reference's largest |value|."""
    t = t.detach().float().numpy()
    j = np.asarray(j, np.float32)
    assert t.shape == j.shape
    assert np.isfinite(t).all()
    err = float(np.abs(t - j).max())
    assert err <= tol * max(float(np.abs(j).max()), 1e-30), err


def _shapes(tree):
    return {jax.tree_util.keystr(k): tuple(np.shape(v)) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


# ------------------------------------------------------------------ tree
@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_jax(arch):
    jcfg, tcfg, jp, tp = _model(arch)
    mine = ttf.init_model(torch.Generator().manual_seed(0), tcfg)
    want = _shapes(jp)
    assert _shapes(tp) == want
    assert _shapes(mine) == want
    module = ttf.Transformer(tcfg, tp)
    assert sum(p.numel() for p in module.parameters()) == \
        sum(int(np.prod(s)) for s in want.values())


# ------------------------------------------------------------------ forward
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_plain_route_matches_jax(arch):
    jcfg, tcfg, jp, tp = _model(arch)
    _, jb, tb = _batch(tcfg, 64, 1)
    want, jaux, (_, jh, jmask) = jtf.forward(jp, jb, jcfg, dtype=jnp.float32,
                                             remat=False)
    got, aux, (_, h, mask) = ttf.forward(tp, tb, tcfg, dtype=torch.float32,
                                         remat=False, attn_impl="torch")
    _close(got, want)
    _close(h, jh)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5,
                               atol=1e-7)
    if tcfg.arch_type == "moe":
        assert float(aux) > 0
    if tcfg.arch_type == "vlm":
        assert np.array_equal(mask.numpy(), np.asarray(jmask))
    else:
        assert mask is None and jmask is None


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_kernel_route_matches_jax_flash_path(arch):
    jcfg, tcfg, jp, tp = _model(arch)
    _, jb, tb = _batch(tcfg, 128, 2)
    jattn.USE_FLASH_KERNEL = True
    try:
        want, _, _ = jtf.forward(jp, jb, jcfg, dtype=jnp.float32,
                                 remat=False)
    finally:
        jattn.USE_FLASH_KERNEL = False
    module = ttf.Transformer(tcfg, tp)
    got, _, _ = module(tb, dtype=torch.float32)
    _close(got, want)


# ------------------------------------------------------------------ decode
S_DEC = 64


def _prefill_batch(nb):
    """The batch without its last 3 text tokens, which decode feeds."""
    n_text = nb["tokens"].shape[-1]
    return {k: (v[..., :n_text - 3] if k == "tokens" else v)
            for k, v in nb.items()}


@functools.lru_cache(maxsize=None)
def _jax_prefill_decode(arch):
    """JAX's prefill of S_DEC - 3 tokens, then 3 decode steps: (prefill
    logits, aux, the filled caches by path, the steps' logits); shared by
    both routes of the port."""
    jcfg, _, jp, _ = _model(arch)
    nb, _, _ = _batch(jcfg, S_DEC, 3)
    jc = jtf.init_cache(jcfg, B, S_DEC, dtype=jnp.float32)
    jl, jaux, (jc, _, _) = jtf.forward(
        jp, {k: jnp.asarray(v) for k, v in _prefill_batch(nb).items()},
        jcfg, dtype=jnp.float32, caches=jc, remat=False)
    filled = jax.tree_util.tree_flatten_with_path(jc)[0]
    n_text = nb["tokens"].shape[-1]
    steps = []
    for t in range(3):
        tok = nb["tokens"][..., n_text - 3 + t:n_text - 2 + t]
        sl, jc = jtf.decode_step(jp, jc, {"tokens": jnp.asarray(tok)},
                                 jnp.int32(S_DEC - 3 + t), jcfg,
                                 dtype=jnp.float32)
        steps.append(sl)
    return jl, float(jaux), filled, steps


@pytest.mark.parametrize("attn_impl", ["kernel", "torch"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_jax(arch, attn_impl):
    jl, jaux, jfilled, jsteps = _jax_prefill_decode(arch)
    _, tcfg, _, tp = _model(arch)
    nb, _, _ = _batch(tcfg, S_DEC, 3)
    tc = ttf.init_cache(tcfg, B, S_DEC, dtype=torch.float32)
    tl, aux, (tc2, _, _) = ttf.forward(
        tp, {k: torch.from_numpy(v) for k, v in _prefill_batch(nb).items()},
        tcfg, dtype=torch.float32, caches=tc, remat=False,
        attn_impl=attn_impl)
    assert tc2 is tc                                      # filled in place
    _close(tl, jl)
    np.testing.assert_allclose(float(aux), jaux, rtol=1e-5, atol=1e-7)
    tflat = dict(jax.tree_util.tree_flatten_with_path(tc)[0])
    assert len(jfilled) == len(tflat)
    for path, jv in jfilled:
        _close(tflat[path], jv)
    n_text = nb["tokens"].shape[-1]
    for t, want in enumerate(jsteps):
        tok = nb["tokens"][..., n_text - 3 + t:n_text - 2 + t]
        tl, tc = ttf.decode_step(tp, tc, {"tokens": torch.from_numpy(tok)},
                                 S_DEC - 3 + t, tcfg, dtype=torch.float32)
        _close(tl, want)


# ------------------------------------------------------------------ launch
@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_lm_steps_main_runs_every_arch_on_the_cpu(arch, capsys):
    """``launch/lm_steps.py`` end to end on the CPU for every architecture
    id (reduced, bf16 weights): the plain versions run (0 flash
    launches), and the greedy tokens have the family's shape."""
    from repro_torch.launch import lm_steps
    lm_steps.main(["--arch", arch, "--device", "cpu", "--reduced",
                   "--prompt-len", "40", "--new-tokens", "2"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cfg = treg.get_config(arch).reduced()
    assert out["arch"] == cfg.name and out["flash_launches"] == 0
    toks = np.asarray(out["tokens"])
    want = ((cfg.frontend.n_codebooks, 2) if cfg.arch_type == "audio"
            else (2,))
    assert toks.shape == want
    assert ((0 <= toks) & (toks < cfg.vocab_size)).all()
