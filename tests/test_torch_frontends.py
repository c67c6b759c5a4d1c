"""The port's modality frontends (``repro_torch/models/frontends.py``) and
``layers.layer_norm`` against the JAX package's, from the same JAX-made
params, in fp32 at 2e-4 of the reference's largest |value|: the VLM
projector (GELU in the tanh form, ``jax.nn.gelu``'s default), the summed
codebook embeddings and the per-codebook heads; the init layouts; and in
bf16 the projector and embeddings within bf16's rounding."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import frontends as jfe  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import frontends as tfe  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.layers import tree_from_numpy  # noqa: E402


def _close(t, j, tol=2e-4):
    t, j = t.detach().float().numpy(), np.asarray(j, np.float32)
    assert t.shape == j.shape and np.isfinite(t).all()
    assert float(np.abs(t - j).max()) <= tol * float(np.abs(j).max())


def _pair(arch):
    return jreg.get_config(arch).reduced(), treg.get_config(arch).reduced()


def _shapes(tree):
    return {k: tuple(np.shape(v)) for k, v in tree.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_project_media_matches_jax(dtype):
    jcfg, tcfg = _pair("llava-next-34b")
    jp = jfe.init_projector(jax.random.PRNGKey(0), jcfg)
    tp = tree_from_numpy(jax.tree.map(np.asarray, jp))
    assert _shapes(tfe.init_projector(torch.Generator().manual_seed(0),
                                      tcfg)) == _shapes(jp)
    media = np.random.default_rng(0).normal(
        size=(2, jcfg.frontend.n_media_tokens, jcfg.frontend.embed_dim)
    ).astype(np.float32) * 2
    want = jfe.project_media(jp, jnp.asarray(media), getattr(jnp, dtype))
    got = tfe.project_media(tp, torch.from_numpy(media),
                            getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, 2e-4 if dtype == "float32" else 2e-2)


def test_codebooks_match_jax():
    jcfg, tcfg = _pair("musicgen-medium")
    jp = jfe.init_codebook_embeddings(jax.random.PRNGKey(1), jcfg)
    tp = tree_from_numpy(jax.tree.map(np.asarray, jp))
    mine = tfe.init_codebook_embeddings(torch.Generator().manual_seed(1),
                                        tcfg)
    assert _shapes(mine) == _shapes(jp)
    K = jcfg.frontend.n_codebooks
    codes = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, K, 9))
    for dt in ("float32", "bfloat16"):
        want = jfe.embed_codes(jp, jnp.asarray(codes), getattr(jnp, dt))
        got = tfe.embed_codes(tp, torch.from_numpy(codes),
                              getattr(torch, dt))
        _close(got, want, 2e-4 if dt == "float32" else 1e-2)
    h = np.random.default_rng(2).normal(size=(2, 9, jcfg.d_model)).astype(
        np.float32)
    want = jfe.codebook_logits(jp, jnp.asarray(h))
    got = tfe.codebook_logits(tp, torch.from_numpy(h))
    assert got.shape == (2, K, 9, jcfg.vocab_size)
    _close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    r = np.random.default_rng(5)
    x = (r.normal(size=(3, 7, 48)) * 4 + 1.5).astype(np.float32)
    scale = r.normal(size=(48,)).astype(np.float32)
    bias = r.normal(size=(48,)).astype(np.float32)
    want = jlayers.layer_norm(jnp.asarray(x, getattr(jnp, dtype)),
                              jnp.asarray(scale), jnp.asarray(bias))
    got = tlayers.layer_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                             torch.from_numpy(scale), torch.from_numpy(bias))
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, 1e-5 if dtype == "float32" else 1e-2)
