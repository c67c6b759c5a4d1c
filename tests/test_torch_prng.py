"""The port's threefry PRNG (``repro_torch/core/prng.py``) against
``jax.random`` on the CPU.

Keys (``PRNGKey``, ``fold_in``, ``split``), ``bits``, ``uniform`` and
``randint`` must be bit-equal, for Python keys and batches of tensor keys,
over several seeds and 0-d, 1-d and 3-d shapes, one of them more than
10^5 draws.  ``normal`` is ``sqrt(2) * erfinv(u)`` on a bit-equal ``u``;
torch's ``erfinv`` differs from XLA's polynomial, and the bound measured on
3e5 draws is: at most 96 ulp and 1e-5 of ``|x|`` apart (91 ulp and 5.8e-6
seen, in the tail near |x| = 3.76), 99 % of draws within 8 ulp.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.core import prng  # noqa: E402

SEEDS = (0, 7, 123_456, 2 ** 31 - 1)
SHAPES = ((), (7,), (3, 4, 5), (100_003,))


def _key(seed):
    """The same derived key in both: a fold of the seed's key."""
    return (jax.random.fold_in(jax.random.PRNGKey(seed), 42),
            prng.fold_in(prng.PRNGKey(seed), 42))


def _u32(a):
    return np.asarray(a).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS + (-1, 2 ** 32 - 1))
def test_prngkey_fold_in_and_split_match_jax(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    assert tk == tuple(_u32(jk).tolist())
    for d in (0, 1, 3, 0x5EC0A6, 2 ** 32 - 1):
        assert prng.fold_in(tk, d) == tuple(
            _u32(jax.random.fold_in(jk, d)).tolist())
    jf, tf = jax.random.fold_in(jk, 9), prng.fold_in(tk, 9)
    js = _u32(jax.random.split(jf, 6))
    assert [list(k) for k in prng.split(tf, 6)] == js.tolist()
    # tensor keys: a batch of keys folds and splits elementwise
    np.testing.assert_array_equal(prng.split(prng.as_tensor(tf), 6).numpy(),
                                  js)
    np.testing.assert_array_equal(
        prng.fold_in(tf, torch.arange(5)).numpy(),
        _u32(jax.vmap(jax.random.fold_in, (None, 0))(jf, jnp.arange(5))))
    np.testing.assert_array_equal(
        prng.fold_in(torch.from_numpy(js), torch.arange(6)).numpy(),
        _u32(jax.vmap(jax.random.fold_in)(jax.random.split(jf, 6),
                                          jnp.arange(6))))
    np.testing.assert_array_equal(
        prng.split(torch.from_numpy(js), 3).numpy(),
        _u32(jax.vmap(lambda k: jax.random.split(k, 3))(
            jax.random.split(jf, 6))))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_uniform_and_randint_are_bit_equal(seed, shape):
    jk, tk = _key(seed)
    np.testing.assert_array_equal(prng.bits(tk, shape).numpy(),
                                  _u32(jax.random.bits(jk, shape)))
    u = prng.uniform(tk, shape)
    assert u.dtype == torch.float32 and tuple(u.shape) == shape
    np.testing.assert_array_equal(
        u.numpy().view(np.int32),
        np.asarray(jax.random.uniform(jk, shape)).view(np.int32))
    lo = np.float32(-0.25)
    np.testing.assert_array_equal(
        prng.uniform(tk, shape, minval=float(lo), maxval=3.0).numpy()
        .view(np.int32),
        np.asarray(jax.random.uniform(jk, shape, minval=lo, maxval=3.0))
        .view(np.int32))
    # the masker's ring draws, then spans that need the second draw
    for lo, hi in ((0, 256), (0, 64), (-5, 1_000_003), (3, 3), (7, 2),
                   (0, 2 ** 31 - 1), (-2 ** 31, 2 ** 31 - 1)):
        np.testing.assert_array_equal(
            prng.randint(tk, shape, lo, hi).numpy(),
            np.asarray(jax.random.randint(jk, shape, lo, hi)))


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_batched_tensor_keys_match_vmapped_jax(seed):
    """A (4, 3, 2) batch of keys draws a (4, 3, *shape) batch: the
    transforms draw for every client and leaf at once this way."""
    jks = jax.random.split(jax.random.PRNGKey(seed), 12).reshape(4, 3, 2)
    tks = torch.from_numpy(_u32(jks))
    vv = lambda f: jax.vmap(jax.vmap(f))  # noqa: E731
    np.testing.assert_array_equal(
        prng.bits(tks, (5, 2)).numpy(),
        _u32(vv(lambda k: jax.random.bits(k, (5, 2)))(jks)))
    np.testing.assert_array_equal(
        prng.uniform(tks, (5, 2)).numpy().view(np.int32),
        np.asarray(vv(lambda k: jax.random.uniform(k, (5, 2)))(jks))
        .view(np.int32))
    np.testing.assert_array_equal(
        prng.randint(tks, (5, 2), 0, 256).numpy(),
        np.asarray(vv(lambda k: jax.random.randint(k, (5, 2), 0, 256))(jks)))


def test_normal_within_its_stated_bound():
    for seed in (0, 1, 2):
        jk, tk = _key(seed)
        want = np.asarray(jax.random.normal(jk, (100_000,)))
        got = prng.normal(tk, (100_000,)).numpy()
        assert got.dtype == np.float32
        ulp = np.abs(got.view(np.int32).astype(np.int64)
                     - want.view(np.int32).astype(np.int64))
        assert ulp.max() <= 96
        assert np.percentile(ulp, 99) <= 8
        assert (np.abs(got - want) <= 1e-5 * np.abs(want)).all()
    jk, tk = _key(5)
    np.testing.assert_allclose(prng.normal(tk, (3, 4, 5)).numpy(),
                               np.asarray(jax.random.normal(jk, (3, 4, 5))),
                               rtol=1e-5, atol=0)


def test_threefry_matches_the_published_known_answer():
    """Random123's known-answer vectors for Threefry-2x32, 20 rounds."""
    assert prng.threefry2x32(0, 0, 0, 0) == (0x6B200159, 0x99BA4EFE)
    assert prng.threefry2x32(0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF,
                             0xFFFFFFFF) == (0x1CB996FC, 0xBB002BE7)
    assert prng.threefry2x32(0x13198A2E, 0x03707344, 0x243F6A88,
                             0x85A308D3) == (0xC4923A9C, 0x483DF7A0)


def test_keys_and_bounds_are_checked():
    with pytest.raises(OverflowError):
        prng.PRNGKey(2 ** 32)
    with pytest.raises(OverflowError):
        prng.randint(prng.PRNGKey(0), (2,), 0, 2 ** 31)
    # a Python key derives on the host: no tensor until a draw
    assert isinstance(prng.split(prng.fold_in(prng.PRNGKey(3), 1), 2)[1],
                      tuple)
