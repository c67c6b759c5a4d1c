"""The port's checkpoint format against the JAX package's, both directions.

A file written by either package (fp32, int and bf16 leaves, nested lists,
metadata, generation) must load in the other with the same keys, bits and
metadata; ``generation``/``latest`` must agree; and the error cases must
raise the same exception types.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jck  # noqa: E402
from repro_torch import checkpoint as tck  # noqa: E402


def _arrays(seed=0):
    r = np.random.default_rng(seed)
    return {"w": r.normal(size=(3, 4)).astype(np.float32),
            "steps": np.arange(5, dtype=np.int32),
            "bf": r.normal(size=(6,)).astype(np.float32),
            "layers": [r.normal(size=(2,)).astype(np.float32),
                       r.normal(size=(2, 2)).astype(np.float32)]}


def _jax_tree(a):
    return {"w": jnp.asarray(a["w"]), "steps": jnp.asarray(a["steps"]),
            "bf": jnp.asarray(a["bf"], jnp.bfloat16),
            "layers": [jnp.asarray(x) for x in a["layers"]]}


def _torch_tree(a):
    return {"w": torch.from_numpy(a["w"]),
            "steps": torch.from_numpy(a["steps"]),
            "bf": torch.from_numpy(a["bf"]).to(torch.bfloat16),
            "layers": [torch.from_numpy(x) for x in a["layers"]]}


def _bits(x):
    """Raw bits of a JAX array or torch tensor, bf16 included."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x).numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


META = {"generation": 7, "cluster": 1, "note": "x"}


def test_jax_written_loads_in_port(tmp_path):
    a = _arrays(1)
    jck.save(tmp_path / "j", _jax_tree(a), metadata=META)
    flat, meta = tck.load_arrays(tmp_path / "j")
    jflat, jmeta = jck.load_arrays(tmp_path / "j")
    assert meta == jmeta == META
    assert sorted(flat) == sorted(jflat) == [
        "bf", "layers/0", "layers/1", "steps", "w"]
    assert flat["bf"].dtype == torch.bfloat16
    for k in flat:
        np.testing.assert_array_equal(_bits(flat[k]), _bits(jflat[k]))
    like = {k: torch.zeros_like(v) for k, v in _torch_tree(a).items()
            if k != "layers"}
    like["layers"] = [torch.zeros(2), torch.zeros(2, 2)]
    got = tck.restore(tmp_path / "j", like)
    np.testing.assert_array_equal(_bits(got["bf"]),
                                  _bits(_jax_tree(a)["bf"]))
    np.testing.assert_array_equal(got["layers"][1].numpy(), a["layers"][1])
    assert tck.generation(tmp_path / "j") == jck.generation(tmp_path / "j") == 7


def test_port_written_restores_in_jax(tmp_path):
    a = _arrays(2)
    tck.save(tmp_path / "t", _torch_tree(a), metadata=META)   # suffix added
    assert (tmp_path / "t.npz").exists()
    got = jck.restore(tmp_path / "t", _jax_tree(_arrays(9)))
    want = _jax_tree(a)
    for k in ("w", "steps", "bf"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]))
    for g, w in zip(got["layers"], want["layers"]):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert jck.metadata(tmp_path / "t") == tck.metadata(tmp_path / "t") == META


def test_generation_and_latest_agree(tmp_path):
    tree = {"w": np.zeros(2, np.float32)}
    jck.save(tmp_path / "r1", tree, metadata={"generation": 1})
    tck.save(tmp_path / "r3", tree, metadata={"generation": 3})
    jck.save(tmp_path / "r2", tree, metadata={"rounds_done": 2})
    tck.save(tmp_path / "r0", tree)
    (tmp_path / "half.npz").write_bytes(b"not a zip archive")   # torn write
    for name in ("r0", "r1", "r2", "r3"):
        assert tck.generation(tmp_path / name) == \
            jck.generation(tmp_path / name)
    glob = str(tmp_path / "*.npz")
    assert tck.latest(glob) == jck.latest(glob) == (tmp_path / "r3.npz", 3)
    tck.save(tmp_path / "r4", tree, metadata={"generation": 3})   # tie
    assert tck.latest(glob) == jck.latest(glob) == (tmp_path / "r4.npz", 3)
    assert tck.latest(str(tmp_path / "none*.npz")) is None


@pytest.mark.parametrize("case", ["metadata_leaf", "slash_collision"])
def test_save_refuses_colliding_keys_like_jax(tmp_path, case):
    x = np.zeros(2, np.float32)
    tree = ({"__metadata__": x} if case == "metadata_leaf"
            else {"a/b": x, "a": {"b": x}})
    with pytest.raises(ValueError):
        jck.save(tmp_path / "j", tree)
    with pytest.raises(ValueError):
        tck.save(tmp_path / "t", {k: (torch.from_numpy(v)
                                      if isinstance(v, np.ndarray)
                                      else {kk: torch.from_numpy(vv)
                                            for kk, vv in v.items()})
                                  for k, v in tree.items()})


@pytest.mark.parametrize("case,exc", [("missing", KeyError),
                                      ("shape", ValueError)])
def test_unflatten_errors_match_jax(tmp_path, case, exc):
    jck.save(tmp_path / "c", {"w": np.zeros((2, 3), np.float32)})
    jflat, _ = jck.load_arrays(tmp_path / "c")
    tflat, _ = tck.load_arrays(tmp_path / "c")
    if case == "missing":
        jlike, tlike = {"v": jnp.zeros((2, 3))}, {"v": torch.zeros(2, 3)}
    else:
        jlike, tlike = {"w": jnp.zeros((3, 2))}, {"w": torch.zeros(3, 2)}
    with pytest.raises(exc):
        jck.unflatten_like(jlike, jflat)
    with pytest.raises(exc):
        tck.unflatten_like(tlike, tflat)
