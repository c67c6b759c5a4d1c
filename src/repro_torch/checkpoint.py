"""Checkpointing: save/restore trees of tensors in the JAX package's format.

Flat-key ``.npz`` (no pickle, safe to load): each leaf under its ``/``-joined
tree path (dict keys in sorted order, list indices as numbers), optional
JSON metadata under ``__metadata__``, bfloat16 leaves stored as a uint16
view under a ``__bf16__``-suffixed key.  Files written by either package
load in the other.

* Paths are normalized to carry the ``.npz`` suffix (``np.savez`` appends it
  silently, so ``save("ckpt")`` + ``restore("ckpt")`` would otherwise miss).
* Two distinct tree paths that join to the same key, or a leaf keyed by the
  reserved ``__metadata__``, raise ``ValueError`` instead of silently
  overwriting each other in the archive.
* Writes are atomic (tmp file + ``os.replace``), so a registry polling the
  path sees the previous complete checkpoint or the new one.
"""
from __future__ import annotations

import glob as _glob
import json
import os
import zipfile
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

_SEP = "/"
_BF16_TAG = "__bf16__"
_META_KEY = "__metadata__"


def _normalize(path) -> Path:
    path = Path(path)
    if path.suffix != ".npz":
        path = path.with_name(path.name + ".npz")
    return path


def _leaves_with_path(tree, prefix=()) -> List[Tuple[Tuple, object]]:
    """(key path, leaf) pairs in JAX's flatten order: dict keys sorted,
    lists and tuples by index, anything else a leaf."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_leaves_with_path(tree[k], prefix + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out.extend(_leaves_with_path(v, prefix + (i,)))
        return out
    return [(prefix, tree)]


def _join(kp) -> str:
    return _SEP.join(str(k) for k in kp)


def _to_numpy(leaf) -> Tuple[np.ndarray, bool]:
    """(host array, is_bf16); a bf16 leaf comes back as its uint16 view."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), True
        return t.numpy(), False
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return arr.view(np.uint16), True
    return arr, False


def _flatten(tree) -> Dict[str, np.ndarray]:
    out = {}
    for kp, leaf in _leaves_with_path(tree):
        key = _join(kp)
        if key == _META_KEY:
            raise ValueError(
                f"tree leaf keyed {_META_KEY!r} collides with the reserved "
                "metadata entry — rename the leaf")
        arr, bf16 = _to_numpy(leaf)
        if bf16:
            key += _BF16_TAG
        if key in out:
            raise ValueError(
                f"distinct tree paths flatten to the same key {key!r} "
                "(a dict key containing '/', or a bf16 leaf shadowing "
                f"an explicit '*{_BF16_TAG}' key) — the checkpoint would "
                "silently drop one of them")
        out[key] = arr
    return out


def save(path, tree, metadata=None):
    """Write a tree checkpoint to ``path`` (.npz appended if missing),
    atomically."""
    path = _normalize(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    flat = _flatten(tree)
    if metadata is not None:
        flat[_META_KEY] = np.frombuffer(
            json.dumps(metadata).encode(), dtype=np.uint8)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:           # savez on a handle keeps the name
        np.savez(f, **flat)
    os.replace(tmp, path)


def load_arrays(path):
    """Every leaf of a checkpoint as a CPU tensor keyed by its ``/``-joined
    tree path (bf16-tagged entries decoded back to bfloat16), plus the
    metadata dict (None when absent)."""
    out = {}
    with np.load(_normalize(path), allow_pickle=False) as data:
        for key in data.files:
            if key == _META_KEY:
                continue
            arr = data[key]
            if key.endswith(_BF16_TAG):
                out[key[:-len(_BF16_TAG)]] = torch.from_numpy(
                    arr.view(np.int16)).view(torch.bfloat16)
            else:
                out[key] = torch.from_numpy(arr)
        meta = (json.loads(bytes(data[_META_KEY]).decode())
                if _META_KEY in data.files else None)
    return out, meta


def unflatten_like(like, flat, prefix: str = ""):
    """Rebuild a tree with ``like``'s structure from a flat key -> tensor
    dict (the ``load_arrays`` view), reading each leaf at ``prefix +
    keypath`` and casting it to the template leaf's dtype and device.
    Raises ``KeyError`` on missing leaves and ``ValueError`` on shape
    mismatches."""
    def build(node, kp):
        if isinstance(node, dict):
            return {k: build(v, kp + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v, kp + (i,)) for i, v in enumerate(node))
        key = prefix + _join(kp)
        if key not in flat:
            raise KeyError(f"checkpoint is missing leaf {key!r}")
        arr = flat[key]
        if not isinstance(arr, torch.Tensor):
            arr = torch.from_numpy(np.asarray(arr))
        if tuple(arr.shape) != tuple(node.shape):
            raise ValueError(f"shape mismatch for {key}: "
                             f"{tuple(arr.shape)} vs {tuple(node.shape)}")
        return arr.to(device=node.device, dtype=node.dtype)
    return build(like, ())


def restore(path, like):
    """Load a checkpoint into the structure of ``like`` (a template tree)."""
    flat, _ = load_arrays(path)
    return unflatten_like(like, flat)


def metadata(path):
    return load_arrays(path)[1]


# ---------------------------------------------------------- publish polling
def generation(path) -> int:
    """Publish generation of a checkpoint, from its metadata alone (npz
    members load lazily, so the arrays are never read).

    ``metadata["generation"]`` (the FL training loop's global
    executed-round counter) first, ``rounds_done`` for older snapshots;
    -1 when the checkpoint carries neither or has no metadata.
    """
    with np.load(_normalize(path), allow_pickle=False) as data:
        if _META_KEY not in data.files:
            return -1
        meta = json.loads(bytes(data[_META_KEY]).decode())
    g = meta.get("generation", meta.get("rounds_done"))
    return -1 if g is None else int(g)


def latest(path_glob) -> Optional[Tuple[Path, int]]:
    """``(path, generation)`` of the highest-generation checkpoint matching
    the glob; ``None`` when nothing readable matches.  Unreadable files (a
    half-written archive from a non-atomic writer) are skipped; ties break
    toward the lexicographically last path so concurrent pollers agree."""
    best: Optional[Tuple[Path, int]] = None
    for p in sorted(_glob.glob(str(path_glob))):
        try:
            g = generation(p)
        except (OSError, ValueError, KeyError, zipfile.BadZipFile,
                json.JSONDecodeError):
            continue
        if best is None or g >= best[1]:
            best = (Path(p), g)
    return best
