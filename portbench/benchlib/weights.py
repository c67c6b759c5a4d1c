"""Forecaster weights made from the seed on the device, in one draw.

The layout is the port's forecaster tree (``{"layers": [{"wx", "wh",
"b"}], "head": {"w", "b"}}``, ``wx (I, G*H)``, ``wh (H, G*H)``), the
scales those of its initialiser (fan-in ** -0.5, zero biases).  The
program and the reference are both handed copies of these tensors.
"""
from __future__ import annotations

import torch

from benchlib import data
from benchlib.arith import GATES

WEIGHTS_TAG = 7


def _shapes(cfg: dict):
    G, H = GATES[cfg["cell"]], cfg["hidden_dim"]
    inp, out = cfg["input_dim"], []
    for l in range(cfg["n_layers"]):
        out += [(("layers", l, "wx"), (inp, G * H), inp ** -0.5),
                (("layers", l, "wh"), (H, G * H), H ** -0.5),
                (("layers", l, "b"), (G * H,), 0.0)]
        inp = H
    out += [(("head", "w"), (H, cfg["horizon"]), H ** -0.5),
            (("head", "b"), (cfg["horizon"],), 0.0)]
    return out


def forecaster_params(seed: int, cfg: dict, n_models: int, device):
    """``n_models`` independent fp32 trees on ``device``."""
    shapes = _shapes(cfg)
    sizes = [torch.Size(s).numel() for _, s, _ in shapes]
    gen = torch.Generator(device=device)
    gen.manual_seed(data.sub_seed(seed, WEIGHTS_TAG))
    flat = torch.randn((n_models, sum(sizes)), generator=gen,
                       dtype=torch.float32, device=device)
    trees = []
    for m in range(n_models):
        parts = flat[m].split(sizes)
        tree = {"layers": [{} for _ in range(cfg["n_layers"])], "head": {}}
        for (path, shape, scale), p in zip(shapes, parts):
            leaf = (p * scale).reshape(shape).clone()
            if path[0] == "layers":
                tree["layers"][path[1]][path[2]] = leaf
            else:
                tree["head"][path[1]] = leaf
        trees.append(tree)
    return trees


def leaves(tree):
    """(name, tensor) of every leaf, in a fixed order."""
    out = []
    for l, p in enumerate(tree["layers"]):
        out += [(f"layers.{l}.{k}", p[k]) for k in ("wx", "wh", "b")]
    return out + [(f"head.{k}", tree["head"][k]) for k in ("w", "b")]


def to_numpy(tree):
    return {"layers": [{k: v.detach().cpu().numpy() for k, v in p.items()}
                       for p in tree["layers"]],
            "head": {k: v.detach().cpu().numpy()
                     for k, v in tree["head"].items()}}
