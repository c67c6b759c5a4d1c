"""The paper's demand forecasters (§3.2): stacked LSTM / GRU + linear head.

Univariate input: a look-back window of L normalized kWh readings, shape
(B, L, input_dim); output: (B, horizon), a multi-step direct forecast (the
paper's 8-step look-back / 4-step, 1 h, horizon).

Parameters are a plain dict tree with the JAX package's exact keys and
layouts, ``{"layers": [{"wx", "wh", "b"}], "head": {"w", "b"}}``, with
``wx (I, G*H)``, ``wh (H, G*H)``, ``b (G*H,)``, gates ``[i|f|g|o]`` (LSTM)
or ``[z|r|h~]`` (GRU) and no hidden bias.  They stay arguments, so the
serving registry can swap a whole tree at once.  ``cell_impl="kernel"``
runs each layer over the look-back in one call of the fused CUDA layer
(``kernels/lstm_cell.py::lstm_layer``, ``kernels/gru_cell.py::gru_layer``):
``n_layers`` launches per forecast.  ``cell_impl="torch"`` steps through the
plain cells one time step at a time (``kernels/ref.py::lstm_layer_ref``,
``gru_layer_ref``), so the two routes stay independent on the card.

Federated training runs every selected client's forward at once: the
params are client-stacked (a leading M on every leaf, one model per client)
and x is (M, B, L, input_dim); each layer is still one launch, with the
clients on the kernel's grid.  Both routes are differentiable (the kernel's
backward is the VJP of the plain layer).
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from repro_torch.configs.base import ForecasterConfig
from repro_torch.kernels import ref
from repro_torch.kernels.gru_cell import gru_layer
from repro_torch.kernels.lstm_cell import lstm_layer
from repro_torch.models.layers import dense_init, tree_from_numpy

# "kernel": one fused CUDA layer call per layer; "torch": the plain cells,
# step by step (on the CPU both compute the plain cells)
CELL_IMPLS = ("kernel", "torch")


# ------------------------------------------------------------------ init
def init_forecaster(generator: torch.Generator, cfg: ForecasterConfig,
                    dtype=torch.float32) -> Dict:
    """Random CPU weights from ``generator`` (same scale rule as the JAX
    package; the draws differ, since torch cannot replay ``jax.random``)."""
    gates = 4 if cfg.cell == "lstm" else 3
    layers = []
    for l in range(cfg.n_layers):
        inp = cfg.input_dim if l == 0 else cfg.hidden_dim
        layers.append({
            "wx": dense_init(generator, inp, gates * cfg.hidden_dim,
                             dtype=dtype),
            "wh": dense_init(generator, cfg.hidden_dim,
                             gates * cfg.hidden_dim,
                             scale=cfg.hidden_dim ** -0.5, dtype=dtype),
            "b": torch.zeros((gates * cfg.hidden_dim,), dtype=dtype),
        })
    head = {"w": dense_init(generator, cfg.hidden_dim, cfg.horizon,
                            dtype=dtype),
            "b": torch.zeros((cfg.horizon,), dtype=dtype)}
    return {"layers": layers, "head": head}


def param_template(cfg: ForecasterConfig, dtype=torch.float32) -> Dict:
    """Zero-valued tree with :func:`init_forecaster`'s exact structure: the
    shape oracle for structure-driven loads (``checkpoint.unflatten_like``
    in the serving registry)."""
    gates = 4 if cfg.cell == "lstm" else 3
    G, H = gates * cfg.hidden_dim, cfg.hidden_dim
    layers = []
    for l in range(cfg.n_layers):
        inp = cfg.input_dim if l == 0 else H
        layers.append({
            "wx": torch.zeros((inp, G), dtype=dtype),
            "wh": torch.zeros((H, G), dtype=dtype),
            "b": torch.zeros((G,), dtype=dtype),
        })
    head = {"w": torch.zeros((H, cfg.horizon), dtype=dtype),
            "b": torch.zeros((cfg.horizon,), dtype=dtype)}
    return {"layers": layers, "head": head}


# --------------------------------------------------- numpy <-> port trees
def params_from_numpy(tree, device="cpu") -> Dict:
    """A forecaster tree of numpy arrays (e.g. ``jax.tree.map(np.asarray,
    params)``) -> the same tree of tensors on ``device``, layouts unchanged.
    bfloat16 leaves keep their dtype."""
    return tree_from_numpy(tree, device)


def params_to_numpy(params) -> Dict:
    """Inverse of :func:`params_from_numpy`: host numpy arrays, float32 for
    float32 leaves; bfloat16 leaves are widened to float32 (exactly)."""
    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return {"layers": [{k: leaf(p[k]) for k in ("wx", "wh", "b")}
                       for p in params["layers"]],
            "head": {k: leaf(params["head"][k]) for k in ("w", "b")}}


# ------------------------------------------------------------------ forward
def encode(params, x, cfg: ForecasterConfig, cell_impl: str = "kernel"):
    """The recurrent layers: x (B, L, input_dim) -> the last step's h
    (B, H).  With client-stacked params (a leading M on every leaf) x is
    (M, B, L, input_dim) and h (M, B, H): one layer call per layer for all
    M clients at once."""
    if cell_impl not in CELL_IMPLS:
        raise ValueError(
            f"cell_impl={cell_impl!r}; pick from {CELL_IMPLS}")
    # time-major and contiguous: the layer's x_seq, (L, B, I) or (M, L, B, I)
    h_seq = x.transpose(-3, -2).contiguous()
    h0 = torch.zeros(x.shape[:-3] + (x.shape[-3], cfg.hidden_dim),
                     dtype=x.dtype, device=x.device)
    for p in params["layers"]:
        w = (p["wx"], p["wh"], p["b"])
        if cfg.cell == "lstm":
            layer = lstm_layer if cell_impl == "kernel" else ref.lstm_layer_ref
            h_seq, _ = layer(h_seq, h0, h0, *w)
        else:
            layer = gru_layer if cell_impl == "kernel" else ref.gru_layer_ref
            h_seq = layer(h_seq, h0, *w)
    return h_seq.select(-3, -1)


def head(params, h_last):
    """The linear head: (B, H) -> (B, horizon), or per client with stacked
    params, (M, B, H) -> (M, B, horizon).  A batched ``torch.matmul``: the
    JAX package leaves the head to XLA, outside its Pallas kernels."""
    b = params["head"]["b"]
    return torch.matmul(h_last, params["head"]["w"]) + \
        (b if b.dim() == 1 else b.unsqueeze(-2))


def forecast(params, x, cfg: ForecasterConfig, cell_impl: str = "kernel"):
    """x: (B, L, input_dim) -> (B, horizon); with client-stacked params,
    x: (M, B, L, input_dim) -> (M, B, horizon)."""
    return head(params, encode(params, x, cfg, cell_impl))


def loss_fn(params, batch, cfg: ForecasterConfig, loss, cell_impl="kernel",
            dim=None):
    """batch: {"x": (B,L,1), "y": (B,horizon)} -> scalar loss; with
    client-stacked params and (M, ...) batches and ``dim=(-2, -1)``, one
    loss per client, (M,)."""
    pred = forecast(params, batch["x"], cfg, cell_impl)
    return loss(pred, batch["y"], dim=dim)


class Forecaster(nn.Module):
    """The forecaster as an ``nn.Module``: its parameters registered under
    the tree's keys, :meth:`params` the plain tree view that
    :func:`forecast` takes."""

    def __init__(self, cfg: ForecasterConfig, params: Dict, *,
                 cell_impl: str = "kernel"):
        super().__init__()
        self.cfg, self.cell_impl = cfg, cell_impl
        self.layers = nn.ModuleList(
            nn.ParameterDict({k: nn.Parameter(v) for k, v in p.items()})
            for p in params["layers"])
        self.head = nn.ParameterDict(
            {k: nn.Parameter(v) for k, v in params["head"].items()})

    def params(self) -> Dict:
        return {"layers": [dict(p) for p in self.layers],
                "head": dict(self.head)}

    def forward(self, x):
        return forecast(self.params(), x, self.cfg, self.cell_impl)
