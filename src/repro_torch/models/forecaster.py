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
clients on the kernel's grid.  A local step's gradient
(:func:`loss_and_grads`) is decided here, by route: the kernel route runs
:func:`layers_forward`, :func:`head_vjp` (autograd over the head alone)
and :func:`layers_bptt`, one launch per layer of the BPTT kernel
(``csrc/{lstm,gru}_bptt.cu``), the VJP of the plain layer; the graphed
local step (``core/client.py``) replays the same calls into preallocated
buffers.  The plain route takes autograd through the plain cells.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from repro_torch import tracing
from repro_torch.configs.base import ForecasterConfig
from repro_torch.kernels import ref
from repro_torch.kernels.gru_cell import gru_layer, gru_layer_bptt
from repro_torch.kernels.lstm_cell import lstm_layer, lstm_layer_bptt
from repro_torch.models.layers import (dense_init, tree_from_numpy,
                                       tree_leaves, tree_map)

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
def time_major(x, out=None):
    """x (..., B, L, I) -> the layers' contiguous time-major x_seq
    (..., L, B, I), written into ``out`` where given."""
    t = x.transpose(-3, -2)
    return t.contiguous() if out is None else out.copy_(t)


def last_step(h_seq):
    """The last time step of a time-major h_seq (..., L, B, H): a view."""
    return h_seq.select(-3, -1)


def zero_state(x_seq, hidden_dim: int):
    """The layers' zero h0 (and c0) for a time-major x_seq (..., L, B, I):
    (..., B, hidden_dim)."""
    return torch.zeros(x_seq.shape[:-3] + (x_seq.shape[-2], hidden_dim),
                       dtype=x_seq.dtype, device=x_seq.device)


def layers_forward(layers, x_seq, h0, cell: str, cell_impl: str = "kernel",
                   out=None):
    """The recurrent layers over a time-major x_seq from the zero state h0
    (every layer's h0, and c0 too): each layer's h_seq the next one's
    input.  Returns every layer's h_seq, the top layer's last.  ``out``:
    each layer's preallocated output, ``(h_seq, c_T)`` (LSTM) or h_seq
    (GRU), which the kernel route writes where autograd records nothing
    (the graphed local step, ``core/client.py``)."""
    h_seqs, h_seq = [], x_seq
    for l, p in enumerate(layers):
        w = (p["wx"], p["wh"], p["b"])
        kw = {} if out is None else {"out": out[l]}
        if cell == "lstm":
            layer = lstm_layer if cell_impl == "kernel" else ref.lstm_layer_ref
            h_seq, _ = layer(h_seq, h0, h0, *w, **kw)
        else:
            layer = gru_layer if cell_impl == "kernel" else ref.gru_layer_ref
            h_seq = layer(h_seq, h0, *w, **kw)
        h_seqs.append(h_seq)
    return h_seqs


def layers_bptt(layers, x_seq, h0, cell: str, h_seqs, g_hs, g_c, grads,
                work):
    """The kernel route's backward through :func:`layers_forward`, into
    preallocated buffers: one BPTT call a layer (a launch on the card, the
    plain version on the CPU), top layer first.  ``h_seqs``: each layer's
    h_seq; ``g_hs``: their cotangents, the top layer's given, each lower
    one written as the dx of the layer above; ``g_c``: the cotangent of
    each LSTM layer's unused c_T (zero; None for the GRU); ``grads``: each
    layer's ``{"wx", "wh", "b"}`` gradients, written; ``work``: each
    layer's BPTT workspace, None for a new one.  No gradient of x_seq or
    of the zero state."""
    for l in reversed(range(len(layers))):
        p, g = layers[l], grads[l]
        inp = x_seq if l == 0 else h_seqs[l - 1]
        dx = g_hs[l - 1] if l else None
        w, gw = (p["wx"], p["wh"], p["b"]), (g["wx"], g["wh"], g["b"])
        if cell == "lstm":
            lstm_layer_bptt(inp, h0, h0, *w, h_seqs[l], g_hs[l], g_c,
                            (l > 0, False, False, True, True, True),
                            out=(dx, None, None, *gw), work=work[l])
        else:
            gru_layer_bptt(inp, h0, *w, h_seqs[l], g_hs[l],
                           (l > 0, False, True, True, True),
                           out=(dx, None, *gw), work=work[l])


def encode(params, x, cfg: ForecasterConfig, cell_impl: str = "kernel"):
    """The recurrent layers: x (B, L, input_dim) -> the last step's h
    (B, H).  With client-stacked params (a leading M on every leaf) x is
    (M, B, L, input_dim) and h (M, B, H): one layer call per layer for all
    M clients at once."""
    if cell_impl not in CELL_IMPLS:
        raise ValueError(
            f"cell_impl={cell_impl!r}; pick from {CELL_IMPLS}")
    x_seq = time_major(x)
    return last_step(layers_forward(params["layers"], x_seq,
                                    zero_state(x_seq, cfg.hidden_dim),
                                    cfg.cell, cell_impl)[-1])


def head(params, h_last):
    """The linear head: (B, H) -> (B, horizon), or per client with stacked
    params, (M, B, H) -> (M, B, horizon).  A batched ``torch.matmul``: the
    JAX package leaves the head to XLA, outside its Pallas kernels."""
    b = params["head"]["b"]
    return torch.matmul(h_last, params["head"]["w"]) + \
        (b if b.dim() == 1 else b.unsqueeze(-2))


def head_vjp(head_params, h_last, y, loss):
    """The head and each client's loss on its own: ``(per-client loss
    (M,), (the gradients of their sum w.r.t. h_last, the head's w and
    b))``, none of them recorded by autograd.  The kernel route's head
    part of a local step (:func:`loss_and_grads`), with ``loss`` as
    :func:`loss_fn` takes it."""
    with torch.enable_grad():
        h_last = h_last.detach().requires_grad_()
        hp = {k: v.detach().requires_grad_() for k, v in head_params.items()}
        per_client = loss(head({"head": hp}, h_last), y, dim=(-2, -1))
        grads = torch.autograd.grad(per_client.sum(),
                                    (h_last, hp["w"], hp["b"]))
    return per_client.detach(), grads


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


def loss_and_grads(params, batch, cfg: ForecasterConfig, loss,
                   cell_impl: str = "kernel"):
    """A local step's gradient: ``(each client's loss (M,), the gradient
    tree of their sum)`` for client-stacked params and a batch
    ``{"x": (M, B, L, input_dim), "y": (M, B, horizon)}``, none of them
    recorded by autograd; the backward runs in the tracer's
    ``fl.backward`` span.  The kernel route calls :func:`time_major`,
    :func:`layers_forward`, :func:`head_vjp` and :func:`layers_bptt`, into
    new tensors: the sequence the graphed local step replays from its
    static buffers (``core/client.py::StepGraphs``).  The plain route takes
    autograd through :func:`loss_fn`, the independent reference."""
    if cell_impl != "kernel":
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        with torch.enable_grad():
            per_client = loss_fn(p, batch, cfg, loss, cell_impl,
                                 dim=(-2, -1))
            with tracing.span("fl.backward"):
                grads = iter(torch.autograd.grad(per_client.sum(),
                                                 tree_leaves(p)))
        return per_client.detach(), tree_map(lambda _: next(grads), p)
    layers = params["layers"]
    with torch.no_grad():
        x_seq = time_major(batch["x"])
        h0 = zero_state(x_seq, cfg.hidden_dim)
        h_seqs = layers_forward(layers, x_seq, h0, cfg.cell)
        with tracing.span("fl.backward"):
            per_client, (g_h, g_w, g_b) = head_vjp(
                params["head"], last_step(h_seqs[-1]), batch["y"], loss)
            g_hs = [torch.zeros_like(h) for h in h_seqs]
            last_step(g_hs[-1]).copy_(g_h)
            grads = tree_map(torch.empty_like, layers)
            layers_bptt(layers, x_seq, h0, cfg.cell, h_seqs, g_hs,
                        torch.zeros_like(h0) if cfg.cell == "lstm" else None,
                        grads, [None] * len(layers))
    return per_client, {"layers": grads, "head": {"w": g_w, "b": g_b}}


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
