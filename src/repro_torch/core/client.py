"""Local-update stage of the federated pipeline (paper Alg. 1,
``ClientUpdate``): select -> **local-update** -> transform -> aggregate ->
server-update.  The counterpart of ``src/repro/core/client.py``.

E epochs of minibatch SGD on each client's private windows, over a fixed
schedule of precomputed minibatch indices, for all M selected clients at
once.  The JAX package vmaps one client's ``lax.scan`` over clients; here
the client axis is written out: the params are client-stacked (a leading M
on every leaf, one model per client), every step gathers each client's
minibatch, and the forward is one call of the recurrent layer per layer
for all M clients (on the card, one launch of the CUDA layer kernel with
the clients on its grid).  The gradient is that of the SUM of the
per-client mean losses: the clients own disjoint slices of the stacked
params, so each slice gets its own client's gradient.

FedProx (Li et al. 2020) is supported via ``prox_mu``: the local objective
gains ``mu/2 ||w - w_global||^2`` anchored at the round's incoming global
params, realized as an extra ``mu * (w - w_global)`` gradient term, added
whenever an anchor is given, as the JAX package adds it.  With ``mu = 0``
the term is exactly zero for finite weights, so FedAvg numerics are
unchanged; a non-finite ``w - w_global`` turns the gradient into NaN there,
as in the reference.

**One step, run eagerly or replayed.**  The eager route runs
:func:`sgd_step` each step, every launch dispatched by the host: the
gradient of ``forecaster.loss_and_grads`` (on the kernel route the
forward, the head's VJP and the BPTT; on the plain route autograd) and
the SGD step.  The graphed route (:class:`StepGraphs`) runs the kernel
route's calls, in the same order, from static buffers, as three CUDA
graphs with the hand-written kernels launched eagerly between them:

1. graph ``gather``: each client's minibatch from the round's x and y,
   the time-major x_seq;
2. the layer kernel(s), one launch a layer
   (``models/forecaster.py::layers_forward`` into static outputs);
3. graph ``head``: the head, each client's loss and their gradient back to
   the last step's h (``forecaster.head_vjp``), written into the last time
   slice of a static g_h (the rest stays zero, as autograd's ``select``
   backward makes it), and the head's weight gradients;
4. the BPTT kernel(s), one launch a layer, top layer first, each layer's
   dx the cotangent of the layer below (``forecaster.layers_bptt``);
5. graph ``update``: the FedProx term and the SGD step into the static
   client-stacked params; ``lr`` and ``prox_mu`` are 0-dim device tensors
   loaded each round, so one graph serves every value.

The kernels stay outside the graphs so that every launch still passes
through ``kernels/_cuda.py::launch`` (its counters, and whatever wraps it).
The calls, their inputs' layouts and their order are the eager kernel
route's, so the two give the same bits.  A round loads x, y and the
global params into the static set (device-to-device copies) and returns
clones of the static params, which the next round's replays overwrite.

**The rule** (:func:`graphs_engage`): the graphed route runs where the
device is CUDA, ``cell_impl`` is ``"kernel"`` and no ``TorchDispatchMode``
is active (a replay dispatches no op, so a mode that follows the ops, such
as flcheck's taint tracer or a FLOP counter, would see none); else the
eager route.  The first step of a shape runs eagerly on a side stream
(warming cuBLAS, the autograd thread and the allocator up on it) and
captures the three graphs, once a process: it keeps the sets of its last
``GRAPH_SETS`` shapes (:class:`StepShape`) in an LRU, so later rounds of a
shape, and a new ``RoundEngine`` of a shape seen before, only replay;
:func:`clear_step_graphs` frees them.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, NamedTuple

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from repro_torch import tracing
from repro_torch.configs.base import ForecasterConfig
from repro_torch.kernels import _cuda
from repro_torch.models import forecaster
from repro_torch.models.layers import tree_leaves, tree_map

# step shapes whose buffers and graphs a process keeps
GRAPH_SETS = 4


def _prox_sgd(params, grads, anchor, lr, prox_mu):
    """The SGD step with the FedProx gradient term (none without an
    anchor); ``lr`` / ``prox_mu`` Python floats or 0-dim tensors."""
    if anchor is not None:
        grads = tree_map(lambda gw, w, a: gw + prox_mu * (w - a),
                         grads, params, anchor)
    return tree_map(lambda w, gw: w - lr * gw, params, grads)


def sgd_step(params, batch, lr, cfg: ForecasterConfig, loss: Callable,
             cell_impl: str = "kernel", anchor=None, prox_mu=0.0):
    """One SGD step of every client.  params: client-stacked tree; batch:
    {"x": (M, B, L, 1), "y": (M, B, horizon)}; ``anchor``/``prox_mu`` add
    the FedProx proximal gradient.  Returns (new stacked params, the step's
    loss of each client (M,))."""
    per_client, grads = forecaster.loss_and_grads(params, batch, cfg, loss,
                                                  cell_impl)
    with torch.no_grad():
        new = _prox_sgd(params, grads, anchor, lr, prox_mu)
    return new, per_client


def local_update(params, x, y, batch_idx, lr, cfg: ForecasterConfig,
                 loss: Callable, cell_impl: str = "kernel", prox_mu=0.0):
    """Run every selected client's local schedule.

    params: the round's global model (one tree, shared by all clients);
    x: (M, n_win, L, 1); y: (M, n_win, H); batch_idx: (M, steps, B) int
    tensors, all on one device; prox_mu: FedProx strength (0 = plain
    FedAvg).  ``loss`` takes ``(pred, target, dim)``
    (``core/losses.py::make_loss``).  Returns (client-stacked local params,
    each client's mean local loss (M,)).  On the card the steps replay CUDA
    graphs where :func:`graphs_engage` says so (see the module's
    docstring); the result is the same.
    """
    if graphs_engage(x.device, cell_impl):
        return _graphed_update(params, x, y, batch_idx, lr, cfg, loss,
                               prox_mu)
    M = x.shape[0]
    anchor = params                      # round-start global model (FedProx)
    local = tree_map(lambda w: w.detach().expand((M,) + w.shape).clone(),
                     params)
    rows = torch.arange(M, device=x.device)[:, None]
    losses = []
    for s in range(batch_idx.shape[1]):
        with tracing.span("fl.local_step"):
            idx = batch_idx[:, s]                       # (M, B)
            local, l = sgd_step(local, {"x": x[rows, idx],
                                        "y": y[rows, idx]},
                                lr, cfg, loss, cell_impl, anchor=anchor,
                                prox_mu=prox_mu)
            losses.append(l)
    return local, torch.stack(losses).mean(0)


# ------------------------------------------------------------ graphed route
class StepShape(NamedTuple):
    """What one set of static buffers and graphs is specific to: the
    cache key.  ``loss`` is the loss callable (``make_loss`` hands out one
    per name and beta); ``tf32`` the matmul switch the head's product was
    captured under."""
    cell: str
    n_layers: int
    I: int
    H: int
    L: int
    horizon: int
    M: int
    n_win: int
    B: int
    dtype: torch.dtype
    device: torch.device
    loss: Callable
    tf32: bool


def step_shape(x, y, batch_idx, cfg: ForecasterConfig,
               loss: Callable) -> StepShape:
    """The :class:`StepShape` of a round's inputs (as
    :func:`local_update` takes them)."""
    M, n_win, L, I = x.shape
    return StepShape(cfg.cell, cfg.n_layers, I, cfg.hidden_dim, L,
                     y.shape[-1], M, n_win, batch_idx.shape[-1], x.dtype,
                     x.device, loss, torch.backends.cuda.matmul.allow_tf32)


def graphs_engage(device: torch.device, cell_impl: str) -> bool:
    """Whether a round on ``device`` takes the graphed route (the module's
    docstring gives the reasons)."""
    return (device.type == "cuda" and cell_impl == "kernel"
            and _get_current_dispatch_mode() is None)


_streams: dict = {}


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The device's one side stream for first steps and captures: cuBLAS
    keeps a workspace for each stream it meets, for the process's life."""
    s = _streams.get(device)
    if s is None:
        s = _streams[device] = torch.cuda.Stream(device)
    return s


def _graph_of(fn) -> torch.cuda.CUDAGraph:
    """``fn``'s launches captured on the current stream (a side stream)."""
    g = torch.cuda.CUDAGraph()
    g.capture_begin()
    try:
        fn()
    finally:
        g.capture_end()
    return g


class StepGraphs:
    """The static buffers of one :class:`StepShape` and, once its first
    step has run, the three graphs of a local step (``gather``, ``head``,
    ``update``; the module's docstring).  ``like``: a params tree of the
    shape's structure (one client's)."""

    def __init__(self, shape: StepShape, like):
        self.shape = s = shape
        lstm = s.cell == "lstm"
        dev, dt = s.device, s.dtype

        def new(*size):
            return torch.zeros(size, dtype=dt, device=dev)

        M, B, L, H = s.M, s.B, s.L, s.H
        self.x, self.y = new(M, s.n_win, L, s.I), new(M, s.n_win, s.horizon)
        self.idx = torch.zeros((M, B), dtype=torch.long, device=dev)
        self.rows = torch.arange(M, device=dev)[:, None]
        self.x_seq, self.y_b = new(M, L, B, s.I), new(M, B, s.horizon)
        self.h0 = new(M, B, H)             # h0 and c0 of every layer
        self.local = tree_map(lambda w: new(M, *w.shape), like)
        self.anchor = tree_map(lambda w: new(*w.shape), like)
        self.grads = tree_map(torch.zeros_like, self.local)
        n = s.n_layers
        self.h_seq = [new(M, L, B, H) for _ in range(n)]
        # each layer's output as the layer takes it: (h_seq, c_T) or h_seq
        self.out = [(h, new(M, B, H)) if lstm else h for h in self.h_seq]
        # the cotangent of each layer's h_seq: the top layer's is zero but
        # its last step; each layer below gets the dx of the one above
        self.g_h = [new(M, L, B, H) for _ in range(n)]
        self.g_c = new(M, B, H) if lstm else None
        name = "lstm_bptt" if lstm else "gru_bptt"
        self.work = []
        for l in range(n):
            _, size = _cuda.bptt_plan(name, L, B, s.I if l == 0 else H, H,
                                      self.x.element_size())
            self.work.append(torch.empty(M * size, dtype=torch.uint8,
                                         device=dev) if size else _cuda.NULL)
        self.loss = torch.zeros((M,), dtype=torch.float32, device=dev)
        self.lr, self.mu = (torch.zeros((), dtype=torch.float32, device=dev)
                            for _ in range(2))
        self.graphs = None

    def load(self, params, x, y, lr, prox_mu) -> None:
        """A round's inputs: x, y, the global params (every client's start
        and the FedProx anchor), lr and prox_mu."""
        self.x.copy_(x)
        self.y.copy_(y)
        for w, a, p in zip(tree_leaves(self.local), tree_leaves(self.anchor),
                           tree_leaves(params)):
            w.copy_(p)
            a.copy_(p)
        self.lr.fill_(lr)
        self.mu.fill_(prox_mu)

    def step(self, idx) -> bool:
        """One local step of every client on minibatch rows ``idx``
        (M, B): replays, or on the set's first step runs it eagerly and
        captures.  Returns whether it replayed."""
        self.idx.copy_(idx)
        if self.graphs is None:
            self._first_step()
            return False
        gather, head, update = self.graphs
        gather.replay()
        self._forward()
        with tracing.span("fl.backward"):
            head.replay()
            self._backward()
        update.replay()
        return True

    def _first_step(self) -> None:
        dev = self.shape.device
        main, side = torch.cuda.current_stream(dev), _capture_stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self._eager_step()
            torch.cuda.synchronize(dev)
            self.graphs = tuple(_graph_of(fn) for fn in (
                self._gather, self._head, self._update))
        main.wait_stream(side)

    def _eager_step(self) -> None:
        """The step without graphs: what a replay runs, op for op."""
        self._gather()
        self._forward()
        with tracing.span("fl.backward"):
            self._head()
            self._backward()
        self._update()

    def _gather(self) -> None:
        forecaster.time_major(self.x[self.rows, self.idx], out=self.x_seq)
        self.y_b.copy_(self.y[self.rows, self.idx])

    def _forward(self) -> None:
        forecaster.layers_forward(self.local["layers"], self.x_seq, self.h0,
                                  self.shape.cell, out=self.out)

    def _head(self) -> None:
        loss, (g_h, g_w, g_b) = forecaster.head_vjp(
            self.local["head"], forecaster.last_step(self.h_seq[-1]),
            self.y_b, self.shape.loss)
        forecaster.last_step(self.g_h[-1]).copy_(g_h)
        self.grads["head"]["w"].copy_(g_w)
        self.grads["head"]["b"].copy_(g_b)
        self.loss.copy_(loss)

    def _backward(self) -> None:
        forecaster.layers_bptt(self.local["layers"], self.x_seq, self.h0,
                               self.shape.cell, self.h_seq, self.g_h,
                               self.g_c, self.grads["layers"], self.work)

    def _update(self) -> None:
        with torch.no_grad():
            new = _prox_sgd(self.local, self.grads, self.anchor, self.lr,
                            self.mu)
            for w, n in zip(tree_leaves(self.local), tree_leaves(new)):
                w.copy_(n)


_sets: "OrderedDict[StepShape, StepGraphs]" = OrderedDict()


def step_graphs(shape: StepShape, like) -> StepGraphs:
    """The process's :class:`StepGraphs` of ``shape``, made where missing;
    the least recently used set goes past ``GRAPH_SETS``."""
    gs = _sets.pop(shape, None)
    if gs is None:
        if len(_sets) >= GRAPH_SETS:
            _, old = _sets.popitem(last=False)
            _sync(old.shape.device)      # no replay still reads what goes
            del old
        gs = StepGraphs(shape, like)
    _sets[shape] = gs
    return gs


def clear_step_graphs() -> None:
    """Free every cached set: its buffers and graphs."""
    for s in _sets:
        _sync(s.device)
    _sets.clear()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _graphed_update(params, x, y, batch_idx, lr, cfg, loss, prox_mu):
    """:func:`local_update` on the graphed route.  The tracer counts each
    replayed step as ``fl.step_graph`` and each first step of a set (its
    eager run and the captures) as ``fl.step_graph.capture``."""
    gs = step_graphs(step_shape(x, y, batch_idx, cfg, loss), params)
    gs.load(params, x, y, lr, prox_mu)
    steps = batch_idx.shape[1]
    losses = torch.empty((steps, x.shape[0]), dtype=gs.loss.dtype,
                         device=x.device)
    for s in range(steps):
        with tracing.span("fl.local_step"):
            t0 = tracing.now() if tracing.on() else 0
            replayed = gs.step(batch_idx[:, s])
            losses[s].copy_(gs.loss)
            if t0:
                tracing.count("fl.step_graph" if replayed
                              else "fl.step_graph.capture",
                              tracing.now() - t0)
    return tree_map(torch.clone, gs.local), losses.mean(0)
