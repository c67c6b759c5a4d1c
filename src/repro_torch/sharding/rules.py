"""Logical-axis sharding rules on DTensor; the counterpart of
``src/repro/sharding/rules.py``.

Model code calls ``constrain(x, "batch", "seq", "embed")`` with *logical*
axis names; the active :class:`ShardingRules` (installed by the launcher
with ``use_rules``) maps them to mesh axes.  With no rules installed, or on
a plain tensor, every call returns its input, so the same model code runs
on one card and on a mesh.  On a ``DTensor`` a constraint redistributes to
the logical placements, where the reference hands GSPMD a hint: here the
collective happens at that point.

Parameter shardings come from the param-tree *paths* through
``param_pspec``, the reference's rule table, keyed on the same tree keys.
A spec is the reference's per-dim assignment of mesh axes (a
:class:`PartitionSpec`: per tensor dim None, an axis name, or a tuple of
axis names), kept so that tests compare it with the reference's;
:func:`placements` turns it into DTensor placements on a ``DeviceMesh``,
one per mesh dim: ``Shard(tensor_dim)`` or ``Replicate()``.  A tensor dim
over a tuple of axes, such as ``("pod", "data")`` for FSDP on the
multi-pod mesh, is sharded over both mesh dims, the first axis major, as
the reference orders it.  :func:`safe_spec` drops an axis that does not
divide its dim, as the reference does; DTensor would shard unevenly
instead, and the per-device bytes would differ.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

# process-wide, not thread-local: autograd runs the backward of CUDA
# tensors, and the recompute of a checkpointed block inside it, on its
# own device threads, which must see the same rules
_active: List[Optional["ShardingRules"]] = [None]


class PartitionSpec(tuple):
    """Per tensor dim: None, a mesh axis name, or a tuple of axis names
    (normalised as JAX's: a one-name tuple is the name, an empty one
    None)."""

    def __new__(cls, *axes):
        return super().__new__(cls, (
            (None if not a else a[0] if len(a) == 1 else a)
            if isinstance(a, tuple) else a for a in axes))

    def __repr__(self):
        return f"P{tuple(self)!r}"


P = PartitionSpec


class AbstractMesh:
    """A mesh's axis names and sizes without ranks or devices, for specs
    alone (e.g. the production (16, 16) mesh in a one-process test)."""

    def __init__(self, shape: Tuple[int, ...], axis_names: Tuple[str, ...]):
        self.mesh_dim_names = tuple(axis_names)
        self.shape = tuple(shape)


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or an :class:`AbstractMesh`."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


class ShardingRules:
    """Maps logical axis names -> mesh axis (or None)."""

    def __init__(self, mesh, logical_to_mesh=None, fsdp_axis="data",
                 tensor_axis="model", data_axes=("data",), pod_axis=None,
                 shard_batch=True, shard_activations=False):
        self.mesh = mesh
        self.fsdp_axis = fsdp_axis
        self.tensor_axis = tensor_axis
        self.pod_axis = pod_axis
        self.shard_activations = shard_activations
        if not shard_batch:                  # e.g. global_batch=1 long-context
            data_axes, pod_axis = (), None
        # data-parallel axes for the *batch* dimension of activations.  On the
        # multi-pod mesh the pod axis is also data-parallel.
        batch_axes = tuple(a for a in ((pod_axis,) if pod_axis else ())
                           + tuple(data_axes))
        self.logical = {
            "batch": batch_axes if batch_axes else None,
            "seq": None,
            "cache_seq": tensor_axis,      # sequence-sharded KV cache
            # residual-stream activations optionally shard d_model over the
            # tensor axis ("activation FSDP"), for models whose saved
            # per-layer x would not fit otherwise
            "embed": tensor_axis if shard_activations else None,
            "act_ff": tensor_axis,         # activation hidden/ffn dim under TP
            "act_heads": tensor_axis,
            "act_vocab": tensor_axis,      # sharded logits
            # routing groups shard over the DATA axes only
            "moe_group": batch_axes if batch_axes else None,
            "moe_batch": batch_axes if batch_axes else None,
            "act_experts": tensor_axis,
            "clients": batch_axes if batch_axes else None,
        }
        if logical_to_mesh:
            self.logical.update(logical_to_mesh)

    # -------------------------------------------------------- params
    def param_pspec(self, path: Tuple[str, ...], shape: Tuple[int, ...]) -> P:
        """Sharding for one parameter, by its tree path.

        Layout: FSDP over ``fsdp_axis`` on the largest "row" dim, tensor
        parallel over ``tensor_axis`` on head/ffn/expert/vocab dims.  A
        leading layer-stack axis is never sharded.
        """
        name = path[-1]
        fsdp, tp = self.fsdp_axis, self.tensor_axis
        ndim = len(shape)

        def spec(*axes):
            # pad to ndim with None on the left for the layer-stack axis
            pad = ndim - len(axes)
            return P(*((None,) * pad + tuple(axes)))

        if name in ("embed_tokens",):            # (vocab, d)
            return spec(tp, fsdp)
        if name == "cb_embed":                   # (K, vocab, d)
            return P(None, tp, fsdp)
        if name == "cb_heads":                   # (d, K, vocab)
            return P(fsdp, None, tp)
        if name in ("lm_head",):                 # (d, vocab)
            return spec(fsdp, tp)
        if name in ("wq", "wk", "wv", "w_in", "w_gate", "wq_up", "wkv_up"):
            return spec(fsdp, tp)                # (d, heads*hd) / (d, ff)
        if name in ("wo", "w_out"):              # (heads*hd, d) / (ff, d)
            return spec(tp, fsdp)
        if name in ("moe_w_in", "moe_w_gate"):   # (E, d, ff_e)
            return spec(tp, fsdp, None)
        if name in ("moe_w_out",):               # (E, ff_e, d)
            return spec(tp, None, fsdp)
        if name == "router":                     # (d, E)
            return spec(fsdp, None)
        if name in ("in_proj", "x_proj", "up_proj"):
            return spec(fsdp, tp)
        if name in ("out_proj", "down_proj"):
            return spec(tp, fsdp)
        if ndim >= 2 and shape[-1] >= 1024 and shape[-2] >= 1024:
            return spec(fsdp, tp)                # generic big matrix
        return spec(*((None,) * ndim))           # small params replicated

    def pspec_tree(self, params):
        """A tree like ``params`` (nested dicts, lists, tuples) of specs; a
        None leaf stays None."""
        return _map_with_path(
            lambda path, t: None if t is None else safe_spec(
                tuple(t.shape), self.param_pspec(path, tuple(t.shape)),
                self.mesh), params)

    def sharding_tree(self, params):
        """The placements of :meth:`pspec_tree`, on ``self.mesh``."""
        return _map_with_path(
            lambda _, s: None if s is None else placements(s, self.mesh),
            self.pspec_tree(params), is_leaf=_is_spec)


def _is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def _map_with_path(fn, tree, path=(), is_leaf=lambda x: False):
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples; the path
    holds dict keys and sequence indices as strings, as the reference's
    ``tree_flatten_with_path`` names them."""
    if not is_leaf(tree):
        if isinstance(tree, dict):
            return {k: _map_with_path(fn, v, path + (str(k),), is_leaf)
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(_map_with_path(fn, v, path + (str(i),), is_leaf)
                              for i, v in enumerate(tree))
    return fn(path, tree)


# ------------------------------------------------------------------ context
@contextlib.contextmanager
def use_rules(rules: Optional[ShardingRules]):
    prev = _active[0]
    _active[0] = rules
    try:
        yield
    finally:
        _active[0] = prev


def active_rules() -> Optional[ShardingRules]:
    return _active[0]


def _axis_size(sizes: Dict[str, int], m) -> int:
    if m is None:
        return 1
    if isinstance(m, tuple):
        n = 1
        for a in m:
            n *= sizes[a]
        return n
    return sizes[m]


def safe_spec(shape, spec: P, mesh) -> P:
    """Drop mesh axes whose size does not divide the tensor dim (e.g. 56
    query heads on a 16-way tensor axis): the dim is then replicated."""
    sizes = mesh_sizes(mesh)
    axes = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, m in zip(shape, axes):
        sz = _axis_size(sizes, m)
        out.append(m if sz > 1 and dim % sz == 0 else
                   (m if sz == 1 else None))
    return P(*out)


def placements(spec: P, mesh) -> List:
    """DTensor placements of ``spec`` on ``mesh``: per mesh dim,
    ``Shard(d)`` for the tensor dim ``d`` that names it, else
    ``Replicate()``.  A tuple entry must list its axes in the mesh's
    order (the first one major), as every spec of the rules does."""
    names = list(mesh.mesh_dim_names)
    out: List = [Replicate()] * len(names)
    for d, m in enumerate(spec):
        axes = () if m is None else (m if isinstance(m, tuple) else (m,))
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: axes {axes} are not in the mesh's "
                             f"order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return out


def spec_of(x: DTensor) -> P:
    """The spec of a DTensor's placements (Shard dims only; Partial and
    Replicate give None)."""
    names = x.device_mesh.mesh_dim_names
    axes: List = [()] * x.ndim
    for name, p in zip(names, x.placements):
        if isinstance(p, Shard):
            axes[p.dim] = axes[p.dim] + (name,)
    return P(*(None if not a else a[0] if len(a) == 1 else a for a in axes))


def _redistribute(x, spec: P):
    want = placements(spec, x.device_mesh)
    if tuple(x.placements) == tuple(want):
        return x
    return x.redistribute(x.device_mesh, want)


def constrain_heads(x, head_axis: int = 2):
    """Constraint for (B, S, H, hd) attention activations: batch over the
    batch axes and heads over the tensor axis where they divide.  Heads
    that do not divide stay replicated: hd is the contraction dim of the
    score product, so it is never sharded."""
    rules = active_rules()
    if rules is None or not isinstance(x, DTensor):
        return x
    sizes = mesh_sizes(rules.mesh)
    tp = rules.tensor_axis
    axes = [None] * x.ndim
    batch = rules.logical.get("batch")
    if batch is not None and x.shape[0] % _axis_size(sizes, batch) == 0:
        axes[0] = batch
    if x.shape[head_axis] % _axis_size(sizes, tp) == 0:
        axes[head_axis] = tp
    return _redistribute(x, P(*axes))


def constrain(x, *logical_axes: Optional[str]):
    """Redistribute ``x`` to the placements of its logical axis names (a
    no-op without rules or on a plain tensor)."""
    rules = active_rules()
    if rules is None or not isinstance(x, DTensor):
        return x
    spec = P(*(rules.logical.get(a) if a else None for a in logical_axes))
    return _redistribute(x, safe_spec(tuple(x.shape), spec, rules.mesh))


def local_block(shape, mesh, pl):
    """(local shape, global offsets) of this rank's block of a tensor of
    ``shape`` laid out evenly by placements ``pl`` on ``mesh``: a dim
    split over several mesh dims takes the first of them as major."""
    sizes, coord = tuple(mesh.shape), mesh.get_coordinate()
    local, offsets = list(shape), [0] * len(shape)
    for d in range(len(shape)):
        block = 0
        for i, p in enumerate(pl):
            if isinstance(p, Shard) and p.dim == d:
                local[d] //= sizes[i]
                block = block * sizes[i] + coord[i]
        offsets[d] = block * local[d]
    return tuple(local), tuple(offsets)


def write_slice(dst, dim: int, start: int, value) -> None:
    """``dst.narrow(dim, start, n).copy_(value)``, in place, ``n`` =
    ``value.shape[dim]``: a cache write.  On a DTensor ``dst`` the value
    is first laid out like ``dst`` but whole along ``dim``, and each rank
    writes the part of the range that falls in its local block."""
    n = value.shape[dim]
    if not isinstance(dst, DTensor):
        dst.narrow(dim, start, n).copy_(value)
        return
    mesh = dst.device_mesh
    want = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
            for p in dst.placements]
    if not isinstance(value, DTensor):
        value = DTensor.from_local(value, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
    lv = value.redistribute(mesh, want).to_local()
    local = dst.to_local()
    off = local_block(tuple(dst.shape), mesh, dst.placements)[1][dim]
    lo, hi = max(start, off), min(start + n, off + local.shape[dim])
    if hi > lo:
        local.narrow(dim, lo - off, hi - lo).copy_(
            lv.narrow(dim, lo - start, hi - lo))


def replicated(x):
    """``x`` whole on every rank: a DTensor redistributed to
    ``Replicate()`` on every mesh dim; a plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def local_region(fn, args, in_axes, out_axes, partial=()):
    """``fn(*args)`` on each rank's local blocks, where DTensor lacks a
    rule for the ops inside or would split a dim that ``fn`` reshapes (a
    chunked scan, the MoE dispatch): the role of ``local_map``.

    ``in_axes[i]`` names the logical axis of each dim of ``args[i]`` (None
    for a dim kept whole); ``args[i]`` is redistributed so, where the axis
    divides the dim (:func:`safe_spec`).  A None argument or a plain tensor
    passes as it is.  ``out_axes[j]`` lays out output ``j`` (one tensor or
    a tuple): its named axes are split as the inputs that name the same
    axis are, so ``fn`` must be independent across those blocks; the
    outputs are partial sums over the mesh axes of the logical axes in
    ``partial`` (e.g. experts, whose tokens are combined).  Without rules,
    or with no DTensor argument, it is ``fn(*args)``.
    """
    rules = active_rules()
    dts = [a for a in args if isinstance(a, DTensor)]
    if rules is None or not dts:
        return fn(*args)
    from torch.distributed.tensor import Partial
    mesh = dts[0].device_mesh
    # an axis splits every dim that names it, or none (blocks must match)
    kept: Dict[str, Optional[object]] = {}
    for a, axes in zip(args, in_axes):
        if isinstance(a, DTensor):
            spec = safe_spec(tuple(a.shape), P(*[
                None if n is None else rules.logical.get(n) for n in axes]),
                rules.mesh)
            for n, m in zip(axes, spec):
                if n is not None:
                    kept[n] = m if kept.get(n, m) == m else None
    local = [a.redistribute(mesh, placements(
        P(*[None if n is None else kept[n] for n in axes]), mesh)).to_local()
        if isinstance(a, DTensor) else a for a, axes in zip(args, in_axes)]
    out = fn(*local)
    single = not isinstance(out, tuple)
    outs = (out,) if single else out
    layouts = (out_axes,) if single else out_axes
    names = list(mesh.mesh_dim_names)
    wrapped = []
    for o, axes in zip(outs, layouts):
        pl = placements(P(*[None if n is None else kept.get(n)
                            for n in axes]), mesh)
        for n in partial:
            m = kept.get(n)
            for a in (() if m is None else m if isinstance(m, tuple)
                      else (m,)):
                pl[names.index(a)] = Partial()
        wrapped.append(DTensor.from_local(o, mesh, pl, run_check=False))
    return wrapped[0] if single else tuple(wrapped)



def reshape(x, *shape):
    """``x.reshape(*shape)``.  DTensor refuses a view that splits or merges
    a sharded dim unevenly (40 heads out of a dim sharded 16 ways; 256
    rows split into 4 microbatches of 64 over 16 ranks), where GSPMD
    would re-lay it out: such a DTensor is gathered first, all but a
    sharded leading dim that the view keeps.  The gradient goes back the
    same way (a merge of heads is a split in the backward)."""
    if not isinstance(x, DTensor):
        return x.reshape(*shape)
    return _Reshape.apply(x, tuple(shape))


def _relayout_reshape(x, shape):
    # DTensor views the local tensor: a non-contiguous one (a gradient)
    # is made contiguous first
    for t in (x, x.contiguous()):
        try:
            return t.reshape(*shape)
        except (RuntimeError, ValueError):
            # an uneven split, or (a dim split over two mesh dims) a wrong
            # local view: gathered, the view is the plain one
            pass
    lead = shape[0] == x.shape[0]
    want = [p if lead and type(p) is Shard and p.dim == 0 else Replicate()
            for p in x.placements]
    return x.redistribute(x.device_mesh, want).contiguous().reshape(*shape)


class _Reshape(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shape):
        ctx.in_shape = tuple(x.shape)
        return _relayout_reshape(x, shape)

    @staticmethod
    def backward(ctx, g):
        return _relayout_reshape(g, ctx.in_shape), None

def last_dim_split(x):
    """(``x`` with its pending sums reduced, the process groups of the mesh
    dims that split its last dim), as a norm takes its input: the norm
    reduces over that dim with one all-reduce of its statistics over
    those groups (DTensor's partial mean of a split dim cannot be carried
    through the backward).  A plain tensor: (``x``, ())."""
    if not isinstance(x, DTensor):
        return x, ()
    from torch.distributed.tensor import Partial
    if any(isinstance(p, Partial) for p in x.placements):
        x = x.redistribute(x.device_mesh, [
            Replicate() if isinstance(p, Partial) else p
            for p in x.placements])
    last = x.ndim - 1
    return x, tuple(x.device_mesh.get_group(i)
                    for i, p in enumerate(x.placements)
                    if isinstance(p, Shard) and p.dim == last)


def whole_last(x):
    """``x`` with its last dim whole on every rank (a DTensor's
    ``Shard(last)`` placements become ``Replicate()``): a block's normed
    input under activation FSDP, gathered once, in its own dtype, for the
    products that contract it (GSPMD gathers it there).  A plain tensor
    as it is."""
    if not isinstance(x, DTensor):
        return x
    last = x.ndim - 1
    want = [Replicate() if isinstance(p, Shard) and p.dim == last else p
            for p in x.placements]
    if want == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


# ``name -> context manager``s under which :func:`all_reduce` runs its
# collectives: a cost model's booking of them under ``name`` (the dry
# run's tracker registers its own while it is open)
BOOKERS: List = []


def all_reduce(t, op: str, groups, name: str):
    """``t`` (a plain local tensor) reduced with ``op`` ("sum", "max")
    over each process group of ``groups`` in turn, through the functional
    collectives that the dry run counts, booked there under ``name``."""
    from torch.distributed import _functional_collectives as funcol
    with contextlib.ExitStack() as stack:
        for book in BOOKERS:
            stack.enter_context(book(name))
        for g in groups:
            t = funcol.all_reduce(t, op, g)
            if isinstance(t, funcol.AsyncCollectiveTensor):
                t = t.wait()
    return t

def split_last(x, *shape, keep=(0, 2)):
    """``reshape(x, *shape)``, then, on a DTensor, only the dims in
    ``keep`` stay split (e.g. batch and heads of (B, S, H, hd)): the head
    dim is the contraction dim of the scores and the norms' reduction dim,
    so a projection split over it is gathered, as the reference's
    ``constrain_heads`` never shards it."""
    x = reshape(x, *shape)
    if not isinstance(x, DTensor):
        return x
    want = [p if type(p) is Shard and p.dim in keep else Replicate()
            for p in x.placements]
    if tuple(want) == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def gather_fsdp(tree):
    """A block's params with their FSDP split gathered and their
    tensor-parallel split kept: the per-layer all-gather of FSDP, as GSPMD
    runs it ahead of the layer, so products run on batch-split inputs and
    never leave partial sums over the data axis (DTensor, left to itself,
    would split the contraction instead and all-reduce every activation).
    The gradient comes back reduce-scattered.  Without rules, or on plain
    tensors, the tree as it is."""
    rules = active_rules()
    if rules is None:
        return tree
    fsdp = rules.fsdp_axis if isinstance(rules.fsdp_axis, tuple) \
        else (rules.fsdp_axis,)

    def one(t):
        if not isinstance(t, DTensor):
            return t
        mesh = t.device_mesh
        names = mesh.mesh_dim_names
        want = [Replicate() if names[i] in fsdp and isinstance(p, Shard)
                and mesh.size(i) > 1 else p
                for i, p in enumerate(t.placements)]
        if want == list(t.placements):
            return t
        return t.redistribute(t.device_mesh, want)
    return _map_with_path(lambda _, t: one(t), tree)



def matmul(x, w):
    """``torch.matmul(x, w)`` of activations (..., k) and a weight (k, n).
    On a DTensor its backward goes through :class:`_Matmul`: DTensor's own
    backward views the flattened tokens back to (..., k) and fails where
    it split them unevenly (a microbatch smaller than the batch split)."""
    if not (isinstance(x, DTensor) and x.ndim > 2):
        return torch.matmul(x, w)
    return _Matmul.apply(x, w)


class _Matmul(torch.autograd.Function):
    """x (..., k) @ w (k, n) whose backward runs the two products on the
    flattened tokens and restores the leading dims with
    :func:`_relayout_reshape`; the same products as autograd's own."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.matmul(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        k, n = w.shape
        g2 = _relayout_reshape(g, (-1, n))
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = _relayout_reshape(torch.mm(g2, w.t()), tuple(x.shape))
        if ctx.needs_input_grad[1]:
            gw = torch.mm(_relayout_reshape(x, (-1, k)).t(), g2)
        return gx, gw
