"""Dry run of every (architecture x input shape) on the production mesh,
WITHOUT allocating a model byte: the counterpart of
``src/repro/launch/dryrun.py``.

For each combination this builds params, optimizer state, caches and the
input batch as fake tensors (``FakeTensorMode``) on the reference's
production mesh (16 x 16, or 2 x 16 x 16 with ``--multi-pod``), over a
fake process group of 256 (512) ranks in this one process, rank 0.  Every
tensor is a ``DTensor`` laid out by the sharding rules, each rank holding
only its local shard; the step (train / prefill / decode, the port's own
step functions) then runs on them under ``use_rules``, and DTensor issues
the collectives that the layouts need.  Three counts come out:

  * the GLOBAL step's FLOPs and bytes (``costmodel.step_cost``, the step
    run again on un-sharded fake tensors with no rules);
  * the collective bytes a device sends (``costmodel.collective_bytes``'s
    counter over the sharded step);
  * per-device memory: the local bytes of the arguments, and the peak of
    local bytes that the step holds above them (``costmodel.StepTracker``
    follows every storage an op returns until it is freed).

The port updates params and optimizer state in place
(``optim.update_in_place``), the reference's donation, so the updated
trees alias the arguments and nothing is counted twice.  The fake tensors
sit on the ``cuda`` device (with a CUDA build of torch), so the step
takes the card's code paths; no kernel runs on a fake tensor (a kernel
takes device pointers), so attention takes its plain route, as the
reference's dry run does unless ``REPRO_FLASH`` is set.

Records land in ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``
with the reference's keys; ``launch.roofline`` turns them into a table.
They are predictions of the port's step on a mesh of H100s, not
measurements.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.configs import ARCH_IDS, SHAPES_BY_NAME, get_config
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.launch import costmodel
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.lm_steps import (ADAFACTOR_ARCHS, MICROBATCHES,
                                         build_train_step, cache_capacity,
                                         decode_window, last_logits)
from repro_torch.models import transformer as tf
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.sharding import ShardingRules, placements, use_rules
from repro_torch.sharding.rules import (P, _map_with_path, local_block,
                                        safe_spec)

PARAM_DTYPE = torch.bfloat16
# the card's code paths; a torch built without CUDA cannot index a fake
# CUDA tensor, so there the fake tensors sit on the CPU, whose path differs
# only in the LM head's fp32 logits (a product of upcast operands)
DEVICE = "cuda" if torch.backends.cuda.is_built() else "cpu"
OUT_DIR = "experiments/dryrun_torch"
ID_DTYPE = torch.long        # token ids: torch's index dtype (int32 in JAX)


# ------------------------------------------------------------------ specs
def input_specs(cfg: ModelConfig, shape: InputShape) -> Dict:
    """{name: (shape, dtype)} of every model input of this step kind."""
    B, S = shape.global_batch, shape.seq_len

    def tok(*s):
        return (s, ID_DTYPE)
    if shape.kind == "train":
        if cfg.arch_type == "audio":
            K = cfg.frontend.n_codebooks
            return {"tokens": tok(B, K, S), "labels": tok(B, K, S)}
        if cfg.arch_type == "vlm":
            nm = cfg.frontend.n_media_tokens
            return {"tokens": tok(B, S - nm), "labels": tok(B, S),
                    "media": ((B, nm, cfg.frontend.embed_dim),
                              torch.bfloat16)}
        return {"tokens": tok(B, S), "labels": tok(B, S)}
    if shape.kind == "prefill":
        if cfg.arch_type == "audio":
            return {"tokens": tok(B, cfg.frontend.n_codebooks, S)}
        if cfg.arch_type == "vlm":
            nm = cfg.frontend.n_media_tokens
            return {"tokens": tok(B, S - nm),
                    "media": ((B, nm, cfg.frontend.embed_dim),
                              torch.bfloat16)}
        return {"tokens": tok(B, S)}
    # decode: ONE new token against a cache of size seq_len
    if cfg.arch_type == "audio":
        return {"tokens": tok(B, cfg.frontend.n_codebooks, 1)}
    return {"tokens": tok(B, 1)}


def batch_pspec_tree(specs: Dict, mesh, rules: ShardingRules) -> Dict:
    batch = rules.logical["batch"]
    return {k: safe_spec(s, P(*((batch,) + (None,) * (len(s) - 1))), mesh)
            for k, (s, _) in specs.items()}


def cache_pspec_tree(cache_shapes, mesh, rules: ShardingRules):
    """Specs for decode caches, by leaf name.

    KV caches are SEQUENCE-sharded over the tensor axis so GQA archs with
    few KV heads still use all of it; SSM / xLSTM states shard their head
    axis over the tensor axis; everything shards batch over the data
    axes."""
    batch = rules.logical["batch"]
    tp = rules.tensor_axis

    def spec_for(path, leaf):
        if leaf is None:
            return None
        name, nd = path[-1], len(leaf.shape)

        def pad(*axes):
            return P(*((None,) * (nd - len(axes)) + tuple(axes)))
        if name in ("k", "v"):               # (..., B, W, Hkv, hd)
            s = pad(batch, tp, None, None)
        elif name in ("c_kv", "k_rope"):     # (..., B, W, r)
            s = pad(batch, tp, None)
        elif name == "pos_ids":
            s = P(*((None,) * nd))
        elif name == "ssm":                  # (..., B, nh, hd, ds)
            s = pad(batch, tp, None, None)
        elif name == "conv":                 # (..., B, K-1, Cd)
            s = pad(batch, None, tp)
        elif name == "C":                    # (..., B, nh, hd, hd)
            s = pad(batch, tp, None, None)
        elif name in ("n", "c", "h", "m"):   # (..., B, nh, hd)
            s = pad(batch, tp, None)
        else:
            s = P(*((None,) * nd))
        return safe_spec(tuple(leaf.shape), s, mesh)

    return _map_with_path(spec_for, cache_shapes)


def _opt_state_pspecs(arch: str, p_specs, params_shapes):
    """Optimizer-state specs mirroring the parameter specs.

    adam: (m, v, t): m / v shard exactly like their params.
    adafactor: ((vr, vc) per param, t): vr drops the last param axis, vc
    the second-to-last (the rank-1 factored second moment)."""
    if arch in ADAFACTOR_ARCHS:
        def factor(spec, p):
            s = tuple(spec) + (None,) * (len(p.shape) - len(spec))
            if len(p.shape) >= 2:
                return (P(*s[:-1]), P(*(s[:-2] + s[-1:])))
            return (P(*s), None)
        return (_zip_map(factor, p_specs, params_shapes), P())
    return (p_specs, p_specs, P())


def _zip_map(fn, specs, shapes):
    """``fn(spec, leaf)`` over a spec tree and the matching param tree."""
    if isinstance(shapes, dict):
        return {k: _zip_map(fn, specs[k], v) for k, v in shapes.items()}
    return fn(specs, shapes)


# ------------------------------------------------------- fake tensors
def shape_tree(tree):
    """A tree of tensors -> the same tree of meta tensors (shape, dtype)."""
    return tree_map(lambda t: None if t is None else
                    torch.empty(t.shape, dtype=t.dtype, device="meta"), tree)


def sharded_full(shape, dtype, spec, mesh, fill=0):
    """A DTensor of ``shape`` laid out by ``spec``, allocating only this
    rank's local shard (filled with ``fill``)."""
    pl = placements(spec, mesh)
    local, _ = local_block(tuple(shape), mesh, pl)
    t = torch.full(tuple(local), fill, dtype=dtype, device=DEVICE)
    stride, acc = [], 1                   # contiguous, without a tensor
    for n in reversed(tuple(shape)):
        stride.insert(0, acc)
        acc *= n
    return DTensor.from_local(t, mesh, pl, run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def sharded_tree(shapes, specs, mesh, fills=None):
    """``sharded_full`` over a tree of meta tensors and its spec tree."""
    fills = fills if fills is not None else tree_map(lambda _: 0, shapes)

    def build(s, spec, fill):
        if s is None:
            return None
        return sharded_full(s.shape, s.dtype, spec, mesh, fill)
    return _map3(build, shapes, specs, fills)


def global_tree(shapes, fills=None):
    """Un-sharded fake tensors of a tree of meta tensors."""
    fills = fills if fills is not None else tree_map(lambda _: 0, shapes)
    return _map3(lambda s, _, f: None if s is None else torch.full(
        s.shape, f, dtype=s.dtype, device=DEVICE), shapes, shapes, fills)


def _map3(fn, a, b, c):
    if isinstance(a, dict):
        return {k: _map3(fn, a[k], b[k], c[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return type(a)(_map3(fn, x, y, z) for x, y, z in zip(a, b, c))
    return fn(a, b, c)


def _cache_fills(cfg: ModelConfig):
    """Each cache leaf's constant init value, read from a one-slot cache
    (the KV position ids start at -1, the sLSTM stabiliser at -1e9)."""
    def one(t):
        if t is None:
            return None
        v = t.flatten()[0]
        if not bool((t == v).all()):
            raise ValueError("a cache leaf is not constant at init")
        return v.item()
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    with unset_fake_temporarily():
        return tree_map(one, tf.init_cache(cfg, 1, 1, device="cpu"))


# ------------------------------------------------------------------ steps
def step_rules(arch: str, cfg: ModelConfig, shape: InputShape, mesh,
               microbatches=None) -> ShardingRules:
    """``build_lowerable``'s rules: the batch sharded where it divides the
    data axis, and activation FSDP where the remat-saved residual stream
    would not fit: saved-x bytes/dev = n_layers · (B_mb/data) · S · d · 2
    (bf16) above 3 GiB."""
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    shard_batch = shape.global_batch % sizes["data"] == 0
    mb_n = (MICROBATCHES.get(arch, 1) if microbatches is None
            else microbatches) if shape.kind == "train" else 1
    per_dev_b = max(shape.global_batch // mb_n // sizes["data"], 1)
    saved_x = cfg.n_layers * per_dev_b * shape.seq_len * cfg.d_model * 2
    shard_acts = shape.kind == "train" and saved_x > 3 * 2 ** 30
    return mesh_mod.make_rules(mesh, shard_batch=shard_batch,
                               shard_activations=shard_acts)


@dataclasses.dataclass
class Step:
    """A step ready to run: ``fn(*args)`` on the mesh (DTensor args),
    ``global_fn(*global_args)`` the same step on un-sharded tensors."""
    mesh: object
    rules: ShardingRules
    kind: str
    fn: object
    args: tuple
    global_fn: object
    global_args: tuple


def build_step(arch: str, shape, *, multi_pod: bool = False,
               cfg: ModelConfig = None, mesh=None, beta: float = 1.0,
               remat: bool = True, window_override=None,
               microbatches=None) -> Step:
    """The reference's ``build_lowerable``: params, optimizer state,
    caches and the batch as fake DTensors on the production mesh (or on
    ``mesh``), laid out by the rules, and the step that takes them.  Call
    inside ``FakeTensorMode`` with the (fake) process group initialised
    and the mesh made outside it (a ``DeviceMesh`` reads its ranks).
    ``shape`` is a name of ``SHAPES_BY_NAME`` or an ``InputShape``;
    ``cfg`` overrides the arch's config (e.g. cut in depth)."""
    cfg = get_config(arch) if cfg is None else cfg
    shape = SHAPES_BY_NAME[shape] if isinstance(shape, str) else shape
    if mesh is None:
        mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod,
                                             device_type=DEVICE)
    rules = step_rules(arch, cfg, shape, mesh, microbatches)

    params_shapes = shape_tree(tf.init_model(torch.Generator(), cfg,
                                             dtype=PARAM_DTYPE))
    p_specs = rules.pspec_tree(params_shapes)
    params = sharded_tree(params_shapes, p_specs, mesh)
    bspecs = input_specs(cfg, shape)
    b_pspec = batch_pspec_tree(bspecs, mesh, rules)
    batch = {k: sharded_full(s, dt, b_pspec[k], mesh)
             for k, (s, dt) in bspecs.items()}
    gparams = global_tree(params_shapes)
    gbatch = {k: torch.zeros(s, dtype=dt, device=DEVICE)
              for k, (s, dt) in bspecs.items()}
    window = (decode_window(cfg, shape) if window_override is None
              else window_override)

    if shape.kind == "train":
        optimizer, step = build_train_step(cfg, beta=beta, remat=remat,
                                           microbatches=microbatches)
        opt_shapes = shape_tree(optimizer.init(params_shapes))
        o_specs = _opt_state_pspecs(arch, p_specs, params_shapes)
        opt = sharded_tree(opt_shapes, o_specs, mesh)
        gopt = global_tree(opt_shapes)

        def fn(params, opt_state, batch, lr):
            with use_rules(rules):
                return step(params, opt_state, batch, lr)
        return Step(mesh, rules, "train", fn, (params, opt, batch, 1e-5),
                    fn, (gparams, gopt, gbatch, 1e-5))

    cap = cache_capacity(cfg, shape)
    cache_shapes = shape_tree(tf.init_cache(cfg, shape.global_batch, cap,
                                            device="meta"))
    c_pspec = cache_pspec_tree(cache_shapes, mesh, rules)
    fills = _cache_fills(cfg)

    if shape.kind == "prefill":
        def prefill(params, batch, caches):
            logits, _, (caches, _, _) = tf.forward(
                params, batch, cfg, dtype=torch.bfloat16, window=window,
                caches=caches, remat=False, attn_impl="torch")
            return last_logits(logits, cfg).clone(), caches

        def fn(params, batch):
            with use_rules(rules):
                return prefill(params, batch, sharded_tree(
                    cache_shapes, c_pspec, mesh, fills))

        def gfn(params, batch):
            return prefill(params, batch, global_tree(cache_shapes, fills))
        return Step(mesh, rules, "prefill", fn, (params, batch), gfn,
                    (gparams, gbatch))

    # decode: the caches are inputs, updated in place (the reference
    # donates them)
    caches = sharded_tree(cache_shapes, c_pspec, mesh, fills)
    gcaches = global_tree(cache_shapes, fills)

    def fn(params, caches, batch, pos):
        with use_rules(rules):
            return tf.decode_step(params, caches, batch, pos, cfg,
                                  dtype=torch.bfloat16, window=window)
    return Step(mesh, rules, "decode", fn, (params, caches, batch, cap - 1),
                fn, (gparams, gcaches, gbatch, cap - 1))


# ------------------------------------------------------- local-SGD (paper)
def build_local_sgd(arch: str, shape="train_4k", *,
                    inner_steps: int = 8, microbatches=None,
                    cfg: ModelConfig = None, mesh=None) -> Step:
    """The paper's FedAvg schedule as a cross-pod training strategy
    (DiLoCo): H inner steps per pod with NO cross-pod collectives, then
    ONE parameter mean across pods.

    The pod axis is a rank axis of the (2, 16, 16) mesh: each rank holds
    its pod's replica, laid out over the pod's own (data, model) mesh by
    single-pod rules (activation FSDP on, as the reference's inner rules
    have it), and the round ends in one ``all_reduce`` over the pod mesh
    dim of every local shard.  The batch is (H, B / n_pods, ...) per pod.
    ``shape`` is a name of ``SHAPES_BY_NAME`` or an ``InputShape``.
    """
    cfg = get_config(arch) if cfg is None else cfg
    shape = SHAPES_BY_NAME[shape] if isinstance(shape, str) else shape
    if mesh is None:
        mesh = mesh_mod.make_production_mesh(multi_pod=True,
                                             device_type=DEVICE)
    inner = mesh["data", "model"]
    pod_group = mesh.get_group("pod")
    n_pod = dist.get_world_size(pod_group)
    rules = ShardingRules(inner, fsdp_axis="data", tensor_axis="model",
                          data_axes=("data",), pod_axis=None,
                          shard_activations=True)
    optimizer, step = build_train_step(cfg, remat=True,
                                       microbatches=microbatches)
    params_shapes = shape_tree(tf.init_model(torch.Generator(), cfg,
                                             dtype=PARAM_DTYPE))
    p_specs = rules.pspec_tree(params_shapes)
    params = sharded_tree(params_shapes, p_specs, inner)
    opt_shapes = shape_tree(optimizer.init(params_shapes))
    opt = sharded_tree(opt_shapes, _opt_state_pspecs(
        arch, p_specs, params_shapes), inner)
    bspecs = input_specs(cfg, dataclasses.replace(
        shape, global_batch=shape.global_batch // n_pod))
    b_pspec = batch_pspec_tree(bspecs, inner, rules)
    batches = {k: sharded_full((inner_steps,) + s, dt,
                               P(None, *b_pspec[k]), inner)
               for k, (s, dt) in bspecs.items()}

    def round_fn(params, opt_state, batches, lr):
        from torch.distributed import _functional_collectives as funcol
        with use_rules(rules):
            for h in range(inner_steps):
                params, opt_state, m = step(
                    params, opt_state, {k: v[h] for k, v in batches.items()},
                    lr)
        # FedAvg across pods (Alg. 1 aggregation, once per H steps)
        with torch.no_grad():
            for t in tree_leaves(params):
                loc = t.to_local()
                loc.copy_(funcol.all_reduce(loc, "sum", pod_group) / n_pod)
        return params, opt_state, m["loss"]
    return Step(mesh, rules, "train", round_fn,
                (params, opt, batches, 1e-5), None, None)


# ------------------------------------------------------------- the run
@contextlib.contextmanager
def fake_process_group(world_size: int):
    """A fake process group of ``world_size`` ranks in this process, rank
    0: collectives return at once with results of the right shape."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _tensor_leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensor_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensor_leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


@contextlib.contextmanager
def dtensor_bookkeeping_apart(tracker: costmodel.StepTracker):
    """Keep DTensor's own bookkeeping out of the step:

    * it works out each op's output shape by running the op on
      placeholders of the GLOBAL shape (``ShardingPropagator.
      _propagate_tensor_meta_non_cached``); those run with ``tracker``
      paused, or a device would seem to hold global tensors;
    * it works out a ``_StridedShard``'s local offsets (a sharded dim
      flattened with its neighbours) from a ``torch.arange`` and
      ``.tolist()``, which a fake tensor cannot answer; that runs with the
      dispatch modes off, on a real index tensor of the local size.

    A torch whose DTensor lacks either function keeps its own."""
    from torch.utils._python_dispatch import _disable_current_modes
    patches = []
    try:
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        patches.append((ShardingPropagator,
                        "_propagate_tensor_meta_non_cached",
                        tracker.pause))
    except ImportError:
        pass
    try:
        from torch.distributed.tensor.placement_types import _StridedShard
        patches.append((_StridedShard, "local_shard_size_and_offset",
                        _disable_current_modes))
    except ImportError:
        pass
    # the collectives of an explicit redistribute (a constraint, an FSDP
    # gather, a local region's layout) are booked under its name
    patches.append((DTensor, "redistribute",
                    lambda: tracker.booking("redistribute")))
    saved = []
    for owner, name, ctx in patches:
        orig = owner.__dict__.get(name)
        if orig is None or isinstance(orig, (staticmethod, classmethod)):
            continue

        def wrapped(*a, _orig=orig, _ctx=ctx, **k):
            with _ctx():
                return _orig(*a, **k)
        saved.append((owner, name, orig))
        setattr(owner, name, wrapped)
    try:
        yield
    finally:
        for owner, name, orig in saved:
            setattr(owner, name, orig)


def measure(step: Step) -> Dict:
    """Run ``step`` twice: un-sharded for the global FLOPs and bytes, then
    on the mesh for collective bytes and per-device memory.  Call inside
    ``FakeTensorMode`` (as :func:`build_step` was)."""
    from torch.distributed.tensor.experimental import implicit_replication
    grad = step.kind == "train"
    t0 = time.perf_counter()
    with torch.set_grad_enabled(grad):
        gcost = costmodel.step_cost(step.global_fn, *step.global_args)
    t1 = time.perf_counter()
    tracker = costmodel.StepTracker()
    arg_bytes = tracker.hold(_tensor_leaves(step.args))
    with torch.set_grad_enabled(grad), dtensor_bookkeeping_apart(tracker), \
            tracker, implicit_replication():
        out = step.fn(*step.args)
    out_bytes = tracker.new_bytes(_tensor_leaves(out))
    t2 = time.perf_counter()
    return {"flops_global": gcost["flops"], "bytes_global": gcost["bytes"],
            "collective_bytes_per_device": dict(tracker.collectives),
            "collective_bytes_by_op": dict(sorted(
                tracker.collectives_by_op.items(),
                key=lambda kv: -kv[1])[:12]),
            "memory": {"argument_bytes": arg_bytes,
                       "output_bytes": out_bytes,
                       "temp_bytes": max(tracker.peak - out_bytes, 0)},
            "global_s": t1 - t0, "sharded_s": t2 - t1}


def mesh_of(shape) -> object:
    """A ``DeviceMesh`` of ``shape`` (1-3 dims: ("data", "model"), with
    "pod" first for three) over the initialised process group."""
    from torch.distributed.device_mesh import init_device_mesh
    names = ("pod", "data", "model")[-len(shape):] if len(shape) > 1 \
        else ("data",)
    return init_device_mesh(DEVICE, tuple(shape), mesh_dim_names=names)


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            mesh_shape=None, out_dir: str = OUT_DIR, quiet: bool = False,
            tag: str = "", reduced: bool = False, layers: int = 0,
            batch: int = 0, seq: int = 0, microbatches=None) -> Dict:
    """Build and measure one combination and write its record: on the
    production mesh, or on a mesh of ``mesh_shape``; the arch's config
    (``reduced()``, or cut to ``layers``) at the shape (``batch`` and
    ``seq`` replacing its own).  The (fake) process group must be up
    (:func:`fake_process_group`), of the mesh's size.  ``temp_bytes`` is
    the peak of local bytes the step holds above its arguments, less its
    outputs', so argument + temp + output bytes is the predicted
    per-device peak."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    t0 = time.perf_counter()
    mesh = (mesh_of(mesh_shape) if mesh_shape else
            mesh_mod.make_production_mesh(multi_pod=multi_pod,
                                          device_type=DEVICE))
    mesh_name = "x".join(map(str, mesh.shape))
    cfg = get_config(arch)
    cfg = cfg.reduced() if reduced else cfg
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    shape = SHAPES_BY_NAME[shape_name]
    shape = dataclasses.replace(shape, global_batch=batch or
                                shape.global_batch,
                                seq_len=seq or shape.seq_len)
    with FakeTensorMode():
        step = build_step(arch, shape, cfg=cfg, mesh=mesh,
                          microbatches=microbatches)
        t_build = time.perf_counter() - t0
        m = measure(step)
    n_chips = 1
    for s in mesh.shape:
        n_chips *= s
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "n_chips": n_chips, "n_layers": cfg.n_layers,
           "reduced": reduced, "global_batch": shape.global_batch,
           "seq_len": shape.seq_len, "kind": shape.kind, **m,
           "build_s": t_build}
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    path = out / f"{arch}__{shape_name}__{mesh_name}{suffix}.json"
    path.write_text(json.dumps(rec, indent=1))
    if not quiet:
        mem = rec["memory"]
        gb = (mem["argument_bytes"] + mem["temp_bytes"]
              + mem["output_bytes"]) / 2 ** 30
        coll = sum(rec["collective_bytes_per_device"].values())
        print(f"[dryrun] {arch} × {shape_name} × {mesh_name}: OK  "
              f"flops(global)={rec['flops_global']:.3e}  "
              f"bytes(global)={rec['bytes_global']:.3e}  "
              f"mem/dev≈{gb:.1f} GiB  coll/dev={coll / 2 ** 20:.0f} MiB  "
              f"(build {t_build:.0f}s, global {m['global_s']:.0f}s, "
              f"sharded {m['sharded_s']:.0f}s)", flush=True)
    return rec


def _run_all(combos, args) -> list:
    """Each combination in its own process, ``args.jobs`` at a time, each
    stopped at ``args.timeout`` seconds; returns the failures."""
    failures, running = [], []
    todo = list(combos)
    while todo or running:
        while todo and len(running) < args.jobs:
            arch, shape = todo.pop(0)
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--out", args.out]
            if args.multi_pod:
                cmd.append("--multi-pod")
            running.append(((arch, shape), time.monotonic(),
                            subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT,
                                             text=True)))
        time.sleep(0.5)
        for item in list(running):
            (arch, shape), t0, proc = item
            late = time.monotonic() - t0 > args.timeout
            if proc.poll() is None and not late:
                continue
            running.remove(item)
            if proc.poll() is None:
                proc.kill()
                proc.wait()
                line = (f"[dryrun] {arch} × {shape}: FAIL not done in "
                        f"{args.timeout:.0f} s")
                print(line, flush=True)
                failures.append((arch, shape, line))
                continue
            text = proc.stdout.read()
            lines = [ln for ln in text.splitlines()
                     if ln.startswith("[dryrun]")]
            print("\n".join(lines) or text[-2000:], flush=True)
            if proc.returncode and lines:
                print(text[-3000:], flush=True)      # where it failed
            if proc.returncode:
                failures.append((arch, shape, (lines or [text])[-1][-300:]))
    return failures


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES_BY_NAME))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--jobs", type=int, default=1,
                    help="with --all: combinations run in this many "
                    "processes at once")
    ap.add_argument("--timeout", type=float, default=3600.0,
                    help="with --all: seconds a combination may take")
    ap.add_argument("--mesh", default="",
                    help="a mesh such as 1x1 or 4x4 instead of the "
                    "production one (data x model; pod first for three)")
    ap.add_argument("--reduced", action="store_true",
                    help="the config's reduced() smoke variant")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut n_layers to this (0: the config's)")
    ap.add_argument("--batch", type=int, default=0,
                    help="global batch (0: the shape's)")
    ap.add_argument("--seq", type=int, default=0,
                    help="sequence length (0: the shape's)")
    ap.add_argument("--microbatches", type=int, default=None,
                    help="default: the arch's MICROBATCHES")
    args = ap.parse_args(argv)
    if args.all:
        # the longest first (train, then prefill), so each gets its time
        order = {"train": 0, "prefill": 1, "decode": 2}
        combos = sorted(((a, s) for a in ARCH_IDS for s in SHAPES_BY_NAME),
                        key=lambda c: order[SHAPES_BY_NAME[c[1]].kind])
        failures = _run_all(combos, args)
        if failures:
            raise SystemExit(f"{len(failures)} dry-run failures: {failures}")
        return
    if not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    mesh_shape = tuple(int(n) for n in args.mesh.split("x")) \
        if args.mesh else None
    if mesh_shape:
        world = 1
        for n in mesh_shape:
            world *= n
    else:
        world = 512 if args.multi_pod else 256
    with fake_process_group(world):
        try:
            run_one(args.arch, args.shape, multi_pod=args.multi_pod,
                    mesh_shape=mesh_shape, out_dir=args.out,
                    reduced=args.reduced, layers=args.layers,
                    batch=args.batch, seq=args.seq,
                    microbatches=args.microbatches)
        except Exception as e:                           # noqa: BLE001
            import traceback
            where = traceback.extract_tb(e.__traceback__)[-6:]
            print("".join(traceback.format_list(where)), flush=True)
            print(f"[dryrun] {args.arch} × {args.shape}: FAIL {e!r}"[:2000],
                  flush=True)
            raise SystemExit(1)


if __name__ == "__main__":
    main()
