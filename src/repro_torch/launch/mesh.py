"""The production mesh, its sharding rules, and the hardware constants of
one card: the counterpart of ``src/repro/launch/mesh.py``.

``make_production_mesh`` builds the reference's mesh shapes and axis names,
(16, 16) ``("data", "model")`` and (2, 16, 16) ``("pod", "data",
"model")``, as a ``DeviceMesh`` over the initialised process group, so that
the port's dry-run records compare with the reference's.  The shapes say
nothing of how 256 H100s are wired: an 8-card node joins its cards by
NVLink, and a mesh axis that spans nodes crosses the slower network.
It is a function, not a module constant, so importing this module touches
no process group.

The constants are the published peaks of the NVIDIA H100 SXM5 (NVIDIA's
data sheet, dense, no sparsity, at its 700 W limit): bf16 on the tensor
cores, HBM3, NVLink 4 per direction, and the 80 GB of HBM3 that
``nvidia-smi`` reports as 81,559 MiB.  The card these numbers are used
with, as ``nvidia-smi --query-gpu=name,power.limit`` reports it on the runs
that PERF.md records: NVIDIA H100 80GB HBM3, 700.00 W.  A card set below
700 W runs slower under load; read its limit beside every share of these
peaks.
"""
from __future__ import annotations

import torch.distributed as dist

from repro_torch.sharding import ShardingRules

PEAK_FLOPS = 989.4e12        # bf16 dense, tensor cores
HBM_BW = 3.35e12             # bytes/s
NVLINK_BW = 450e9            # bytes/s per direction
HBM_BYTES = 81_559 * 2 ** 20  # 80 GB, as nvidia-smi reports it


def production_shape(multi_pod: bool = False):
    """(shape, axis names) of the reference's production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """The reference's 16 x 16 (or 2 x 16 x 16) mesh as a ``DeviceMesh``
    over the initialised process group, whose world size must be the
    mesh's."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = production_shape(multi_pod)
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != n:
        raise ValueError(f"the {'x'.join(map(str, shape))} mesh needs a "
                         f"process group of {n} ranks, not {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_rules(mesh, *, shard_batch: bool = True,
               shard_activations: bool = False) -> ShardingRules:
    multi = "pod" in mesh.mesh_dim_names
    # on the multi-pod mesh FSDP spans BOTH pod and data axes (32-way):
    # params/grads/optimizer shrink 2x per card vs single-pod
    return ShardingRules(mesh,
                         fsdp_axis=("pod", "data") if multi else "data",
                         tensor_axis="model",
                         data_axes=("data",),
                         pod_axis="pod" if multi else None,
                         shard_batch=shard_batch,
                         shard_activations=shard_activations)
