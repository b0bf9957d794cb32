"""Device meshes of the sharded engine, over ``torch.distributed``.

The port of the reference's ``launch/mesh.py`` for the 1-D edge mesh.
The reference builds a ``jax.sharding.Mesh`` over the local devices;
the port is SPMD, so a mesh is a ``DeviceMesh`` over the ranks of an
already initialized world: NCCL on the card (one rank a card), gloo on
the CPU. The library never initializes a process group itself — the
caller does, with ``torch.distributed.init_process_group`` (``torchrun``
sets its address, world size and rank in the environment).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

# The axis that carries the vertex OWNER sharding of the range layout
# (and the edge slots of every sharded engine).
VERTEX_AXIS = "data"

# The pure-edge axis of the 2-axis factorization (ROADMAP Queue 1 B
# item 3).
EDGE_SHARD_AXIS = "edge"


def make_edge_mesh(n_devices=None, axis: str = "data"):
    """1-D ``DeviceMesh`` over every rank of the initialized world, with
    dimension name ``axis`` — the mesh ``CoreMaintainer(engine=
    "sharded")`` consumes by default. Its device type follows the
    world's backend: ``"cuda"`` under NCCL, ``"cpu"`` otherwise.
    ``n_devices``, when given, must equal the world size."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_available() or not dist.is_initialized():
        raise ValueError(
            "the sharded engine needs an initialized process group: call "
            "torch.distributed.init_process_group (NCCL on the card, gloo "
            "on the CPU) on every rank first; the library never "
            "initializes one itself"
        )
    world = dist.get_world_size()
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(
            f"n_devices={n_devices} but the world has {world} ranks: a "
            "mesh spans the whole world (one rank a device)"
        )
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(world),
                      mesh_dim_names=(axis,))


def make_edge_vertex_mesh(n_devices=None, mesh_shape=None,
                          axis: str = VERTEX_AXIS,
                          edge_axis: str = EDGE_SHARD_AXIS):
    """Mesh for the vertex layouts. ``mesh_shape=None`` is the single
    shared axis (``make_edge_mesh``), the mesh of
    ``vertex_sharding="range"``; the 2-axis ``(d_e, d_v)`` edge x vertex
    factorization comes with the halo layout, ROADMAP Queue 1 B item
    3."""
    if mesh_shape is not None:
        raise NotImplementedError(
            "the 2-axis edge x vertex mesh (mesh_shape) comes with the "
            "halo layout, ROADMAP Queue 1 B item 3"
        )
    return make_edge_mesh(n_devices, axis)
