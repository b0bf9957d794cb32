"""Device meshes of the sharded engine, over ``torch.distributed``.

The port of the reference's ``launch/mesh.py``: the production meshes of
the cells (``make_production_mesh``, ``make_mesh``), the 1-D edge mesh
and the 2-axis ``(d_e, d_v)`` edge x vertex mesh of the halo layout, and
``HW``, the card's figures the dry-run's roofline divides by. The
reference builds a ``jax.sharding.Mesh`` over the local devices; the
port is SPMD, so a mesh is a ``DeviceMesh`` over the ranks of an already
initialized world: NCCL on the card (one rank a card), gloo on the CPU
(``launch/dryrun.py``: a fake world of 256 or 512 of its own process).
The library never initializes a real process group itself — the caller
does, with ``torch.distributed.init_process_group`` (``torchrun`` sets
its address, world size and rank in the environment).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

# The axis that carries the vertex OWNER sharding of the halo layouts
# (and the edge slots of every sharded engine).
VERTEX_AXIS = "data"

# The pure-edge axis of the 2-axis factorization: edge slots shard over
# (EDGE_SHARD_AXIS, VERTEX_AXIS) flattened, vertex state over VERTEX_AXIS
# only, and completed statistics gain one all-reduce over this axis.
EDGE_SHARD_AXIS = "edge"


def _require_world() -> int:
    """The initialized world's size; refuses an uninitialized one."""
    if not dist.is_available() or not dist.is_initialized():
        raise ValueError(
            "the sharded engine needs an initialized process group: call "
            "torch.distributed.init_process_group (NCCL on the card, gloo "
            "on the CPU) on every rank first; the library never "
            "initializes one itself"
        )
    return dist.get_world_size()


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


# The card's figures (NVIDIA H100 SXM5 80GB, the data sheet's): dense
# bf16 tensor-core rate, HBM3 rate and size, NVLink 4 (18 links of 25 GB/s
# a direction, 450 GB/s a card within an 8-card node) and, for a group
# that spans more than one node of 8, one 400 Gb/s NDR InfiniBand port a
# card. The dry-run's collective term divides a collective's wire bytes
# by ``ici_bw_per_link * ici_links`` when the group's ranks lie in one
# node (``ranks_per_node``) and by ``ib_bw_per_gpu`` otherwise.
HW = {
    "name": "NVIDIA H100 80GB HBM3",
    "peak_flops_bf16": 989e12,     # per card, dense
    "hbm_bw": 3.35e12,             # bytes/s per card
    "ici_bw_per_link": 25e9,       # NVLink 4: bytes/s per link a direction
    "ici_links": 18,               # NVLink 4 links per card
    "hbm_bytes": 80e9,
    "ib_bw_per_gpu": 50e9,         # bytes/s, 400 Gb/s NDR a card
    "ranks_per_node": 8,
}


def make_mesh(shape, axes):
    """A ``DeviceMesh`` of ``shape`` with dimension names ``axes`` over
    the ranks of the initialized world, in rank order
    (``arange(world).reshape(shape)``). A world smaller than the mesh
    raises ``ValueError`` with the reference's message; a mesh spans the
    whole world, so a larger one raises too."""
    from torch.distributed.device_mesh import DeviceMesh

    shape, axes = tuple(int(d) for d in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    world = _require_world()
    size = int(torch.Size(shape).numel())
    if world < size:
        raise ValueError(f"Number of devices {world} must be >= the "
                         f"product of mesh_shape {shape}")
    if world > size:
        raise ValueError(f"mesh_shape {shape} covers {size} of the "
                         f"world's {world} ranks: a mesh spans the whole "
                         "world (one rank a device)")
    return DeviceMesh(_device_type(), torch.arange(world).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 ``("data", "model")`` single pod (256 ranks) or 2x16x16
    ``("pod", "data", "model")`` two-pod (512 ranks), over the
    initialized world (``launch/dryrun.py`` makes a fake one)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_edge_mesh(n_devices=None, axis: str = "data"):
    """1-D ``DeviceMesh`` over every rank of the initialized world, with
    dimension name ``axis`` — the mesh ``CoreMaintainer(engine=
    "sharded")`` consumes by default. Its device type follows the
    world's backend: ``"cuda"`` under NCCL, ``"cpu"`` otherwise.
    ``n_devices``, when given, must equal the world size."""
    from torch.distributed.device_mesh import DeviceMesh

    world = _require_world()
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(
            f"n_devices={n_devices} but the world has {world} ranks: a "
            "mesh spans the whole world (one rank a device)"
        )
    return DeviceMesh(_device_type(), torch.arange(world),
                      mesh_dim_names=(axis,))


def make_edge_vertex_mesh(n_devices=None, mesh_shape=None,
                          axis: str = VERTEX_AXIS,
                          edge_axis: str = EDGE_SHARD_AXIS):
    """Mesh for the halo-sharded vertex layouts.

    ``mesh_shape=(d_e, d_v)`` builds the 2-axis factorization: ``d_e``
    pure-edge shards x ``d_v`` vertex-owner ranges, a 2-D
    ``DeviceMesh`` with dims ``(edge_axis, axis)`` over
    ``arange(world).reshape(d_e, d_v)``. Rank ``e * d_v + v`` holds
    edge-slot block ``e * d_v + v`` (the flattened order, as on the 1-D
    mesh, so the degenerate ``(1, d)`` and ``(d, 1)`` shapes give the
    single-axis engines' slot tables) and owns vertex range ``v``; the
    vertex state is replicated across ``edge_axis``.

    ``mesh_shape=None`` is the single shared axis (``make_edge_mesh``):
    rank ``i`` holds edge shard ``i`` AND vertex range ``i``, the mesh of
    ``vertex_sharding="range"``. ``n_devices``, when given, must equal
    the world size, as must ``d_e * d_v``."""
    from torch.distributed.device_mesh import DeviceMesh

    if mesh_shape is None:
        return make_edge_mesh(n_devices, axis)
    d_e, d_v = (int(mesh_shape[0]), int(mesh_shape[1]))
    if d_e < 1 or d_v < 1:
        raise ValueError(f"mesh_shape must be positive, got {mesh_shape}")
    world = _require_world()
    ndev = int(n_devices) if n_devices is not None else world
    if d_e * d_v != ndev:
        raise ValueError(
            f"mesh_shape {d_e}x{d_v} needs {d_e * d_v} devices, have "
            f"{ndev}"
        )
    if ndev != world:
        raise ValueError(
            f"n_devices={n_devices} but the world has {world} ranks: a "
            "mesh spans the whole world (one rank a device)"
        )
    return DeviceMesh(_device_type(), torch.arange(world).reshape(d_e, d_v),
                      mesh_dim_names=(edge_axis, axis))


def table_group(mesh):
    """The process group the edge slots are sharded over: every rank of
    ``mesh`` in the flattened order ``rank = e * d_v + v``, the order a
    collective over the reference's axis tuple ``("edge", "data")``
    runs in (torch has no collective over a product of groups). On a
    1-D mesh it is the mesh's one group.

    ``new_group`` is collective (every rank must call it, in the same
    order), so the group is built once a mesh, at the first call, and
    kept on the mesh."""
    if mesh.ndim == 1:
        return mesh.get_group(0)
    group = getattr(mesh, "_repro_table_group", None)
    if group is None:
        ranks = mesh.mesh.flatten().tolist()
        if ranks != sorted(ranks):
            # a group's ranks are numbered in ascending global rank
            raise ValueError(
                f"the mesh's flattened ranks {ranks} are not ascending: "
                "the table group would not number them e * d_v + v"
            )
        group = dist.new_group(ranks=ranks)
        mesh._repro_table_group = group
    return group
