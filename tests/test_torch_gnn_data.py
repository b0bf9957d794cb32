"""The GNN stack's host side: the port's ``build_triplets``,
``data/graphs.py`` (``load_cora_like``, ``random_molecule_batch``),
``graph/sampler.py`` (``NeighborSampler``, ``SampledBlock``) and the four
GNN configs against the reference's, on the CPU.

Tolerance: none. The arrays are equal bit for bit (values; the port's
batch holds its index columns as int64 where the reference's are
int32), the configs field by field with ``msg_dtype`` mapped from
``jnp`` to ``torch``."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.data.graphs import load_cora_like as ref_cora  # noqa: E402
from repro.data.graphs import random_molecule_batch as ref_molecules  # noqa: E402
from repro.graph.generators import erdos_renyi as ref_er  # noqa: E402
from repro.graph.generators import rmat as ref_rmat  # noqa: E402
from repro.graph.sampler import NeighborSampler as RefSampler  # noqa: E402
from repro.models import gnn as J  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.data import graphs as D  # noqa: E402
from repro_torch.graph.generators import erdos_renyi, rmat  # noqa: E402
from repro_torch.graph.sampler import NeighborSampler  # noqa: E402
from repro_torch.models import gnn as T  # noqa: E402

from test_torch_gnn_models import steps_batch  # noqa: E402

GNN_ARCHS = ["pna", "gin-tu", "dimenet", "nequip"]
INDEX = ("senders", "receivers", "graph_id", "species")


def _assert_batch_equal(got: T.GraphBatch, want: J.GraphBatch):
    assert got.n_graphs == want.n_graphs
    for f in dataclasses.fields(want):
        if f.name == "n_graphs":
            continue
        w, g = getattr(want, f.name), getattr(got, f.name)
        if w is None:
            assert g is None, f.name
            continue
        w = np.asarray(w)
        assert g.device.type == "cpu"
        want_dtype = torch.from_numpy(np.zeros(0, w.dtype)).dtype
        assert g.dtype == (torch.int64 if f.name in INDEX
                           else want_dtype), f.name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f.name)


# -- build_triplets -----------------------------------------------------------

def _triplet_inputs(case):
    if case.startswith("molecule"):
        b = ref_molecules(n_mols=4, n_atoms=8, n_edges=24,
                          seed=int(case[-1]))
        return (np.asarray(b.senders), np.asarray(b.receivers),
                np.asarray(b.edge_mask))
    a, _ = steps_batch(64, 256, 1, 1, seed=int(case[-1]))
    return a["senders"], a["receivers"], a["edge_mask"]


@pytest.mark.parametrize("cap", [None, 37])
@pytest.mark.parametrize("case", ["molecule0", "molecule1", "steps2"])
def test_build_triplets_equals_reference(case, cap):
    s, r, m = _triplet_inputs(case)
    cap = 2 * s.shape[0] if cap is None else cap
    want = J.build_triplets(s, r, m, cap)
    got = T.build_triplets(s, r, m, cap)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    kj, ji, tm = T.triplet_tensors(got, device="cpu")
    assert kj.dtype == ji.dtype == torch.int64 and tm.dtype == torch.bool
    np.testing.assert_array_equal(kj.numpy(), want[0])


# -- data/graphs.py -----------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(),
    dict(n=128, m=256, d_feat=32, n_classes=4, seed=0),
    dict(n=300, m=900, d_feat=16, n_classes=3, seed=7),
])
def test_load_cora_like_equals_reference(kw):
    g, batch, labels = D.load_cora_like(**kw, device="cpu")
    rg, rbatch, rlabels = ref_cora(**kw)
    assert g.n == rg.n
    np.testing.assert_array_equal(g.indptr, rg.indptr)
    np.testing.assert_array_equal(g.indices, rg.indices)
    np.testing.assert_array_equal(labels, rlabels)
    _assert_batch_equal(batch, rbatch)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(n_mols=4, n_atoms=8, n_edges=24, seed=1),
    dict(n_mols=16, n_atoms=30, n_edges=64, n_species=5, seed=2),
])
def test_random_molecule_batch_equals_reference(kw):
    _assert_batch_equal(D.random_molecule_batch(**kw, device="cpu"),
                        ref_molecules(**kw))


def test_graph_batch_to_converts_index_columns_once():
    b = T.GraphBatch.from_numpy(
        1, node_feat=np.zeros((3, 2), np.float32),
        senders=np.array([0, 1], np.int32), receivers=np.array([1, 2],
                                                               np.int32),
        edge_mask=np.ones(2, bool), node_mask=np.ones(3, bool),
        graph_id=np.zeros(3, np.int32))
    assert b.senders.dtype == torch.int32 and b.positions is None
    c = b.to("cpu")
    assert c.senders.dtype == c.receivers.dtype == c.graph_id.dtype \
        == torch.int64
    assert c.edge_mask.dtype == torch.bool
    assert c.node_feat.dtype == torch.float32 and c.positions is None
    d = c.to("cpu")
    assert d.senders.data_ptr() == c.senders.data_ptr()  # no second copy


# -- graph/sampler.py ---------------------------------------------------------

def _graphs(kind):
    if kind == "er":
        return erdos_renyi(500, 3000, seed=0), ref_er(500, 3000, seed=0)
    return rmat(11, 20_000, seed=1), ref_rmat(11, 20_000, seed=1)


@pytest.mark.parametrize("fanouts", [(5, 3), (15, 10)])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", ["er", "rmat"])
def test_neighbor_sampler_blocks_equal_reference(kind, seed, fanouts):
    g, rg = _graphs(kind)
    s = NeighborSampler(g, fanouts=fanouts, seed=seed)
    rs = RefSampler(rg, fanouts=fanouts, seed=seed)
    pick = np.random.default_rng(100 + seed)
    for size in (5, 16, 16):  # one sampler, its rng carried across calls
        nodes = pick.choice(g.n, size=size, replace=False)
        nodes[-1] = nodes[0]  # a repeated seed
        blk, rblk = s.sample(nodes), rs.sample(nodes)
        for f in dataclasses.fields(rblk):
            w, got = getattr(rblk, f.name), getattr(blk, f.name)
            assert got.dtype == w.dtype, f.name
            np.testing.assert_array_equal(got, w, err_msg=f.name)
        live = blk.edge_mask
        ids = blk.node_ids
        assert blk.node_mask[blk.senders[live]].all()
        assert blk.node_mask[blk.receivers[live]].all()
        for a, b in zip(ids[blk.senders[live]], ids[blk.receivers[live]]):
            assert g.has_edge(int(a), int(b))


# -- configs ------------------------------------------------------------------

def _fields(cfg):
    out = dataclasses.asdict(cfg)
    if "msg_dtype" in out:
        dt = out.pop("msg_dtype")
        out["msg_dtype"] = {jnp.float32: "float32", torch.float32: "float32",
                            jnp.bfloat16: "bfloat16",
                            torch.bfloat16: "bfloat16"}[dt]
    return out


@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("name", GNN_ARCHS)
def test_gnn_configs_equal_reference(name, size):
    a, b = configs.get_arch(name), ref_configs.get_arch(name)
    assert a.FAMILY == b.FAMILY == "gnn"
    for cells in ("SHAPES", "SHAPES_SMOKE"):
        assert [dataclasses.astuple(c) for c in getattr(a, cells)] == [
            dataclasses.astuple(c) for c in getattr(b, cells)]
    ca, cb = getattr(a, size)(), getattr(b, size)()
    assert type(ca).__name__ == type(cb).__name__
    assert type(ca).__module__ == "repro_torch.models.gnn"
    assert _fields(ca) == _fields(cb)


@pytest.mark.parametrize("name", GNN_ARCHS)
def test_shard_axes_other_than_none_raises(name):
    """Every config takes ``shard_axes`` (the pod cells' pin); on plain
    tensors it changes nothing, and on a sharded batch a segment count
    the axes' ranks do not divide raises, as the reference requires
    (cells pad to 512). The sharded paths' values: 4 gloo ranks in
    ``tests/test_torch_sharded_models_ranks.py``."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import gnn
    from repro_torch.parallel.sharding import P, distribute

    cfg = configs.get_arch(name).smoke()
    assert cfg.shard_axes is None
    pinned = dataclasses.replace(cfg, shard_axes=("data", "model"))
    assert pinned.shard_axes == ("data", "model")
    x, ids = torch.ones(8, 3), torch.arange(8) % 6
    assert torch.equal(gnn._sharded_seg_sum(x, ids, 6, pinned.shard_axes),
                       gnn._seg_sum(x, ids, 6))
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=4)
    try:
        mesh = make_mesh((2, 2), ("data", "model"))
        xs = distribute(x, P(("data", "model"), None), mesh)
        ids_s = distribute(ids, P(("data", "model")), mesh)
        with pytest.raises(ValueError, match="do not split over the 4"):
            gnn._sharded_seg_sum(xs, ids_s, 6, pinned.shard_axes)
        with pytest.raises(ValueError, match="do not split over the 4"):
            gnn._sharded_gather(distribute(torch.ones(6, 3), P(), mesh),
                                ids_s, pinned.shard_axes)
    finally:
        dist.destroy_process_group()
