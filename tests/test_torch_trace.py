"""The port's tracing (``repro_torch.trace``): the spans the unified
engine's batch path opens and the sync counter it keeps.

* with no profiler recording, ``span()`` is the shared no-op and calls
  no profiler op;
* under ``torch.profiler`` on the CPU one ``apply_batch`` yields the span
  tree ``api.apply_batch`` > ``engine.batch_program`` > (``engine.lookup``,
  ``engine.tombstone``, ``engine.dedup``, ``engine.alloc``,
  ``engine.renumber``, ``remove.round``, ``insert.round`` > ...), with as
  many round spans as ``BatchStats`` counts rounds;
* ``SYNCS`` equals what ``analysis.walker.RoundRecorder`` records for the
  same batch, per issuing function and kind, and names only
  ``hostlint.SYNC_SITES`` entries.

The ``gpu`` tests make the same checks on the card with the hand-written
kernels, and check that the spans leave no device-side range and that
every kernel a batch launches is linked to a span; they skip here.
"""
import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch import trace
from repro_torch.analysis import hostlint
from repro_torch.analysis.walker import RoundRecorder, count_syncs
from repro_torch.core.api import CoreMaintainer
from repro_torch.graph.generators import rmat
from repro_torch.graph.stream import mixed_stream

SITES = {f"{s.where}:{s.kind}" for s in hostlint.SYNC_SITES}


def _maintainer(device="cpu", **kw):
    g = rmat(8, 1200, seed=0)
    return g, CoreMaintainer.from_graph(g, device=device, **kw)


def _batches(g, k=3):
    return [(ev.edges, ev.removals) for ev in mixed_stream(g, k, 96, seed=0)]


def _parent_span(e):
    p = e.cpu_parent
    while p is not None and p.name not in trace.SPANS:
        p = p.cpu_parent
    return p.name if p is not None else None


def test_span_without_a_profiler_is_the_shared_noop(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a profiler op ran with no profiler")

    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new",
                        refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    assert trace.span("api.apply_batch", batch=3) is trace._OFF
    assert trace.span("order.place_block") is trace._OFF
    with trace.span("remove.round"):
        pass
    assert trace.spanned("x")(lambda a, b=1: a + b)(2, b=3) == 5
    g, m = _maintainer()
    ins, rm = _batches(g, 1)[0]
    m.apply_batch(insert_edges=ins, remove_edges=rm)


def test_one_batch_yields_the_span_tree():
    g, m = _maintainer()
    batches = _batches(g)
    for ins, rm in batches[:-1]:
        m.apply_batch(insert_edges=ins, remove_edges=rm)
    ins, rm = batches[-1]
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        st = m.apply_batch(insert_edges=ins, remove_edges=rm)
    spans = [e for e in prof.events() if e.name in trace.SPANS]
    by = {}
    for e in spans:
        by.setdefault(e.name, []).append(_parent_span(e))
    rm_rounds, ins_rounds = int(st.remove_rounds), int(st.insert_rounds)
    assert ins_rounds >= 1 and rm_rounds >= 2
    assert by["api.apply_batch"] == [None]
    assert by["engine.batch_program"] == ["api.apply_batch"]
    for name in ("engine.lookup", "engine.tombstone", "engine.dedup",
                 "engine.alloc", "engine.renumber"):
        assert by[name] == ["engine.batch_program"], name
    assert by["remove.round"] == ["engine.batch_program"] * rm_rounds
    assert by["insert.round"] == ["engine.batch_program"] * ins_rounds
    assert by["insert.forward_reach"] == ["insert.round"] * ins_rounds
    assert by["insert.evict"] == ["insert.round"] * ins_rounds
    # one placement a removal round that dropped, two a promotion round
    assert sorted(by["order.place_block"]) == (
        ["insert.round"] * (2 * ins_rounds)
        + ["remove.round"] * (rm_rounds - 1))
    assert set(by) <= set(trace.SPANS) - {
        "order.place_block_ring", "HaloSession.complete",
        "HaloSession.gather_values"}
    [root] = [e for e in spans if e.name == "api.apply_batch"]
    assert root.kwinputs == {"batch": len(batches)}
    # the spans are host ranges the profiler nests its ops in
    assert all(e.device_type == DeviceType.CPU for e in spans)


def _recorded(sites) -> dict:
    return {f"{where}:{kind}": n
            for kind, d in count_syncs(sites).items()
            for where, n in d.items()}


def _check_counter(m, batches):
    for ins, rm in batches:
        trace.reset_syncs()
        with RoundRecorder() as rec:
            st = m.apply_batch(insert_edges=ins, remove_edges=rm)
        got = dict(trace.SYNCS)
        assert got == _recorded(rec.sites)
        assert set(got) <= SITES
        rounds = int(st.remove_rounds) + int(st.insert_rounds)
        assert got["core/remove.py::removal_fixpoint:round"] \
            + got["core/insert.py::promotion_fixpoint:round"] == rounds


@pytest.mark.parametrize("kind", ["mixed", "remove", "insert", "growth"])
def test_sync_counter_equals_the_recorder(kind):
    """Per issuing function and kind, over a mixed stream, removal-only
    and insertion-only batches, and batches whose window grows (the
    exact-bound refresh in ``api._refresh_bounds``; room for them, so
    no re-layout, whose syncs no ``SYNC_SITES`` entry names)."""
    g, m = _maintainer(capacity=8192 if kind == "growth" else None)
    batches = _batches(g)
    if kind == "remove":
        batches = [(None, rm) for _, rm in batches]
    elif kind == "insert":
        batches = [(ins, None) for ins, _ in batches]
    elif kind == "growth":
        rng = np.random.default_rng(1)
        batches = [(rng.integers(0, g.n, size=(600, 2)), None)
                   for _ in range(3)]
    refreshed = 0
    for batch in batches:
        _check_counter(m, [batch])
        refreshed += trace.SYNCS.get("core/api.py::_refresh_bounds:round", 0)
    assert (refreshed > 0) == (kind == "growth")


def test_reset_and_device_filter():
    trace.reset_syncs()
    trace.count_sync("k", 2)
    trace.count_sync("k", device=torch.device("cpu"))
    trace.count_sync("k", device=torch.device("meta"))
    assert trace.SYNCS == {"k": 3}
    trace.reset_syncs()
    assert trace.SYNCS == {}


# -- on the card ---------------------------------------------------------------
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run on the card only")
    return torch.device("cuda")


@pytest.mark.gpu
def test_sync_counter_equals_the_recorder_on_the_card():
    """On the card every host-to-device copy syncs too: the lane uploads,
    the rounds counts and ``valid[slots] = True``."""
    dev = _card()
    g, m = _maintainer(dev, kernel_backend="cuda")
    _check_counter(m, _batches(g))
    assert trace.SYNCS["core/api.py::apply_batch:hidden"] == 6


@pytest.mark.gpu
def test_spans_on_the_card_link_every_kernel():
    """No span leaves a device-side range, and every kernel the batch
    launches is handed to a host event inside the batch's root span (the
    profiler hands it to each event of the launching op's correlation id:
    counted once an id)."""
    dev = _card()
    g, m = _maintainer(dev, kernel_backend="cuda")
    batches = _batches(g)
    for ins, rm in batches[:-1]:
        m.apply_batch(insert_edges=ins, remove_edges=rm)
    torch.cuda.synchronize()
    ins, rm = batches[-1]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        m.apply_batch(insert_edges=ins, remove_edges=rm)
        torch.cuda.synchronize()
    evs = prof.events()
    dev_evs = [e for e in evs if e.device_type == DeviceType.CUDA]
    assert dev_evs and not [e.name for e in dev_evs
                            if e.name in trace.SPANS]
    [root] = [e for e in evs if e.name == "api.apply_batch"]
    linked, ids = 0, set()
    for e in sorted(evs, key=lambda e: e.time_range.start):
        if (e.device_type != DeviceType.CUDA and e.kernels
                and e.id not in ids):
            ids.add(e.id)
            if root.time_range.start <= e.time_range.start \
                    <= root.time_range.end:
                linked += sum(k.duration for k in e.kernels)
    total = sum(e.time_range.end - e.time_range.start for e in dev_evs)
    assert 0.95 * total <= linked <= 1.001 * total, (linked, total)
