"""CPU tests of ``spans.py``, the reading of the program's own spans, on
synthetic profiler events: the nesting, the self time, the kernels by
the span they were launched in, and the device's idle time inside a
span; and the program's spans, host ranges only, leave what
``tracing.summarize`` reads as it was."""
from types import SimpleNamespace

import pytest

from corebench import spans, tracing


def _event(name, t0, t1, on_device=False, corr=0, kernels=(),
           annotation=False):
    from torch.autograd import DeviceType
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=t0, end=t1),
        device_type=DeviceType.CUDA if on_device else DeviceType.CPU,
        id=corr, is_user_annotation=annotation,
        kernels=[SimpleNamespace(name=k, duration=d) for k, d in kernels])


SORT = "void cub::sort(int)"
ROUND = "void removal_round_kernel(int const*)"
SCATTER = "void at::native::_scatter_gather(int)"
INDEX = "void at::native::indexFuncLargeIndex(int)"
BENCH = [
    _event("burst_remove", 0, 100, corr=1, annotation=True),
    _event("burst_insert", 100, 200, corr=2, annotation=True),
    _event("burst_remove", 0, 100, True, annotation=True),
    _event("aten::argsort", 6, 10, corr=10, kernels=[(SORT, 10)]),
    _event("aten::scatter_reduce_", 32, 35, corr=12,
           kernels=[(SCATTER, 8)]),
    # the profiler's own bookkeeping, handed the op's kernel as well
    _event("Lazy Function Loading", 33, 34, corr=12,
           kernels=[(SCATTER, 8)]),
    _event("aten::index_add_", 115, 117, corr=13, kernels=[(INDEX, 30)]),
    _event("cudaStreamSynchronize", 150, 190),
    _event(SORT, 8, 18, True),
    _event(ROUND, 22, 37, True),
    _event(SCATTER, 40, 48, True),
    _event(INDEX, 120, 150, True),
]
# the program's spans: host ranges; a hand-written kernel launched inside
# no aten op is handed to the span it was launched in
PROGRAM = [
    _event("api.apply_batch", 2, 98, corr=20),
    _event("engine.batch_program", 4, 96, corr=21),
    _event("engine.lookup", 5, 12, corr=22),
    _event("remove.round", 20, 50, corr=23, kernels=[(ROUND, 15)]),
    _event("order.place_block", 30, 45, corr=24),
    _event("api.apply_batch", 102, 198, corr=25),
    _event("insert.round", 110, 180, corr=26),
]
NAMES = ("api.apply_batch", "engine.batch_program", "engine.lookup",
         "remove.round", "insert.round", "order.place_block")


def test_program_spans_leave_the_trace_summary_as_it_was():
    kernels = ["removal_round_kernel"]
    before = tracing.summarize(BENCH, ("burst_remove", "burst_insert"),
                               kernels)
    after = tracing.summarize(BENCH + PROGRAM,
                              ("burst_remove", "burst_insert"), kernels)
    # busy: [8, 18] + [22, 37] + [40, 48] + [120, 150]
    assert before["busy_s"] == after["busy_s"] == pytest.approx(63e-6)
    assert before["kernel_s"] == after["kernel_s"] == pytest.approx(15e-6)
    assert before["breakdown"]["device_ops"] == \
        after["breakdown"]["device_ops"]
    # an idle gap where no host op was open takes the innermost span's
    # name in place of "host"
    gaps = {k: pytest.approx(v * 1e-6) for k, v in (
        ("burst_remove/host", 87),
        ("burst_insert/cudaStreamSynchronize", 50))}
    assert dict(before["breakdown"]["idle_gaps"]) == gaps
    del gaps["burst_remove/host"]
    gaps.update({k: pytest.approx(v * 1e-6) for k, v in (
        ("burst_remove/engine.batch_program", 80),
        ("burst_remove/remove.round", 4),
        ("burst_remove/order.place_block", 3))})
    assert dict(after["breakdown"]["idle_gaps"]) == gaps


def test_span_summary_splits_self_device_and_idle_time():
    out = spans.span_summary(BENCH + PROGRAM, NAMES)
    assert set(out) == set(NAMES)
    got = {k: (v["count"], v["host_s"] * 1e6, v["self_s"] * 1e6,
               v["device_s"] * 1e6, v["idle_s"] * 1e6)
           for k, v in out.items()}
    want = {
        # 96 + 96 us; less the program (92) and the insertion round (70)
        "api.apply_batch": (2, 192, 30, 0, 96 - 33 + 96 - 30),
        "engine.batch_program": (1, 92, 55, 0, 92 - 33),
        "engine.lookup": (1, 7, 7, 10, 7 - 4),
        # the kernel launched by the round's own code; the scatter
        # inside place_block is place_block's, counted once
        "remove.round": (1, 30, 15, 15, 30 - 23),
        "order.place_block": (1, 15, 15, 8, 15 - 12),
        "insert.round": (1, 70, 70, 30, 70 - 30),
    }
    for name, row in want.items():
        assert got[name] == pytest.approx(row), name
    assert out["order.place_block"]["kernels"] == [
        ["at::native::_scatter_gather", pytest.approx(8e-6)]]
    # every kernel of the trace was launched inside a program span
    assert sum(v["device_s"] for v in out.values()) == pytest.approx(63e-6)


def test_span_summary_ignores_device_ranges_and_ticks():
    """A device-side range of a span is no device work; a span that opens
    in the microsecond its sibling closes in is no child of it."""
    extra = [_event("remove.round", 22, 48, True, annotation=True),
             _event("engine.tombstone", 12, 20, corr=27)]
    out = spans.span_summary(BENCH + PROGRAM + extra,
                             NAMES + ("engine.tombstone",))
    assert out["remove.round"]["idle_s"] == pytest.approx(7e-6)
    assert out["engine.lookup"]["self_s"] == pytest.approx(7e-6)
    assert out["engine.tombstone"]["self_s"] == pytest.approx(8e-6)
    assert out["engine.batch_program"]["self_s"] == pytest.approx(47e-6)


def test_span_summary_without_program_spans():
    assert spans.span_summary(BENCH, NAMES) == {}
    assert spans.span_summary(BENCH + PROGRAM, ()) == {}
    from repro_torch import trace
    assert spans.program_spans() == trace.SPANS
