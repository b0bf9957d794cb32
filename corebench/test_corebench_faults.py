"""The check that decides ``correct`` must fail what it is there to catch:
the control (the reference with its removal fixpoint cut to one round) and
the timed path broken underneath the harness, once for each fault a
one-card cell can have (no exchange between cards exists to leave out),
a mixed batch's insertion and a weighted cell's weights among them.
And, on a card only, one short run of a tiny cell through the kernels."""
import pytest
import torch

from corebench import harness, tiny
from corebench.control import Control
from corebench.test_corebench_harness import add_weighted_cell


@pytest.fixture
def tiny_root(tmp_path):
    return tiny.make_root(tmp_path)


@pytest.mark.parametrize("cell", ["tiny-rmat.burst", "tiny-er.burst",
                                  "tiny-er.sliding"])
def test_the_control_comes_out_not_correct(tiny_root, cell):
    res = harness.run_cell(cell, 21, 1e9, False, device="cpu",
                           root=tiny_root, system=Control, max_batches=4)
    assert res["correct"] is False
    assert res["checks"]["core_mismatch"]["value"] > 0


def _unchanged(orig):
    def apply_batch(self, insert_edges=None, remove_edges=None, **kw):
        from repro_torch.core.engine import BatchStats
        z = torch.zeros((), dtype=torch.int32)
        return BatchStats(*([z] * len(BatchStats._fields)))
    return apply_batch


def _half(orig):
    def apply_batch(self, insert_edges=None, remove_edges=None, **kw):
        half = lambda e: None if e is None else e[: len(e) // 2]  # noqa
        return orig(self, insert_edges=half(insert_edges),
                    remove_edges=half(remove_edges), **kw)
    return apply_batch


def _altered(orig):
    def apply_batch(self, insert_edges=None, remove_edges=None, **kw):
        st = orig(self, insert_edges=insert_edges, remove_edges=remove_edges,
                  **kw)
        self.core[int(torch.argmax(self.core))] += 1
        return st
    return apply_batch


def _insertion_skipped(orig):
    """A mixed batch's last insertion left out."""
    def apply_batch(self, insert_edges=None, remove_edges=None,
                    insert_weights=None):
        if len(insert_edges) and len(remove_edges):
            insert_edges = insert_edges[:-1]
            if insert_weights is not None:
                insert_weights = insert_weights[:-1]
        return orig(self, insert_edges=insert_edges,
                    remove_edges=remove_edges, insert_weights=insert_weights)
    return apply_batch


def _weights_dropped(orig):
    """The inserted edges' weights left out (each stored as 1)."""
    def apply_batch(self, insert_edges=None, remove_edges=None,
                    insert_weights=None):
        return orig(self, insert_edges=insert_edges,
                    remove_edges=remove_edges)
    return apply_batch


@pytest.mark.parametrize("fault, caught_by, cell", [
    (_unchanged, "count_mismatch", "tiny-rmat.burst"),
    (_half, "count_mismatch", "tiny-rmat.burst"),
    (_altered, "core_mismatch", "tiny-rmat.burst"),
    (_insertion_skipped, "count_mismatch", "tiny-er.sliding"),
    (_weights_dropped, "edge_diff", "tiny-w.slide"),
], ids=["state_unchanged", "half_the_batch", "answer_altered",
        "insertion_skipped", "weights_dropped"])
def test_a_broken_timed_path_comes_out_not_correct(tiny_root, monkeypatch,
                                                   fault, caught_by, cell):
    from repro_torch.core.api import CoreMaintainer
    if cell == "tiny-w.slide":
        add_weighted_cell(tiny_root)
    monkeypatch.setattr(CoreMaintainer, "apply_batch",
                        fault(CoreMaintainer.apply_batch))
    res = harness.run_cell(cell, 8, 1e9, False, device="cpu",
                           root=tiny_root, max_batches=4)
    assert res["correct"] is False
    assert res["checks"][caught_by]["value"] > 0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.gpu
def test_tiny_cell_on_the_card_through_the_kernels(tmp_path, card):
    root = tiny.make_root(tmp_path)
    cfg = root / "corebench" / "configs" / "tiny-rmat.json"
    cfg.write_text(cfg.read_text().replace('"torch"', '"cuda"'))
    res = harness.run_cell("tiny-rmat.burst", 5, 1e9, True, device=card,
                           root=root, max_batches=6)
    assert res["correct"] is True
    metrics = res["metrics"]
    assert metrics["launches_per_batch"]["value"] > 0
    assert 0 < metrics["coremaint_kernel_roofline"]["value"] <= 100
    assert 0 <= metrics["device_idle_share"]["value"] < 100
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
