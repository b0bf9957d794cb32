"""The port's stream generators (``repro_torch.graph.stream``) against the
reference's, event for event and bit for bit: ``mixed_stream`` (also on
small dense graphs, where the insert count clamps to the absent edges)
and ``synthetic_stream``. The port keeps the live edge set as a sorted
key array instead of a set of tuples sorted every batch; the draws, and
so the events, are the same."""
import numpy as np
import pytest

pytest.importorskip("jax")
from repro.graph import stream as J  # noqa: E402
from repro.graph.generators import erdos_renyi as j_er  # noqa: E402
from repro.graph.generators import rmat as j_rmat  # noqa: E402

from repro_torch.graph import stream as S  # noqa: E402
from repro_torch.graph.generators import erdos_renyi, rmat  # noqa: E402


def _same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.kind, a.t) == (b.kind, b.t)
        for x, y in ((a.edges, b.edges), (a.removals, b.removals)):
            if y is None:
                assert x is None
                continue
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("n,m", [(300, 1200), (2000, 4000), (12, 60),
                                 (6, 15)])
@pytest.mark.parametrize("batch", [1, 7, 64])
def test_mixed_stream_matches_reference(n, m, batch):
    for seed in range(2):
        _same(list(S.mixed_stream(erdos_renyi(n, m, seed=seed), 6, batch,
                                  seed=seed)),
              list(J.mixed_stream(j_er(n, m, seed=seed), 6, batch,
                                  seed=seed)))


@pytest.mark.parametrize("n,m", [(300, 1200), (2000, 4000)])
@pytest.mark.parametrize("batch", [1, 7, 64])
def test_synthetic_stream_matches_reference(n, m, batch):
    for seed in range(2):
        _same(list(S.synthetic_stream(erdos_renyi(n, m, seed=seed), 10,
                                      batch, seed=seed)),
              list(J.synthetic_stream(j_er(n, m, seed=seed), 10, batch,
                                      seed=seed)))


def test_streams_match_reference_on_rmat():
    g, jg = rmat(12, 30000, seed=1), j_rmat(12, 30000, seed=1)
    _same(list(S.mixed_stream(g, 3, 2000, seed=2)),
          list(J.mixed_stream(jg, 3, 2000, seed=2)))
    _same(list(S.synthetic_stream(g, 6, 500, p_insert=0.3, seed=3)),
          list(J.synthetic_stream(jg, 6, 500, p_insert=0.3, seed=3)))
