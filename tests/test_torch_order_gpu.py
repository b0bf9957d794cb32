"""Label placement's level kernels on the card (``kernels/order.py``,
``csrc/order.cu``): ``core/order.py`` ``place_block`` on CUDA tensors
against ``place_block_plain`` on the same tensors and against
``place_block`` on a CPU copy, bit for bit, on the cases
``tests/test_torch_order.py`` holds the CPU path to the reference on
(tied labels, ``round_key`` set and unset, every vertex moving, empty
levels, ``n_levels = n + 2``), on levels at and beyond the shared table
(the spill path, and its tally), on a state the size of the benchmark's
RMAT cell (n = 2,097,152, 771 levels), and on levels outside
``[0, n_levels)``, which the kernels drop.

Every test carries the ``gpu`` marker and skips without a CUDA device;
the module imports neither jax nor the reference package:
``python -m pytest -q -m gpu tests/test_torch_order_gpu.py``."""
import numpy as np
import pytest
import torch

from repro_torch.core import order as torder
from repro_torch.kernels import order as korder

pytestmark = pytest.mark.gpu


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run on the card only")
    return torch.device("cuda")


def _state(n, seed, n_core=5, tie_labels=True, p_move=0.4):
    """Random (core, label, moving, round_key), as tests/test_torch_order.py
    draws them; with ``tie_labels`` the labels come from a small set."""
    rng = np.random.default_rng(seed)
    core = rng.integers(0, n_core, size=n).astype(np.int32)
    if tie_labels:
        label = rng.integers(-4, 4, size=n).astype(np.int64) << 20
    else:
        label = (rng.permutation(n).astype(np.int64) - n // 2) << 20
    moving = rng.random(n) < p_move
    round_key = rng.integers(0, 3, size=n).astype(np.int32)
    return core, label, moving, round_key


def _held(core, label, moving, rk, at_head, n_levels):
    """``place_block`` on the card, held to the plain path on the card and
    on the CPU; returns the card's labels."""
    dev = _card()
    cpu = [torch.from_numpy(x) for x in (core, label, moving)]
    cpu_rk = None if rk is None else torch.from_numpy(rk)
    card = [x.to(dev) for x in cpu]
    card_rk = None if rk is None else cpu_rk.to(dev)
    before = korder.LAUNCHES["place_levels"]
    got = torder.place_block(*card, at_head, n_levels, round_key=card_rk)
    assert korder.LAUNCHES["place_levels"] == before + 3
    plain = torder.place_block_plain(*card, at_head, n_levels,
                                     round_key=card_rk)
    want = torder.place_block(*cpu, at_head, n_levels, round_key=cpu_rk)
    assert got.dtype == torch.int64 and got.device.type == "cuda"
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    np.testing.assert_array_equal(plain.cpu().numpy(), want.numpy())
    return got


@pytest.mark.parametrize("at_head", [True, False])
@pytest.mark.parametrize("with_round_key", [False, True])
@pytest.mark.parametrize("seed,ties", [(0, True), (1, True), (2, False)])
def test_place_block_kernel_matches_plain(at_head, with_round_key, seed,
                                          ties):
    n = 257
    core, label, moving, rk = _state(n, seed, tie_labels=ties)
    _held(core, label, moving, rk if with_round_key else None, at_head,
          n + 2)


@pytest.mark.parametrize("at_head", [True, False])
def test_place_block_kernel_every_vertex_moving(at_head):
    core, label, _, _ = _state(64, 7)
    _held(core, label, np.ones(64, dtype=bool), None, at_head, 66)


@pytest.mark.parametrize("at_head", [True, False])
def test_place_block_kernel_empty_levels(at_head):
    """Levels with no vertex below, between and above the held ones, and
    levels whose members all move."""
    core, label, moving, rk = _state(3000, 11, n_core=40)
    core = np.where(core % 3 == 1, core + 1, core).astype(np.int32)
    moving[core == 6] = True
    _held(core, label, moving, rk, at_head, 50)


@pytest.mark.parametrize("n,seed", [(1, 0), (31, 1), (33, 2),
                                    (200_001, 3)])
def test_place_block_kernel_ragged_sizes(n, seed):
    core, label, moving, rk = _state(n, seed, n_core=min(9, n + 2))
    for at_head in (True, False):
        _held(core, label, moving, rk, at_head, n + 2)


@pytest.mark.parametrize("at_head", [True, False])
def test_place_block_kernel_spill_path(at_head):
    """Levels at and beyond the shared table's ``L`` take the spill path:
    the labels stay those of the plain path, and the tally counts each
    such vertex once."""
    _card()
    n = 40_000
    n_levels = n + 2
    L = korder.shared_levels(n_levels)
    assert 0 < L < n_levels
    rng = np.random.default_rng(5)
    core, label, moving, rk = _state(n, 5, n_core=L + 3000,
                                     tie_labels=False)
    near = rng.random(n) < 0.3  # many vertices right at the boundary
    core[near] = rng.integers(L - 3, L + 3, size=int(near.sum()))
    korder.reset_spill_count()
    _held(core, label, moving, rk, at_head, n_levels)
    assert korder.spill_count() == int((core >= L).sum())
    korder.reset_spill_count()
    assert korder.spill_count() == 0


def test_place_block_kernel_no_spill_below_the_table():
    _card()
    core, label, moving, rk = _state(5000, 6, n_core=771)
    korder.reset_spill_count()
    _held(core, label, moving, rk, True, 5002)
    assert korder.spill_count() == 0


@pytest.mark.parametrize("p_move", [0.002, 0.3])
def test_place_block_kernel_rmat_sized(p_move):
    """n = 2,097,152 vertices over 771 levels, most of them low (a
    power-law core distribution), unique gap-spaced labels, as the
    benchmark's ``rmat-s21`` cell holds them."""
    _card()
    n, kmax = 2_097_152, 770
    rng = np.random.default_rng(21)
    core = np.minimum(rng.zipf(1.6, size=n) - 1, kmax).astype(np.int32)
    core[:kmax + 1] = np.arange(kmax + 1)  # every level held
    label = (rng.permutation(n).astype(np.int64) - n // 2) << 20
    moving = rng.random(n) < p_move
    rk = rng.integers(0, 60, size=n).astype(np.int32)
    korder.reset_spill_count()
    for at_head, key in ((True, None), (False, rk)):
        _held(core, label, moving, key, at_head, n + 2)
    assert korder.spill_count() == 0


def test_place_block_kernel_drops_out_of_range_levels():
    """A non-moving vertex on a level outside ``[0, n_levels)`` is dropped
    from every level's reduction (the plain path raises on it): the
    others' labels are those of the plain path without it, and it keeps
    its own."""
    dev = _card()
    core, label, moving, rk = _state(500, 9, n_core=6)
    moving[:4] = False
    bad = core.copy()
    bad[:4] = [-1, 8, 9, 1 << 30]
    label[:4] = [-(1 << 61), 1 << 61, -(1 << 61), 1 << 61]  # would win
    want = torder.place_block(*(torch.from_numpy(x[4:])
                                for x in (core, label, moving)),
                              True, 8, round_key=torch.from_numpy(rk[4:]))
    got = torder.place_block(*(torch.from_numpy(x).to(dev)
                               for x in (bad, label, moving)),
                             True, 8, round_key=torch.from_numpy(rk).to(dev))
    got = got.cpu().numpy()
    np.testing.assert_array_equal(got[4:], want.numpy())
    np.testing.assert_array_equal(got[:4], label[:4])


def test_place_levels_refuses_bad_inputs():
    dev = _card()
    core = torch.zeros(8, dtype=torch.int32, device=dev)
    label = torch.zeros(8, dtype=torch.int64, device=dev)
    moving = torch.zeros(8, dtype=torch.bool, device=dev)
    rank = torch.arange(8, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match="core"):
        korder.place_levels(core.long(), label, moving, rank, True, 10)
    with pytest.raises(ValueError, match="contiguous"):
        korder.place_levels(core, torch.zeros(16, dtype=torch.int64,
                                              device=dev)[::2],
                            moving, rank, True, 10)
    with pytest.raises(ValueError, match="n_levels"):
        korder.place_levels(core, label, moving, rank, True, 0)
