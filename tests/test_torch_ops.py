"""The port's kernel API (``repro_torch.kernels.ops``) against the
reference's (``repro.kernels``) on the CPU: the same numpy inputs through
the reference's Pallas kernels in interpret mode (as
``tests/test_kernels.py`` runs them) and through the port's ops, which on
CPU tensors run the kernels' plain versions. Also the port's oracles
(``kernels/ref.py``) against the reference's, ``ell_from_csr`` against
the reference's arrays, and the shared kernel build's source hash.

Tolerances: ``ell_stat`` bit for bit (integer counts and sums, and
integer-valued float32 values whose sums are exact in any order);
``ell_aggregate`` float32 sum rtol/atol 1e-5 (the sum order differs),
max exact, bfloat16 rtol 2e-2 / atol 1e-2 (the Pallas kernel rounds a
bfloat16 sum at every 64-column block); ``fm_interaction`` float32 1e-4
and bfloat16 3e-2 (one rounding of the result, where the reference
rounds its output block); ``flash_attention`` float32 2e-3, bfloat16
3e-2 — all as ``tests/test_kernels.py``."""
import shutil

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.graph.csr import ell_from_csr as ref_ell_from_csr  # noqa: E402
from repro.graph.generators import erdos_renyi as ref_erdos_renyi  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as ref_flash  # noqa: E402
from repro.kernels.fm_interaction import fm_interaction as ref_fm  # noqa: E402
from repro.kernels.segment_ell import ell_aggregate as ref_agg  # noqa: E402
from repro.kernels.segment_ell import ell_stat as ref_stat  # noqa: E402

from repro_torch.graph.csr import ELLGraph, ell_from_csr  # noqa: E402
from repro_torch.graph.generators import erdos_renyi  # noqa: E402
from repro_torch.kernels import build as B  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import segment_ell as SE  # noqa: E402

STAT_OPS = ["count_ge", "count_gt", "sum", "max"]


def _random_ell(n, max_deg, seed, neg=False):
    """``tests/test_kernels.py``'s random ELL matrix; ``neg`` plants ids
    in [-(n + 1), 0), which wrap once over the n + 1 values."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, max_deg + 1, size=n)
    nbrs = np.full((n, max_deg), n, dtype=np.int32)
    for v in range(n):
        nbrs[v, : deg[v]] = rng.integers(0, n, size=deg[v])
    if neg and n:
        hit = rng.random((n, max_deg)) < 0.2
        nbrs[hit] = rng.integers(-(n + 1), 0, size=int(hit.sum()))
    return nbrs


def _stat_both(nbrs, vals, op):
    want = np.asarray(ref_stat(jnp.asarray(nbrs), jnp.asarray(vals),
                               jnp.asarray(vals), op=op, interpret=True))
    t = torch.from_numpy(vals)
    got = ops.ell_stat_op(torch.from_numpy(nbrs), t, t, op)
    return got, want


# -- ell_stat -----------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float32])
@pytest.mark.parametrize("n,max_deg", [(64, 8), (300, 17), (1024, 33), (7, 3)])
@pytest.mark.parametrize("op", STAT_OPS)
def test_ell_stat_matches_pallas(n, max_deg, op, dtype):
    nbrs = _random_ell(n, max_deg, seed=n + max_deg)
    vals = np.random.default_rng(0).integers(0, 50, size=n).astype(dtype)
    got, want = _stat_both(nbrs, vals, op)
    assert got.dtype == torch.from_numpy(vals).dtype
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("op", STAT_OPS)
def test_ell_stat_negative_ids_wrap_once(op):
    """Pin: an id in [-(n + 1), 0) is a neighbour and reads
    ``vals_ext[id + n + 1]`` (so -1 reads the zero sentinel row), in the
    Pallas kernel, the reference's oracle and the port alike."""
    n = 200
    nbrs = _random_ell(n, 12, seed=3, neg=True)
    assert (nbrs < 0).any() and (nbrs == -1).any()
    vals = np.random.default_rng(1).integers(-40, 40, size=n).astype(
        np.int32)
    got, want = _stat_both(nbrs, vals, op)
    np.testing.assert_array_equal(got.numpy(), want)
    oracle = np.asarray(jref.ell_stat_ref(jnp.asarray(nbrs),
                                          jnp.asarray(vals),
                                          jnp.asarray(vals), op=op))
    np.testing.assert_array_equal(got.numpy(), oracle)
    # a row of a single -1 neighbour: count_ge counts it (0 >= self when
    # self <= 0), sum and max read 0
    one = np.full((3, 2), 3, dtype=np.int32)
    one[0, 0] = -1
    got, want = _stat_both(one, np.array([-5, 1, 2], np.int32), op)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,max_deg", [(0, 8), (64, 0), (0, 0)])
@pytest.mark.parametrize("op", ["count_ge", "sum", "max", "count_eq_gt_label"])
def test_ell_stat_zero_grid(n, max_deg, op):
    """n == 0 or max_deg == 0 gives zeros (before any op is evaluated,
    as in the reference)."""
    nbrs = np.full((n, max_deg), n, dtype=np.int32)
    vals = np.zeros((n,), dtype=np.int32)
    got, want = _stat_both(nbrs, vals, op)
    assert got.shape == (n,) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_ell_stat_max_isolated_vertex_is_zero():
    n, max_deg = 96, 8
    nbrs = np.full((n, max_deg), n, dtype=np.int32)
    nbrs[0, :3] = [1, 2, 3]
    vals = np.random.default_rng(0).integers(-50, -1, size=n).astype(
        np.int32)
    got, want = _stat_both(nbrs, vals, "max")
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0] == vals[1:4].max()
    assert not got[1:].any()


def test_ell_stat_unimplemented_and_unknown_ops_raise():
    """``count_eq_gt_label`` is listed by the reference but implemented
    by neither its kernel nor its oracle: both packages raise."""
    nbrs = _random_ell(16, 4, seed=0)
    vals = np.arange(16, dtype=np.int32)
    t = torch.from_numpy(vals)
    for op in ("count_eq_gt_label", "nope"):
        with pytest.raises(ValueError):
            ref_stat(jnp.asarray(nbrs), jnp.asarray(vals), jnp.asarray(vals),
                     op=op, interpret=True)
        with pytest.raises(ValueError):
            ops.ell_stat_op(torch.from_numpy(nbrs), t, t, op)
        with pytest.raises(ValueError):
            ref.ell_stat_ref(torch.from_numpy(nbrs), t, t, op)


def test_ell_stat_sum_wraps_like_the_kernel():
    """Integer sums wrap to vals' dtype as the Pallas kernel's cast of
    its int64 partial does."""
    n = 8
    nbrs = np.tile(np.arange(1, 5, dtype=np.int32), (n, 1))
    vals = np.full(n, 2**30, dtype=np.int32)
    got, want = _stat_both(nbrs, vals, "sum")
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32 and (got == 0).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("op", ["count_ge", "count_gt"])
def test_ell_stat_on_real_graphs(op, seed):
    """On the ELL matrix of a real graph, as the reference's
    ``test_ell_stat_mcd_matches_real_graph``."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(20, 180))
    g = erdos_renyi(n, int(rng.integers(n, 4 * n)), seed=seed + 10)
    nbrs = ell_from_csr(g).nbrs
    core = rng.integers(0, 12, size=n).astype(np.int32)
    got, want = _stat_both(nbrs, core, op)
    np.testing.assert_array_equal(got.numpy(), want)
    by_def = np.array([
        sum(1 for w in g.neighbors(v)
            if (core[w] >= core[v] if op == "count_ge" else core[w] > core[v]))
        for v in range(g.n)], dtype=np.int32)
    np.testing.assert_array_equal(got.numpy(), by_def)


# -- ell_aggregate --------------------------------------------------------

def _agg_tol(dtype, op):
    if op == "max":
        return dict(rtol=0, atol=0)
    if dtype == jnp.bfloat16:
        return dict(rtol=2e-2, atol=1e-2)
    return dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("n,max_deg,f,neg", [(200, 12, 16, False),
                                             (150, 70, 8, True)])
def test_ell_aggregate_matches_pallas(dtype, op, n, max_deg, f, neg):
    nbrs = _random_ell(n, max_deg, seed=5, neg=neg)
    feats_np = np.random.default_rng(1).normal(size=(n, f))
    feats = jnp.asarray(feats_np, dtype=dtype)
    want = np.asarray(ref_agg(jnp.asarray(nbrs), feats, op=op,
                              interpret=True), np.float32)
    oracle = np.asarray(jref.ell_aggregate_ref(jnp.asarray(nbrs), feats,
                                               op=op), np.float32)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    tf = torch.from_numpy(np.array(feats, np.float32)).to(tdt)
    got = ops.ell_aggregate_op(torch.from_numpy(nbrs), tf, op)
    assert got.dtype == tdt and got.shape == (n, f)
    np.testing.assert_allclose(got.float().numpy(), want,
                               **_agg_tol(dtype, op))
    np.testing.assert_allclose(got.float().numpy(), oracle,
                               **_agg_tol(jnp.float32, op))
    np.testing.assert_allclose(ref.ell_aggregate_ref(
        torch.from_numpy(nbrs), tf, op).float().numpy(), oracle,
        **_agg_tol(dtype, op))


@pytest.mark.parametrize("n,max_deg", [(0, 8), (64, 0), (0, 0)])
@pytest.mark.parametrize("op", ["sum", "max"])
def test_ell_aggregate_zero_grid(n, max_deg, op):
    nbrs = torch.full((n, max_deg), n, dtype=torch.int32)
    got = ops.ell_aggregate_op(nbrs, torch.zeros((n, 16)), op)
    want = np.asarray(ref_agg(jnp.asarray(nbrs.numpy()),
                              jnp.zeros((n, 16), jnp.float32), op=op,
                              interpret=True))
    assert got.shape == (n, 16)
    np.testing.assert_array_equal(got.numpy(), want)


def test_ell_aggregate_max_isolated_vertex_is_zero():
    n, max_deg, f = 80, 6, 8
    nbrs = np.full((n, max_deg), n, dtype=np.int32)
    nbrs[0, :2] = [1, 2]
    feats = (-1.0 - np.random.default_rng(1).random((n, f))).astype(
        np.float32)
    got = ops.ell_aggregate_op(torch.from_numpy(nbrs),
                               torch.from_numpy(feats), "max").numpy()
    want = np.asarray(ref_agg(jnp.asarray(nbrs), jnp.asarray(feats),
                              op="max", interpret=True))
    np.testing.assert_array_equal(got, want)
    assert not got[1:].any()
    np.testing.assert_array_equal(got[0], np.maximum(feats[1], feats[2]))


# -- fm_interaction ---------------------------------------------------------

@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("b,f,d", [(64, 39, 10), (1000, 26, 16), (3, 5, 4)])
def test_fm_interaction_matches_pallas(b, f, d, dtype):
    emb = jnp.asarray(np.random.default_rng(b).normal(size=(b, f, d)),
                      dtype=dtype)
    want = np.asarray(ref_fm(emb, block_b=256, interpret=True), np.float32)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    te = torch.from_numpy(np.array(emb, np.float32)).to(tdt)
    got = ops.fm_interaction_op(te)
    assert got.dtype == tdt and got.shape == (b,)
    tol = 1e-4 if dtype == jnp.float32 else 3e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)
    oracle = np.asarray(jref.fm_interaction_ref(emb), np.float32)
    np.testing.assert_allclose(ref.fm_interaction_ref(te).float().numpy(),
                               oracle, rtol=tol, atol=tol)


# -- flash_attention --------------------------------------------------------

def _qkv(b, h, hkv, sq, sk, d, seed, dtype=jnp.float32):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(b, h, sq, d)), rng.normal(size=(b, hkv, sk, d)),
            rng.normal(size=(b, hkv, sk, d))]
    j = [jnp.asarray(a, dtype=dtype) for a in arrs]
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    t = [torch.from_numpy(np.array(a, np.float32)).to(tdt) for a in j]
    return j, t


@pytest.mark.parametrize(
    "b,h,hkv,sq,sk,d", [(2, 4, 4, 256, 256, 64), (1, 8, 2, 512, 512, 64),
                        (2, 4, 1, 128, 128, 128), (1, 4, 2, 128, 256, 64),
                        (1, 4, 1, 256, 128, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_pallas(b, h, hkv, sq, sk, d, causal):
    """GQA and, with Sq != Sk, the top-left causal alignment."""
    j, t = _qkv(b, h, hkv, sq, sk, d, seed=b * 100 + h + sk)
    want = np.asarray(ref_flash(*j, causal=causal, block_q=128, block_k=128,
                                interpret=True))
    got = ops.flash_attention_op(*t, causal=causal, block_q=128,
                                 block_k=128)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)
    if sq == sk:
        oracle = np.asarray(jref.mha_ref(*j, causal=causal))
        np.testing.assert_allclose(got.numpy(), oracle, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_flash_attention_dtypes(dtype):
    j, t = _qkv(1, 2, 2, 256, 256, 64, seed=0, dtype=dtype)
    want = np.asarray(ref_flash(*j, causal=True, block_q=128, block_k=128,
                                interpret=True), np.float32)
    got = ops.flash_attention_op(*t, causal=True, block_q=128, block_k=128)
    assert got.dtype == t[0].dtype
    tol = 3e-2 if dtype == jnp.bfloat16 else 2e-3
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("scale", [0.3, 0.0, -0.125])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_takes_any_scale(scale, causal):
    """An explicit scale, zero and negative too, as the Pallas kernel
    applies it (to q, before the mask and the max)."""
    j, t = _qkv(1, 4, 2, 128, 128, 64, seed=11)
    want = np.asarray(ref_flash(*j, causal=causal, scale=scale, block_q=128,
                                block_k=128, interpret=True))
    got = FA.flash_attention(*t, causal=causal, scale=scale, block_q=128,
                             block_k=128)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_mha_ref_matches_reference_oracle(dtype, causal):
    """The port's ``mha_ref`` keeps the reference's scale in q's dtype:
    bit for bit in float32, one bfloat16 rounding apart in bfloat16."""
    j, t = _qkv(2, 4, 2, 64, 64, 64, seed=7, dtype=dtype)
    want = np.asarray(jref.mha_ref(*j, causal=causal), np.float32)
    got = ref.mha_ref(*t, causal=causal).float().numpy()
    tol = 1e-2 if dtype == jnp.bfloat16 else 1e-6
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("shapes,blocks", [
    (((1, 6, 128, 64), (1, 4, 128, 64)), (128, 128)),   # H % Hkv
    (((1, 4, 384, 64), (1, 2, 384, 64)), (256, 128)),   # Sq % block_q
    (((1, 4, 128, 64), (1, 2, 384, 64)), (128, 256)),   # Sk % block_k
])
def test_flash_attention_rejects_what_the_reference_rejects(shapes, blocks):
    qs, ks = shapes
    args = [np.zeros(qs, np.float32), np.zeros(ks, np.float32),
            np.zeros(ks, np.float32)]
    with pytest.raises(AssertionError):
        ref_flash(*map(jnp.asarray, args), block_q=blocks[0],
                  block_k=blocks[1], interpret=True)
    with pytest.raises(ValueError):
        ops.flash_attention_op(*map(torch.from_numpy, args),
                               block_q=blocks[0], block_k=blocks[1])


# -- ell_from_csr -----------------------------------------------------------

@pytest.mark.parametrize("n,m,seed", [(200, 800, 1), (1000, 2500, 2),
                                      (50, 0, 3)])
def test_ell_from_csr_matches_reference(n, m, seed):
    g = erdos_renyi(n, m, seed=seed)
    rg = ref_erdos_renyi(n, m, seed=seed)
    got, want = ell_from_csr(g), ref_ell_from_csr(rg)
    assert isinstance(got, ELLGraph)
    assert (got.n, got.max_deg) == (want.n, want.max_deg)
    for a, b in ((got.nbrs, want.nbrs), (got.deg, want.deg)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    wide = ell_from_csr(g, max_deg=want.max_deg + 3)
    np.testing.assert_array_equal(
        wide.nbrs, ref_ell_from_csr(rg, max_deg=want.max_deg + 3).nbrs)


def test_ell_from_csr_rejects_a_short_max_deg():
    g = erdos_renyi(100, 400, seed=0)
    md = int(g.degrees().max())
    with pytest.raises(ValueError, match="max degree"):
        ref_ell_from_csr(ref_erdos_renyi(100, 400, seed=0), max_deg=md - 1)
    with pytest.raises(ValueError, match="max degree"):
        ell_from_csr(g, max_deg=md - 1)


# -- the shared kernel build ------------------------------------------------

def test_library_name_covers_every_cuda_source(tmp_path):
    """One library from every ``csrc/*.cu``: editing any source, or
    adding one, renames it, so a stale build is never loaded."""
    srcs = B.sources()
    assert {p.name for p in srcs} >= {
        "coremaint.cu", "segment_ell.cu", "fm_interaction.cu",
        "flash_attention.cu"}
    copies = []
    for p in srcs:
        copies.append(tmp_path / p.name)
        shutil.copy(p, copies[-1])
    base = B.library_name(copies)
    assert base == B.library_name(srcs)
    names = {base}
    for c in copies:
        text = c.read_bytes()
        c.write_bytes(text + b"\n// edited\n")
        names.add(B.library_name(copies))
        c.write_bytes(text)
    extra = tmp_path / "zz_new.cu"
    extra.write_text("// a new kernel\n")
    names.add(B.library_name(copies + [extra]))
    assert len(names) == len(copies) + 2
    assert B.library_name(copies) == base


PTXAS_REPORT = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN1a18flash_wgmma_kernelILi128EEEv' for 'sm_90a'
ptxas info    : Function properties for _ZN1a18flash_wgmma_kernelILi128EEEv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN1a17flash_ffma_kernelILi64EEEv' for 'sm_90a'
ptxas info    : Function properties for _ZN1a17flash_ffma_kernelILi64EEEv
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN1a11stat_kernelILi4EEEv' for 'sm_90a'
ptxas info    : Function properties for _ZN1a11stat_kernelILi4EEEv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 24 registers, used 0 barriers
"""


@pytest.mark.parametrize("pattern,want", [
    ("flash_", {"_ZN1a18flash_wgmma_kernelILi128EEEv": (168, 0, 0),
                "_ZN1a17flash_ffma_kernelILi64EEEv": (255, 12, 16)}),
    ("flash_ffma_kernelILi64E", {"_ZN1a17flash_ffma_kernelILi64EEEv":
                                 (255, 12, 16)}),
    ("", {"_ZN1a18flash_wgmma_kernelILi128EEEv": (168, 0, 0),
          "_ZN1a17flash_ffma_kernelILi64EEEv": (255, 12, 16),
          "_ZN1a11stat_kernelILi4EEEv": (24, 0, 0)})])
def test_ptxas_report_is_read_per_kernel(pattern, want):
    """The build keeps ``ptxas -v``'s report; each kernel's registers
    and spill bytes are read from its own section."""
    got = B.parse_ptxas(PTXAS_REPORT, pattern)
    assert {k: (u["registers"], u["spill_stores"], u["spill_loads"])
            for k, u in got.items()} == want


def test_attention_inputs_are_realigned_for_the_kernel():
    """TMA and cp.async read 16-byte aligned rows: a view whose offset
    breaks that is copied, an aligned tensor is passed as it is."""
    base = torch.arange(4 * 64 + 1, dtype=torch.float32)
    off = base[1:].view(1, 1, 4, 64)
    assert off.data_ptr() % 16 != 0
    fixed = FA._aligned(off)
    assert fixed.data_ptr() % 16 == 0 and torch.equal(fixed, off)
    ok = torch.ones((1, 1, 4, 64))
    assert FA._aligned(ok) is ok


def test_plain_versions_run_on_cpu_without_a_build():
    """The CPU path never builds or loads the library."""
    assert B._lib is None
    nbrs = torch.from_numpy(_random_ell(32, 4, seed=1))
    vals = torch.arange(32, dtype=torch.int32)
    ops.ell_stat_op(nbrs, vals, vals)
    ops.ell_aggregate_op(nbrs, torch.ones((32, 3)))
    ops.fm_interaction_op(torch.ones((4, 3, 2)))
    ops.flash_attention_op(*[torch.ones((1, 1, 8, 64))] * 3)
    assert B._lib is None and not any(SE.LAUNCHES.values())
