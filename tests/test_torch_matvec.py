"""repro_torch's plain K5 (matvec), reached through
`repro_torch.kernels.ops` on CPU tensors, against the JAX package's
Pallas kernel `repro.kernels.matvec.matvec_pallas` in interpret mode, on
the same numpy inputs; and K5's rounding bound `ref.matvec_bound`, which
the plain version meets and planted faults break.

Tolerances: f32 rtol 1e-5, f64 rtol 1e-12 (the frameworks sum ``a @ x``
in other orders; the Pallas kernel accumulates one 512-column tile after
another), with the same multiple of the largest row sum of |a| as atol
for entries that cancel.  Shapes cover a rectangular block (a rank's
rows, M != N), N not a multiple of the Pallas tile (its zero-padding
branch), a vector x, and k = 1, 3, 32, 64 columns.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels.matvec import matvec_pallas

from repro_torch.kernels import matvec as k5
from repro_torch.kernels import ops, ref

RTOL = {np.float32: 1e-5, np.float64: 1e-12}
# (M, N): square; a rank's block of a 1100-row matrix (N % 512 != 0);
# fewer rows than one Pallas row tile; one element
SHAPES = [(96, 96), (275, 1100), (40, 700), (1, 1)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These operands are small: intra-op threads gain nothing and would
    crowd the other test processes sharing the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(m, n, k, dt, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, n)).astype(dt)
    x = rng.standard_normal((n,) if k is None else (n, k)).astype(dt)
    return a, x


@pytest.mark.parametrize("k", [None, 1, 3, 32, 64])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_matvec_matches_pallas(dt, shape, k):
    a, x = _inputs(*shape, k, dt, seed=shape[0] + (k or 0))
    got = ops.matvec(torch.from_numpy(a), torch.from_numpy(x))
    want = np.asarray(matvec_pallas(jnp.asarray(a), jnp.asarray(x),
                                    interpret=True))
    assert got.dtype == torch.from_numpy(a).dtype
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL[dt],
                               atol=RTOL[dt] * np.abs(a).sum(1).max())


def test_matvec_casts_x_to_the_matrix_dtype():
    a, x = _inputs(30, 50, 4, np.float64, seed=1)
    got = ops.matvec(torch.from_numpy(a), torch.from_numpy(x).float())
    assert got.dtype == torch.float64
    want = a @ x.astype(np.float32).astype(np.float64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)


def _rel_to_bound(out, a, x):
    """max |out - exact| / matvec_bound, the exact product in f64 (for an
    f64 input itself one evaluation, so the bound is doubled)."""
    exact = a.double() @ x.double()
    factor = 2.0 if a.dtype == torch.float64 else 1.0
    bound = factor * ref.matvec_bound(a, x).double()
    return ((out.double() - exact).abs()
            / bound.clamp_min(torch.finfo(torch.float64).tiny)).max().item()


@pytest.mark.parametrize("k", [1, 32])
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_matvec_bound_holds_and_planted_faults_break_it(dt, k):
    a, x = (torch.from_numpy(t).to(dt)
            for t in _inputs(256, 512, k, np.float64, seed=k))
    assert _rel_to_bound(ref.matvec_ref(a, x), a, x) <= 1.0
    # a skipped 32-column chunk of a, and a zeroed block of output rows
    skipped = a.clone()
    skipped[:, 96:128] = 0
    zeroed = ref.matvec_ref(a, x)
    zeroed[64:96] = 0
    assert _rel_to_bound(ref.matvec_ref(skipped, x), a, x) > 10.0
    assert _rel_to_bound(zeroed, a, x) > 10.0


def test_matvec_wrapper_takes_only_cuda_tensors():
    a, x = (torch.from_numpy(t) for t in _inputs(8, 8, 2, np.float32, 0))
    ops.reset_launch_counts()
    ops.matvec(a, x)
    assert ops.launch_counts()["matvec"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        k5.matvec(a, x)
    with pytest.raises(ValueError, match="matvec"):
        k5.matvec(a, x[:5])
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops.matvec(a.to("meta"), x.to("meta"))


# The launch plan of K5 (`matvec.plan`): pure Python, held here on the CPU
# because the C entry obeys it.  Shapes: the sharded estimators' blocks at
# P = 1 and 4, the card tests' ragged and split shapes, a slab wider than
# one column block, a single row.
PLAN_SHAPES = [(16384, 16384, 32), (4096, 16384, 32), (16384, 16384, 64),
               (4096, 16384, 64), (256, 16384, 32), (129, 1001, 32),
               (256, 1025, 33), (100, 300, 65), (1, 4097, 5), (300, 70, 200)]
H100_SMS = 132


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_matvec_plan_ranges_cover_the_reduction_axis(shape, dt):
    """The S ranges cover [0, n) exactly once, in order, each starting on
    a multiple of 32 and each but the last a multiple of 32 (and of a
    pipeline stage) long; the column blocks cover k with one block width
    of 16, 32 or 64."""
    m, n, k = shape
    p = k5.plan(m, n, k, dt, H100_SMS)
    # block z of the grid sums columns [z split_len, (z + 1) split_len) of n
    ranges = [(z * p.split_len, min(n, (z + 1) * p.split_len))
              for z in range(p.splits)]
    assert len(ranges) == p.splits >= 1
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(stop == start for (_, stop), (start, _) in zip(ranges,
                                                                ranges[1:]))
    assert all(stop > start for start, stop in ranges)
    assert all(start % 32 == 0 for start, _ in ranges)
    assert all((stop - start) % 32 == 0 for start, stop in ranges[:-1])
    assert p.chunk == k5.CHUNK_BYTES // dt.itemsize
    assert p.split_len % 32 == 0 and p.split_len % p.chunk == 0
    assert p.bn in (16, 32, 64) and p.bn >= min(k, 64) and (
        p.bn == 16 or p.bn // 2 < k)
    assert p.col_blocks == -(-k // p.bn) and p.bm == k5.BLOCK_ROWS


def test_matvec_plan_fills_two_waves_on_the_rank_block():
    """One rank's (4096, 16384) block at k = 32 on an H100: its row
    blocks, split into equal ranges, make as close to two blocks on each
    of the 132 SMs as equal ranges allow (at least 95 % of that), none
    waiting for a third; the full (16384, 16384) block splits too."""
    for dt in (torch.float32, torch.float64):
        p = k5.plan(4096, 16384, 32, dt, H100_SMS)
        rows = 4096 // p.bm
        blocks = rows * p.col_blocks * p.splits
        assert p.splits > 1 and p.workspace == p.splits * 4096 * 32
        assert 0.95 * 2 * H100_SMS <= blocks <= k5.BLOCKS_PER_SM * H100_SMS
        assert rows * (p.splits + 1) > k5.BLOCKS_PER_SM * H100_SMS
        assert k5.plan(16384, 16384, 32, dt, H100_SMS).splits > 1
    # more SMs, more splits; a grid that fills the card alone is not split
    assert k5.plan(4096, 16384, 32, torch.float32, 4 * H100_SMS).splits > \
        k5.plan(4096, 16384, 32, torch.float32, H100_SMS).splits
    assert k5.plan(65536, 16384, 32, torch.float64, H100_SMS).splits == 1


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("shape", [(16384, 16384), (4096, 16384), (1, 1),
                                   (37, 1001)])
def test_matvec_plan_never_splits_the_gemv_path(shape, k):
    m, n = shape
    for dt in (torch.float32, torch.float64):
        p = k5.plan(m, n, k, dt, H100_SMS)
        assert (p.splits, p.workspace, p.bm, p.bn) == (1, 0, k5.GEMV_ROWS, k)


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", PLAN_SHAPES + [(0, 64, 8), (8, 0, 8)])
def test_matvec_plan_workspace_is_s_m_k(shape, dt):
    """The partials buffer holds one (m, k) slice per range when the axis
    is split, and is not allocated when it is not."""
    m, n, k = shape
    p = k5.plan(m, n, k, dt, H100_SMS)
    assert p.workspace == (p.splits * m * k if p.splits > 1 else 0)
    assert p.splits == max(1, -(-n // p.split_len))


# K6 and K7 (`fused_est.cheb_step`, `fused_est.cg_step`) compute their
# product on K5's tile with K5's cut: the dense estimator cell (n = 16384,
# k = 32: split in two on 132 SMs), wider slabs (one and two column blocks
# of 64), n not a multiple of the 128-row block, and the warp-per-row path
# (k <= 4).
K6_SHAPES = [(16384, 32), (16384, 64), (16384, 65), (1000, 33), (4097, 5),
             (129, 16), (300, 200), (37, 4), (1, 1)]


def _entry_args(monkeypatch, call):
    """Run ``call`` with the C entry, the CUDA checks and the SM count
    replaced; returns the arguments the entry was given and the tensors
    `torch.empty` made, by data pointer."""
    import contextlib
    from repro_torch.kernels import _build

    seen, allocated = {}, {}
    real_empty = torch.empty

    def empty(*args, **kw):
        t = real_empty(*args, **kw)
        allocated[t.data_ptr()] = t
        return t

    def entry(*args):
        seen["args"] = args
        return 0

    monkeypatch.setattr(_build, "require_cuda", lambda *args: None)
    monkeypatch.setattr(_build, "function", lambda name: entry)
    monkeypatch.setattr(_build, "stream", lambda t: 0)
    monkeypatch.setattr(k5, "_sm_count", lambda index: H100_SMS)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch, "empty", empty)
    call(real_empty)
    return seen["args"], allocated


def _check_cut(args, allocated, n, k, dt):
    """The tail of a K6 / K7 entry's arguments is `matvec.plan`'s cut for
    (n, n, k), after a (ceil(n / bm), k) partials buffer and the (S, n, k)
    slices exactly when the plan splits (else null)."""
    mv = k5.plan(n, n, k, dt, H100_SMS)
    assert mv.bm == (k5.GEMV_ROWS if k <= 4 else k5.BLOCK_ROWS)
    if (n, k) == (16384, 32):   # the dense estimator cell splits in two
        assert (mv.splits, -(-n // mv.bm)) == (2, 128)
    (*_, partials, slices, n_, k_, bm, bn, chunk, splits, split_len,
     stream) = args
    assert (n_, k_, bm, bn, chunk, splits, split_len) == (
        n, k, mv.bm, mv.bn, mv.chunk, mv.splits, mv.split_len)
    assert allocated[partials].shape == (-(-n // mv.bm), k)
    if mv.splits > 1:
        assert allocated[slices].numel() == mv.splits * n * k
    else:
        assert slices is None


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,k", K6_SHAPES)
def test_cheb_step_cut_is_the_matvec_plan(n, k, dt, monkeypatch):
    """The K6 wrapper hands its C entry `matvec.plan`'s cut for (n, n, k),
    a partials buffer of one row of k per block of ``bm`` rows and, where
    the reduction axis is split, an (S, n, k) slices buffer (else null)."""
    from repro_torch.kernels import fused_est

    def call(empty):
        a, w, one = empty((n, n), dtype=dt), empty((n, k), dtype=dt), \
            empty((1,), dtype=dt)
        fused_est.cheb_step(a, w, w, w, one, one)
    _check_cut(*_entry_args(monkeypatch, call), n, k, dt)


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,k", K6_SHAPES)
def test_cg_step_cut_is_the_matvec_plan(n, k, dt, monkeypatch):
    """The K7 wrapper hands its C entry the same cut as K6's: `matvec.plan`
    for (n, n, k), one partial-dot row per block of ``bm`` rows, and the
    (S, n, k) slices exactly when the plan splits (else null)."""
    from repro_torch.kernels import fused_est

    def call(empty):
        a, w, rz = empty((n, n), dtype=dt), empty((n, k), dtype=dt), \
            empty((k,), dtype=dt)
        fused_est.cg_step(a, w, w, w, rz)
    _check_cut(*_entry_args(monkeypatch, call), n, k, dt)
