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
