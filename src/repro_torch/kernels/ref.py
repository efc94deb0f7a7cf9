"""Plain PyTorch versions of the kernels K1-K8.

Each function is the numerical ground truth for one hand-written CUDA
kernel (``kernels/csrc``): the CPU runs these, and ``chip_smoke.py`` holds
every kernel against its plain version on the card, on the same inputs.
They repeat the kernels' arithmetic exactly -- every product is
materialized before it is added or subtracted, so no multiply-add is
ever contracted into an FMA -- which is what makes K1, K3, K4 and K8
bitwise comparable with them.  K5, K6 and K7 sum ``A @ w`` (and K6/K7
their column dots) in another order than the kernels, so they agree to a
tolerance: `matvec_bound`, `cheb_step_bound`, `cg_step_bound`.

K1-K4 also take a stack with a leading batch axis, matrix by matrix the
same arithmetic (the port of what `vmap` does to the JAX package's
kernels), so each matrix of a stack equals the single-matrix result bit
for bit.

Counterparts: `repro.kernels.ref` (K1-K3, K5-K8) and `repro.core.engine
.panel_factor` (K4).
"""
from __future__ import annotations

import torch

__all__ = ["rank1_update_ref", "panel_update_ref", "fused_step_ref",
           "panel_factor_ref", "matvec_ref", "cheb_step_ref", "cg_step_ref",
           "stencil_mv_ref", "matvec_bound", "cheb_step_bound",
           "cg_step_bound", "panel_update_bound",
           "ERROR_LAMBDA", "accumulator_dtype", "guarded_pivot", "nan_sign",
           "swap_positions", "swap_positions_batched"]


def accumulator_dtype(dtype: torch.dtype) -> torch.dtype:
    """The GEMM accumulator of a buffer dtype: f64 for f64, else f32."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def guarded_pivot(p: torch.Tensor) -> torch.Tensor:
    """A division-safe pivot: 1 where ``p == 0`` (caller masks the result)."""
    return torch.where(p == 0, torch.ones_like(p), p)


def nan_sign(x: torch.Tensor) -> torch.Tensor:
    """``torch.sign``, but NaN for NaN, as ``jnp.sign``: a NaN pivot gives
    a NaN sign, never the 0 of a singular matrix."""
    return torch.where(torch.isnan(x), x, torch.sign(x))


def swap_positions(x: torch.Tensor, dim: int, l: torch.Tensor,
                   last: int) -> None:
    """In place: swap index ``l`` (a (1,) int64 tensor, so the host never
    reads it) with index ``last`` along ``dim``."""
    at_l = x.index_select(dim, l)
    at_last = x.narrow(dim, last, 1).clone()
    x.index_copy_(dim, l, at_last)
    x.narrow(dim, last, 1).copy_(at_l)


def swap_positions_batched(x: torch.Tensor, dim: int, l: torch.Tensor,
                           last: int) -> None:
    """In place, per matrix of a stack: swap index ``l[b]`` with index
    ``last`` along ``dim`` (>= 1) of ``x[b]``; ``l`` is a (B,) int64
    tensor, so the host never reads it."""
    shape = list(x.shape)
    shape[dim] = 1
    idx = l.view([-1] + [1] * (x.dim() - 1)).expand(shape)
    at_l = x.gather(dim, idx)
    at_last = x.narrow(dim, last, 1).clone()
    x.scatter_(dim, idx, at_last)
    x.narrow(dim, last, 1).copy_(at_l)


def rank1_update_ref(a: torch.Tensor, pc: torch.Tensor,
                     pr: torch.Tensor) -> torch.Tensor:
    """a (M, N) - outer(pc, pr), the product rounded in the operand dtype;
    for a stack a (B, M, N), pc (B, M), pr (B, N) per matrix.

    With bf16 operands the product is a bf16 product, widened to
    ``a.dtype`` before the subtraction.  (``torch.outer`` is this
    broadcast product.)
    """
    return (a - pc[..., :, None] * pr[..., None, :]).to(a.dtype)


def panel_update_ref(a: torch.Tensor, c: torch.Tensor,
                     r: torch.Tensor) -> torch.Tensor:
    """a (M, N) - c (M, K) @ r (K, N), accumulated in f32 (f64 for f64);
    a stack (B, M, N) matrix by matrix.

    Follows the Pallas kernel (`repro.kernels.panel_update`), not the
    jnp oracle: bf16 operands are widened before the product, so the
    contraction never rounds to bf16.  A stack takes one product per
    matrix, not a batched one: PyTorch's batched product of small shapes
    sums in another order than its single one (a CPU build measured),
    and each matrix must equal the single-matrix result bit for bit.
    """
    if a.dim() == 3:
        return torch.stack([panel_update_ref(a[i], c[i], r[i])
                            for i in range(a.shape[0])])
    acc = accumulator_dtype(a.dtype)
    return a - (c.to(acc) @ r.to(acc)).to(a.dtype)


def panel_update_bound(a: torch.Tensor, c: torch.Tensor, r: torch.Tensor,
                       plain: torch.Tensor) -> torch.Tensor:
    """Elementwise bound on how far two evaluations of ``a - c @ r`` whose
    products are summed in different orders may differ:
    ``2 K eps_acc (|c| @ |r|) + eps (|plain|)``, the product's rounding in
    either order, then one rounding of the subtract.  ``plain`` is
    `panel_update_ref`'s result."""
    acc = accumulator_dtype(a.dtype)
    return (2 * c.shape[-1] * torch.finfo(acc).eps
            * (c.to(acc).abs() @ r.to(acc).abs())
            + torch.finfo(a.dtype).eps * plain.abs())


def fused_step_ref(a: torch.Tensor, l, last: int, pc: torch.Tensor,
                   pr: torch.Tensor, col_l: torch.Tensor,
                   col_last: torch.Tensor) -> torch.Tensor:
    """Column swap (l <-> last) and rank-1 update as one select pass.

    ``l`` may be a 0-d device tensor; for a stack a (B, M, N) it is (B,),
    one pivot column per matrix, and the other operands carry the batch
    axis.  Bitwise equal to the scatter swap followed by
    `rank1_update_ref`: the swap moves data, the multiply-subtract is the
    same arithmetic.
    """
    cols = torch.arange(a.shape[-1], device=a.device)
    if a.dim() == 3:
        l = l.view(-1, 1, 1)
    sw = torch.where(cols == l, col_last[..., :, None],
                     torch.where(cols == last, col_l[..., :, None], a))
    return sw - (pc[..., :, None] * pr[..., None, :]).to(a.dtype)


def panel_factor_ref(panel: torch.Tensor, m0: int, r_pos: int = 0):
    """Factorize a (K, N) condensation panel: K sequential steps.

    Live columns before the panel are ``[0, m0)``; ``r_pos`` counts the
    live rows above the panel (sign parity only).  Returns
    ``(R, ls, sign, logdet)``: the normalized pivot rows in the final
    swapped coordinates, the (K,) int64 pivot column chosen at each step
    (in that step's coordinates), and the panel's contribution to the
    sign and log|det| as 0-d tensors.  A (B, K, N) stack of panels gives
    (B, K, N), (B, K), (B,) and (B,), each panel pivoting on its own (one
    panel runs as a stack of one: the same arithmetic).  The input is not
    modified.
    """
    if panel.dim() == 2:
        R, ls, sign, logdet = panel_factor_ref(panel[None], m0, r_pos)
        return R[0], ls[0], sign[0], logdet[0]
    b, k_rows, n = panel.shape
    dt = panel.dtype
    buf = panel.clone()
    rows = torch.arange(k_rows, device=panel.device)
    ls = torch.zeros((b, k_rows), dtype=torch.int64, device=panel.device)
    one = torch.ones((), dtype=dt, device=panel.device)
    sign = torch.ones(b, dtype=dt, device=panel.device)
    logdet = torch.zeros(b, dtype=dt, device=panel.device)
    for k in range(k_rows):
        m = m0 - k
        last = m - 1
        l = buf[:, k, :m].abs().argmax(-1)                       # (B,)
        pv = buf[:, k].gather(1, l[:, None])[:, 0]               # (B,)
        swap_positions_batched(buf, 2, l, last)
        row = buf[:, k]
        pr = torch.where(pv[:, None] == 0, torch.zeros_like(row),
                         row / guarded_pivot(pv)[:, None])
        pr[:, last] = torch.where(pv == 0, pr[:, last], one)
        buf[:, k] = pr
        pc = torch.where(rows <= k, 0.0, buf[:, :, last]).to(dt)
        buf = buf - pc[:, :, None] * pr[:, None, :]
        ls[:, k] = l
        parity = 1.0 if (r_pos + m - 1) % 2 == 0 else -1.0
        swap_sign = torch.where(l == last, 1.0, -1.0).to(dt)
        sign = sign * nan_sign(pv) * swap_sign * parity
        logdet = logdet + torch.log(torch.abs(pv))
    return buf, ls, sign, logdet


def matvec_ref(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``a (M, N) @ x (N,) or (N, K)``, ``x`` cast to ``a``'s dtype."""
    return a @ x.to(a.dtype)


def cheb_step_ref(a: torch.Tensor, w: torch.Tensor, w_prev: torch.Tensor,
                  v: torch.Tensor, center, width):
    """One Chebyshev three-term step -> ``(w_next, dots)``.

    ``w_next = 2 (2 a w - center w) / width - w_prev`` and ``dots =
    (v * w_next).sum(-2)``, op for op the loop body of
    `estimators.chebyshev.logdet_chebyshev`; ``center`` and ``width`` may
    be device tensors (broadcast against the (n, k) slab).
    """
    mv = (2.0 * (a @ w) - center * w) / width
    w_next = 2.0 * mv - w_prev
    return w_next, (v * w_next).sum(-2)


def cg_step_ref(a: torch.Tensor, p: torch.Tensor, x: torch.Tensor,
                r: torch.Tensor, rz: torch.Tensor):
    """One CG matvec-and-axpy chain -> ``(x_new, r_new)``.

    ``ap = a p; alpha = rz / (p . ap)``, with 0/0 -> 0 for a column whose
    denominator is not above ``finfo.tiny`` (a converged column takes an
    exact no-op), then ``x + alpha p`` and ``r - alpha ap``: op for op the
    hot half of `estimators.operators.solve.cg_solve`'s loop body.
    """
    ap = a @ p
    den = (p * ap).sum(-2)
    tiny = torch.finfo(den.dtype).tiny
    big = den.abs() > tiny
    safe = torch.where(big, den, torch.ones_like(den))
    alpha = torch.where(big, rz / safe, torch.zeros_like(rz))[..., None, :]
    return x + alpha * p, r - alpha * ap


# lambda of the probabilistic rounding-error model (Higham & Mary, SIAM
# J. Sci. Comput. 41(5), 2019): rounding errors independent, zero-mean and
# at most u = eps / 2 each, an n-term sum in any order lies within
# lam sqrt(n) u sum|terms| of the exact sum but with a probability that
# falls like exp(-lam^2 / 2); the worst case is n u sum|terms|
ERROR_LAMBDA = 4.0


def _sum_error(n: int, dtype: torch.dtype, abs_sum: torch.Tensor):
    """``lam sqrt(n) u abs_sum``: the rounding error of an n-term sum."""
    return (ERROR_LAMBDA * n ** 0.5 * torch.finfo(dtype).eps / 2) * abs_sum


def _spread(abs_err: torch.Tensor) -> torch.Tensor:
    """``lam sqrt(sum abs_err^2)`` over the rows: a sum of independent
    errors, each at most ``abs_err``."""
    return ERROR_LAMBDA * torch.linalg.vector_norm(abs_err, dim=-2)


def matvec_bound(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Elementwise bound ``lam sqrt(n) u |a| @ |x|`` (`ERROR_LAMBDA`) of
    the rounding error of one evaluation of `matvec_ref` in ``a.dtype``,
    its sums in any order, against the exact product; K5 and this plain
    version differ by at most twice it."""
    x = x.to(a.dtype)
    return _sum_error(a.shape[-1], a.dtype, a.abs() @ x.abs())


def cheb_step_bound(a: torch.Tensor, w: torch.Tensor, w_prev: torch.Tensor,
                    v: torch.Tensor, center, width):
    """Elementwise bounds ``(on w_next, on dots)`` of the rounding error of
    one evaluation of `cheb_step_ref` in ``a.dtype``, its sums in any
    order, against the exact step; K6 and this plain version, each such
    an evaluation, differ by at most twice these.

    ``a @ w`` is within ``delta = lam sqrt(n) u |a| @ |w|`` (`ERROR_LAMBDA`).
    Carried through the epilogue, with one rounding of each product,
    subtract and divide (a factor 2 to spare): ``4 delta / |width| + 2 eps
    (|center w| / |width| + 2 |mv| + |w_next|)`` on ``w_next``.  The rows'
    errors are independent, so ``dots`` gets ``lam sqrt(sum (v tol_w)^2)``
    from them, plus its own sum's ``lam sqrt(n) u sum |v w_next|``.
    """
    eps = torch.finfo(a.dtype).eps
    n = a.shape[-1]
    width = torch.as_tensor(width, dtype=a.dtype, device=a.device)
    delta = _sum_error(n, a.dtype, a.abs() @ w.abs())
    mv = (2.0 * (a @ w) - center * w) / width
    w_next = 2.0 * mv - w_prev
    tol_w = 4 * delta / width.abs() + 2 * eps * (
        (center * w).abs() / width.abs() + 2 * mv.abs() + w_next.abs())
    tol_d = _spread(v * tol_w) + _sum_error(n, a.dtype,
                                            (v * w_next).abs().sum(-2))
    return tol_w, tol_d


def cg_step_bound(a: torch.Tensor, p: torch.Tensor, x: torch.Tensor,
                  r: torch.Tensor, rz: torch.Tensor):
    """Elementwise bounds ``(on x_new, on r_new)`` of the rounding error of
    one evaluation of `cg_step_ref` in ``a.dtype``, its sums in any order,
    against the exact step; K7 and this plain version differ by at most
    twice these.

    ``ap`` is within ``delta = lam sqrt(n) u |a| @ |p|`` (`ERROR_LAMBDA`),
    the denominator within ``lam sqrt(sum (p delta)^2) + lam sqrt(n) u sum
    |p ap|`` (independent row errors, then its own sum), alpha within
    ``|alpha| (d_den / |den| + 2 eps)`` to first order; the axpys add one
    rounding of the product and one of the sum, counted twice.  A column
    with a zero denominator takes alpha = 0 in both, exactly.
    """
    eps = torch.finfo(a.dtype).eps
    n = a.shape[-1]
    ap = a @ p
    delta = _sum_error(n, a.dtype, a.abs() @ p.abs())
    den = (p * ap).sum(-2)
    d_den = _spread(p * delta) + _sum_error(n, a.dtype,
                                            (p * ap).abs().sum(-2))
    big = den.abs() > torch.finfo(den.dtype).tiny
    safe = torch.where(big, den, torch.ones_like(den))
    alpha = torch.where(big, rz / safe, torch.zeros_like(rz))
    d_alpha = alpha.abs() * (d_den / safe.abs() + 2 * eps)
    alpha, d_alpha = alpha[None, :], d_alpha[None, :]
    x_new, r_new = x + alpha * p, r - alpha * ap
    tol_x = d_alpha * p.abs() + 2 * eps * ((alpha * p).abs() + x_new.abs())
    tol_r = (d_alpha * ap.abs() + alpha.abs() * delta
             + 2 * eps * ((alpha * ap).abs() + r_new.abs()))
    return tol_x, tol_r


def stencil_mv_ref(bands: torch.Tensor, x: torch.Tensor, *,
                   offsets) -> torch.Tensor:
    """``y[i] = sum_d bands[d, i] * x[i + offsets[d]]``, zero outside
    ``[0, n)`` (Dirichlet boundary); ``x`` is (n,) or (n, k).

    The bands are summed in order from a zero accumulator, each product
    materialized before it is added -- the arithmetic K8 repeats.
    """
    vec = x.dim() == 1
    x2 = (x[:, None] if vec else x).to(bands.dtype)
    n = x2.shape[0]
    lo = min(min(offsets), 0)
    hi = max(max(offsets), 0)
    xp = torch.nn.functional.pad(x2, (0, 0, -lo, hi))
    y = torch.zeros_like(x2)
    for d, off in enumerate(offsets):
        start = off - lo
        y = y + bands[d][:, None] * xp[start:start + n]
    return y[:, 0] if vec else y
