"""Gaussian-mixture log-likelihood by EM on the PyTorch / CUDA port: the
twin of examples/gmm_loglik.py (the paper's motivating application:
generative learning with LARGE covariance matrices).

    log N(x | mu, Sigma) = -1/2 [ d log(2 pi) + logdet(Sigma)
                                  + (x-mu)^T Sigma^-1 (x-mu) ]

Two costs per EM iteration, and two regimes for each:

  logdet(Sigma)  --logdet exact        condensation (serial schedule, K1
                                       once a step for the whole stack)
                 --logdet chebyshev|slq stochastic estimators
                 --logdet auto         repro_torch.plan's cost model
  Mahalanobis    --solver direct        torch.linalg.solve, O(d^3)
                 --solver cg            matrix-free conjugate gradient on
                                        the SAME operator

Every log-determinant goes through ONE `repro_torch.plan`, built before
the EM loop and executed per iteration: with ``--solver direct`` a (K, d,
d) plan on the covariance stack (the JAX example's one-device path), with
``--solver cg`` a plan on the user-side `EmpiricalCovOperator`, executed
on each component's operator.  The operator holds Sigma = Xc^T diag(w) Xc
/ sum(w) + ridge*I without building it: its product is two (n, d) GEMMs
and its diagonal is free, feeding both the estimators and the
Jacobi-preconditioned `cg_solve`.

    PYTHONPATH=src python3 examples/gmm_loglik_torch.py --dim 256
    PYTHONPATH=src python3 examples/gmm_loglik_torch.py --dim 512 --logdet slq
    PYTHONPATH=src python3 examples/gmm_loglik_torch.py --dim 512 --solver cg
    PYTHONPATH=src python3 examples/gmm_loglik_torch.py --device cpu

Plans run on the card unless ``--device cpu`` is given.  Everything is
float64, as in the JAX example.
"""
import argparse
import math

import numpy as np
import torch

import repro_torch
from repro_torch.estimators import LinearOperator, cg_solve
from repro_torch.estimators.operators.base import resolve_device

ESTIMATORS = ("chebyshev", "slq")


class EmpiricalCovOperator(LinearOperator):
    """Implicit Sigma = Xc^T diag(w) Xc / sum(w) + ridge*I, never built.

    ``xc (n, d)`` centered data, ``w (n,)`` responsibilities.  The product
    is two tall-skinny GEMMs; the diagonal (Jacobi preconditioning) is
    one weighted column-square sum.
    """

    def __init__(self, xc, w, ridge):
        self.xc = xc
        self.w = w
        self.wsum = w.sum() + 1e-9
        self.ridge = ridge
        self.shape = (xc.shape[1], xc.shape[1])
        self.dtype = xc.dtype
        self.device = xc.device

    def to(self, device):
        return EmpiricalCovOperator(self.xc.to(device), self.w.to(device),
                                    self.ridge)

    def mm(self, v):  # (d, k) -> (d, k)
        return (self.xc.T @ (self.w[:, None] * (self.xc @ v))) / self.wsum \
            + self.ridge * v

    def diag(self):
        return (self.w[:, None] * self.xc ** 2).sum(0) / self.wsum \
            + self.ridge


def _estimator_kw(how: str) -> dict:
    if how == "auto":
        return {}
    kw = {"num_probes": 32}
    if how == "chebyshev":
        kw["degree"] = 64
    return kw


def make_logdet_plan(k: int, d: int, *, how: str, solver: str, template,
                     device, dtype):
    """The logdet plan, built ONCE before the EM loop: on the (K, d, d)
    stack (``--solver direct``), or on an `EmpiricalCovOperator`
    (``--solver cg``), executed on every component's operator."""
    if solver == "cg":
        p = repro_torch.plan(template, method=how, device=device,
                             **_estimator_kw(how))
    elif how == "exact":
        p = repro_torch.plan((k, d, d), method="exact", schedule="serial",
                             device=device, precision=str(dtype)
                             .removeprefix("torch."))
    else:
        p = repro_torch.plan((k, d, d), method=how, device=device,
                             precision=str(dtype).removeprefix("torch."),
                             **_estimator_kw(how))
    if how == "auto":
        print(f"[plan] auto-selected logdet method: {p.method} "
              f"(est. {p.diagnostics.flops_est:.2e} FLOPs)")
    return p


def gaussian_loglik(x, mu, solve_fn, ld):
    """Log-density of the rows of x under N(mu, Sigma); ld = logdet(Sigma).

    ``solve_fn`` maps a (d, n) right-hand-side slab to Sigma^{-1} @ rhs --
    dense factorization or matrix-free CG.
    """
    d = x.shape[1]
    xc = x - mu
    sol = solve_fn(xc.T)                        # (d, n)
    quad = (xc * sol.T).sum(1)
    return -0.5 * (d * math.log(2 * math.pi) + ld + quad)


def run(*, dim=128, components=3, samples=600, iters=5, logdet="exact",
        solver="direct", cg_tol=1e-8, device=None, log=True):
    """EM on the synthetic mixture -> history per iteration: ``ll`` (mean
    log-likelihood per sample), ``ld`` and ``sem`` (each component's
    logdet and its standard error, 0 for exact), ``cg_iters`` (the
    largest CG iteration count, ``--solver cg``), ``logdet`` (the method
    that ran) and ``device``; also the final ``weights`` and
    ``mean_err``."""
    dev = resolve_device(device)
    dtype = torch.float64
    how = logdet
    if solver == "cg" and how == "exact":
        # exact condensation would materialize Sigma; stay matrix-free
        how = "slq"
        if log:
            print("[--solver cg] switching --logdet exact -> slq "
                  "(keeping the E-step matrix-free)")

    rng = np.random.default_rng(0)
    d, k, n = dim, components, samples
    # ground-truth mixture (the JAX example's, from the same generator)
    true_mu = rng.standard_normal((k, d)) * 3
    data = np.concatenate([
        true_mu[j] + rng.standard_normal((n // k, d)) @
        (np.eye(d) + 0.1 * rng.standard_normal((d, d)))
        for j in range(k)
    ])
    x = torch.as_tensor(data, dtype=dtype, device=dev)
    # init: random means; unit covariance == zero-weight operator + ridge 1
    mu = torch.as_tensor(true_mu + rng.standard_normal((k, d)), dtype=dtype,
                         device=dev)
    pi = torch.full((k,), 1.0 / k, dtype=dtype, device=dev)
    resp_w = torch.zeros((x.shape[0], k), dtype=dtype, device=dev)
    ridge = 1.0

    template = EmpiricalCovOperator(x - mu[0], resp_w[:, 0], ridge)
    ld_plan = make_logdet_plan(k, d, how=how, solver=solver,
                               template=template, device=dev, dtype=dtype)
    eye = torch.eye(d, dtype=dtype, device=dev)
    hist = {"ll": [], "ld": [], "sem": [], "cg_iters": [],
            "logdet": ld_plan.method, "device": str(dev)}
    for it in range(iters):
        # E-step: per-component logdet and Mahalanobis solve, then the
        # responsibilities from the per-component log-densities
        gen = torch.Generator(device=dev).manual_seed(it)
        cg_iters = []
        if solver == "cg":
            ops = [EmpiricalCovOperator(x - mu[j], resp_w[:, j], ridge)
                   for j in range(k)]
            res = [ld_plan(op, generator=gen) for op in ops]
            lds = torch.stack([r.logabsdet for r in res])
            sems = torch.stack([r.sem for r in res])

            def solver_of(op):
                def solve(rhs):
                    out = cg_solve(op, rhs, tol=cg_tol, device=dev)
                    cg_iters.append(out.iters)
                    return out.x
                return solve
            solvers = [solver_of(op) for op in ops]
        else:
            cov = torch.stack([
                ((resp_w[:, j, None] * (x - mu[j])).T @ (x - mu[j]))
                / (resp_w[:, j].sum() + 1e-9) + ridge * eye
                for j in range(k)])
            res = ld_plan(cov) if ld_plan.method not in ESTIMATORS \
                else ld_plan(cov, generator=gen)
            lds, sems = res.logabsdet, res.sem
            solvers = [(lambda rhs, c=c: torch.linalg.solve(c, rhs))
                       for c in cov]
        logp = torch.stack([gaussian_loglik(x, mu[j], solvers[j], lds[j])
                            for j in range(k)], dim=1)
        logp = logp + torch.log(pi)[None]
        ll = torch.logsumexp(logp, dim=1)
        resp = torch.exp(logp - ll[:, None])
        hist["ll"].append(ll.mean().item())
        hist["ld"].append(lds.tolist())
        hist["sem"].append(sems.tolist())
        hist["cg_iters"].append(max(cg_iters) if cg_iters else None)
        if log:
            print(f"iter {it}: mixture log-likelihood/sample = "
                  f"{hist['ll'][-1]:.4f}  [logdet: {how}, solver: {solver}]",
                  flush=True)

        # M-step: means and weights; the covariances are re-expressed from
        # (mu, resp) next E-step, as operators (cg) or dense (direct)
        nk = resp.sum(0) + 1e-9
        pi = nk / nk.sum()
        mu = (resp.T @ x) / nk[:, None]
        resp_w = resp
        ridge = 1e-3

    hist["weights"] = pi.tolist()
    true = torch.as_tensor(true_mu, dtype=dtype, device=dev)
    hist["mean_err"] = (torch.sort(mu, 0).values
                        - torch.sort(true, 0).values).abs().mean().item()
    return hist


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--components", type=int, default=3)
    ap.add_argument("--samples", type=int, default=600)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--logdet", choices=("exact", "chebyshev", "slq", "auto"),
                    default="exact",
                    help="logdet path for the covariances ('auto' lets "
                         "repro_torch.plan's cost model choose)")
    ap.add_argument("--solver", choices=("direct", "cg"), default="direct",
                    help="Mahalanobis solve: dense factorization or "
                         "matrix-free CG on implicit covariance operators")
    ap.add_argument("--cg-tol", type=float, default=1e-8)
    ap.add_argument("--device", default=None, help="None (the card) or cpu")
    args = ap.parse_args(argv)
    hist = run(dim=args.dim, components=args.components,
               samples=args.samples, iters=args.iters, logdet=args.logdet,
               solver=args.solver, cg_tol=args.cg_tol, device=args.device)
    print("\nfinal mixture weights:", np.round(hist["weights"], 3))
    print("mean abs error of recovered means:", hist["mean_err"])
    return hist


if __name__ == "__main__":
    main()
