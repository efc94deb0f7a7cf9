"""Gradient-trained Gaussian mixture on the PyTorch / CUDA port: the twin
of examples/gmm_fit.py.

Trains a mixture by SGD on the negative log-likelihood

    NLL = -mean_x log sum_k softmax(w)_k N(x | mu_k, Sigma_k)

with ``Sigma_k = L_k L_k^T`` parameterized by its Cholesky factor (lower
triangle free, diagonal softplus-positive), so every step needs
``d NLL / d Sigma`` through one (K, d, d) `repro_torch.plan`, built before
the training loop with ``grad=True``.  Every step executes it on the
whole stack: with an estimator (``chebyshev``, ``slq``) the forward is
one batched estimator run and the backward one batched transposed CG on
the forward's probes; with ``exact`` (the JAX example's ``mc``: the
serial condensation schedule) the forward runs K1 once per step for all
K matrices and the backward is one batched ``inv(Sigma)^T``.  The
Mahalanobis term uses the triangular factor (two O(d^2) solves per
sample, differentiable).

The Cholesky parameterization gives a free exact reference,
``logdet(Sigma_k) = 2 sum_i log L_k[i, i]``; ``ld_gap`` is the mean
|plan - reference| over the components after each step.

    PYTHONPATH=src python3 examples/gmm_fit_torch.py --dim 32 --components 3
    PYTHONPATH=src python3 examples/gmm_fit_torch.py --method slq --steps 200
    PYTHONPATH=src python3 examples/gmm_fit_torch.py --method exact --device cpu

Plans run on the card unless ``--device cpu`` is given.
"""
import argparse
import math
import time

import numpy as np
import torch

import repro_torch
from repro_torch.estimators.operators.base import resolve_device

METHODS = ("exact", "chebyshev", "slq")


def make_data(rng, dim, components, samples):
    """Well-separated synthetic mixture with anisotropic covariances (the
    JAX example's, from the same numpy generator)."""
    mu = rng.standard_normal((components, dim)) * 3.0
    chunks = []
    for j in range(components):
        m = np.eye(dim) + 0.2 * rng.standard_normal((dim, dim))
        chunks.append(mu[j] + rng.standard_normal(
            (samples // components, dim)) @ m)
    return np.concatenate(chunks), mu


def init_params(rng, dim, components, x, device, dtype):
    """Means at random data points, near-unit Cholesky factors; leaf
    tensors that require a gradient."""
    idx = rng.choice(x.shape[0], size=components, replace=False)
    init = {
        "mu": x[idx] + 0.1 * rng.standard_normal((components, dim)),
        "logit_w": np.zeros((components,)),
        # softplus(0.55) ~ 1.0: identity-ish initial covariances
        "chol_diag_raw": np.full((components, dim), 0.55),
        "chol_low": np.zeros((components, dim, dim)),
    }
    return {k: torch.tensor(v, dtype=dtype, device=device,
                            requires_grad=True) for k, v in init.items()}


def cholesky_factors(params):
    """(K, d, d) lower-triangular factors with positive diagonal."""
    low = torch.tril(params["chol_low"], -1)
    diag = torch.nn.functional.softplus(params["chol_diag_raw"]) + 1e-3
    return low + torch.diag_embed(diag)


def make_logdet_plan(components, dim, *, method, num_probes, degree,
                     num_steps, device, dtype):
    """The (K, d, d) -> (K,) logdet plan, built once before training."""
    shape = (components, dim, dim)
    kw = dict(device=device, precision=str(dtype).removeprefix("torch."),
              grad=True)
    if method == "exact":
        return repro_torch.plan(shape, method="exact", schedule="serial",
                                **kw)
    if method == "chebyshev":
        return repro_torch.plan(shape, method="chebyshev",
                                num_probes=num_probes, degree=degree, **kw)
    return repro_torch.plan(shape, method="slq", num_probes=num_probes,
                            num_steps=num_steps, **kw)


def logdet_of(ld_plan, sigma, generator):
    if ld_plan.method == "exact":
        return ld_plan.logdet(sigma)
    return ld_plan.logdet(sigma, generator=generator)


def nll(params, x, ld_plan, generator):
    """Mixture NLL per sample; the logdet term backpropagates through the
    plan's autograd rule."""
    chol = cholesky_factors(params)                     # (K, d, d)
    sigma = chol @ chol.mT                              # L L^T, SPD stack
    d = x.shape[1]
    ld = logdet_of(ld_plan, sigma, generator)           # (K,)
    # Mahalanobis through the factor: ||L^{-1}(x - mu)||^2
    xc = x[None, :, :] - params["mu"][:, None, :]       # (K, n, d)
    y = torch.linalg.solve_triangular(chol, xc.mT, upper=False)  # (K, d, n)
    quad = (y ** 2).sum(1)                              # (K, n)
    logp = (torch.log_softmax(params["logit_w"], 0)[:, None]
            - 0.5 * (d * math.log(2 * math.pi) + ld[:, None] + quad))
    return -torch.logsumexp(logp, 0).mean()


def train(*, dim=32, components=3, samples=600, steps=100,
          method="chebyshev", num_probes=16, degree=32, num_steps=15,
          lr=0.05, seed=0, device=None, dtype=torch.float64, log_every=10):
    """SGD (momentum 0.9, as the JAX example's optax.sgd) on the mixture
    NLL -> history: ``nll`` (the loss of each step; stochastic with an
    estimator), ``ld_gap`` (mean |plan - 2 sum log diag L| over the
    components after each step), ``step_s`` (seconds per step, the card
    synchronized), ``params`` and ``device``."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; one of {METHODS}")
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    data, _ = make_data(rng, dim, components, samples)
    x = torch.as_tensor(data, dtype=dtype, device=dev)
    params = init_params(rng, dim, components, data, dev, dtype)
    ld_plan = make_logdet_plan(components, dim, method=method,
                               num_probes=num_probes, degree=degree,
                               num_steps=num_steps, device=dev, dtype=dtype)
    opt = torch.optim.SGD(list(params.values()), lr=lr, momentum=0.9)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    history = {"nll": [], "ld_gap": [], "step_s": []}
    for step in range(steps):
        sync()
        t0 = time.perf_counter()
        opt.zero_grad()
        loss = nll(params, x, ld_plan, gen)
        loss.backward()
        opt.step()
        sync()
        history["step_s"].append(time.perf_counter() - t0)
        with torch.no_grad():
            chol = cholesky_factors(params)
            exact = 2.0 * torch.log(torch.diagonal(chol, dim1=-2,
                                                   dim2=-1)).sum(-1)
            ld = logdet_of(ld_plan, chol @ chol.mT, gen)
            gap = (ld - exact).abs().mean()
        history["nll"].append(loss.item())
        history["ld_gap"].append(float(gap))
        if log_every and step % log_every == 0:
            print(f"step {step:4d}  nll/sample = {history['nll'][-1]:.4f}  "
                  f"logdet |plan-exact| = {history['ld_gap'][-1]:.3e}  "
                  f"{history['step_s'][-1] * 1e3:.1f} ms", flush=True)
    history["nll"] = np.asarray(history["nll"])
    history["ld_gap"] = np.asarray(history["ld_gap"])
    history["step_s"] = np.asarray(history["step_s"])
    history["params"] = params
    history["device"] = str(dev)
    return history


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--components", type=int, default=3)
    ap.add_argument("--samples", type=int, default=600)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--method", choices=METHODS, default="chebyshev",
                    help="logdet path: stochastic estimators (batched CG "
                         "backward) or exact serial condensation "
                         "(inv(Sigma)^T backward)")
    ap.add_argument("--num-probes", type=int, default=16)
    ap.add_argument("--degree", type=int, default=32)
    ap.add_argument("--num-steps", type=int, default=15)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="None (the card) or cpu")
    ap.add_argument("--dtype", choices=("float64", "float32"),
                    default="float64")
    args = ap.parse_args()
    hist = train(dim=args.dim, components=args.components,
                 samples=args.samples, steps=args.steps, method=args.method,
                 num_probes=args.num_probes, degree=args.degree,
                 num_steps=args.num_steps, lr=args.lr, seed=args.seed,
                 device=args.device, dtype=getattr(torch, args.dtype))
    print(f"\nNLL: {hist['nll'][0]:.4f} -> {hist['nll'][-1]:.4f} "
          f"({args.steps} steps, method={args.method}, "
          f"device={hist['device']}, "
          f"{np.median(hist['step_s']) * 1e3:.1f} ms a step)")
    assert hist["nll"][-1] < hist["nll"][0], "training failed to reduce NLL"


if __name__ == "__main__":
    main()
