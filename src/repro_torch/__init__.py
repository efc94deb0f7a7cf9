"""repro_torch -- the PyTorch / CUDA port of `repro` for NVIDIA Hopper.

Paths of the JAX package, in PyTorch, with their Pallas kernels
rewritten by hand in CUDA C++ for ``sm_90a`` (``kernels/csrc``, built at
first use):

- ``method="auto"`` (the default): the JAX package's cost model, plus the
  host's dispatch time per row, on the table measured on the card
  (`core.calibration`, ``tools/torch_calibrate.py``), picks one of the
  routes below;
- the exact log-determinant (`repro.plan(a, method="exact")` ->
  `ExactConfig` -> `engine.build_serial` -> `staged_full`), through
  K1-K4, and the paper's baselines ``ge``, ``pge`` and ``plu``
  (`core.gaussian`, `core.scalapack`) through K1 and K2;
- the estimators on one device (``method="chebyshev"|"slq"`` on a dense
  SPD matrix or an operator -- `estimators.StencilOperator`,
  `estimators.KroneckerOperator`, `estimators.ToeplitzOperator` -- and
  `estimators.cg_solve`), through K6 (dense Chebyshev), K7 (dense CG)
  and K8 (every stencil product);
- the mesh (``mesh=`` a `core.mesh.Mesh`, one process per rank): the
  paper's parallel condensation (`engine.build_mesh`, K1, K2, K4) and
  the row-sharded estimators (`estimators.ShardedOperator`, K5);
- (B, n, n) stacks on one device: the exact routes and ``ge`` with every
  step on the whole stack (K1-K4's batch grids), the estimators on an
  `estimators.BatchedOperator` (batched products), and their gradients;
- observability (`obs`, ``REPRO_OBS=off|metrics|trace``): spans, counters
  and convergence telemetry under the JAX package's names, each engine
  and kernel stage a `torch.profiler` and NVTX range in trace mode, and
  ``LogdetPlan.explain``;
- serving (`serve`, ``python -m repro_torch.serve``): a bucketed,
  continuously batching `serve.LogdetService` whose exact stacks run
  through K1's batch grid, an HTTP front end, and ``LogdetPlan.export``
  / `load_plan` for plans resolved ahead of time;
- the seed's language models (`models`, `configs`, `data`), their
  training (`optim`, `train`, `checkpoint`, `ft`; the logdet aux through
  K1) and their launch (`sharding`: the JAX package's sharding rules and
  a state's blocks on a grid of ranks; `launch`: ``python -m
  repro_torch.launch.train`` / ``.serve`` / ``.dryrun``).

Plans run on the card unless the caller passes ``device="cpu"``, which
runs the kernels' plain PyTorch versions.  ``plan.audit()`` and
``python -m repro_torch.analysis`` (`analysis`) record a call and check
the route's invariants over its ops.  The legacy string API
(``repro_torch.core.slogdet``) and route strings (``method="mc"``, ...)
survive as deprecated shims, as in the JAX package.

    import repro_torch
    sign, logabsdet = repro_torch.plan(a)()                # auto
    sign, logabsdet = repro_torch.plan(a, method="exact")()
    res = repro_torch.plan(a, method="slq")(generator=g)   # res.sem too

This package imports ``torch`` and never ``jax`` or ``repro``.
"""
# core first: its mesh module must exist before the estimators' sharded
# backend imports it (core.plan imports the estimators in turn)
from repro_torch.core import (Calibration, ChebyshevConfig, Diagnostics,
                              EngineConfig, ExactConfig, LogdetPlan,
                              LogdetResult, ProblemSpec, SLQConfig,
                              load_calibration, plan, select_method,
                              select_route, spec_of)
from repro_torch import estimators, obs

# the JAX package's names
__all__ = ["plan", "LogdetPlan", "ProblemSpec", "select_method",
           "select_route", "spec_of", "ExactConfig", "EngineConfig",
           "ChebyshevConfig", "SLQConfig", "Calibration", "load_calibration",
           "LogdetResult", "Diagnostics", "estimators", "obs", "load_plan"]


def load_plan(path: str, **kwargs) -> LogdetPlan:
    """Load a plan written by ``LogdetPlan.export`` (on the card unless
    ``device="cpu"``).  Delegates to `repro_torch.serve.aot.load_plan`,
    imported here lazily, as the JAX package does."""
    from repro_torch.serve.aot import load_plan as _load
    return _load(path, **kwargs)
