"""repro_torch -- the PyTorch / CUDA port of `repro` for NVIDIA Hopper.

The exact log-determinant path of the JAX package (`repro.plan(a,
method="exact")` -> `ExactConfig` -> `engine.build_serial` ->
`staged_full`), in PyTorch, with its four Pallas kernels rewritten by
hand in CUDA C++ for ``sm_90a`` (``kernels/csrc``, built at first use).
Plans run on the card unless the caller passes ``device="cpu"``, which
runs the kernels' plain PyTorch versions.

    import repro_torch
    sign, logabsdet = repro_torch.plan(a, method="exact")()

This package imports ``torch`` and never ``jax`` or ``repro``.
"""
from repro_torch.core import (EngineConfig, ExactConfig, LogdetPlan,
                              LogdetResult, plan)

__all__ = ["plan", "LogdetPlan", "ExactConfig", "EngineConfig",
           "LogdetResult"]
