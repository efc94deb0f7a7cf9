"""The `LinearOperator` protocol: how estimators and solvers see a matrix.

Counterpart of `repro.estimators.operators.base`.  Every matrix-free
algorithm of the port (Hutchinson traces, stochastic Chebyshev, SLQ,
conjugate gradient) touches the operator through these methods:

  mm(v)         product with a slab of column vectors (n, k) -> (n, k),
                the hot path: one call per polynomial / Lanczos / CG step.
  mv(v)         single matvec (n,) -> (n,); default routes through ``mm``.
  rmm(v)/rmv(v) transposed products ``A^T v``; the defaults assume
                symmetry (the SPD estimator context).
  diag()        the diagonal (n,) when cheap, else ``None`` (Jacobi
                preconditioning in `solve.cg_solve`).
  trace_hint()  exact trace when the structure makes it free, else None.

Anything with ``.shape``, ``.dtype`` and ``.mm`` quacks as an operator;
it states where its products run with ``.device`` (else the CPU is
assumed).  The port's operators also carry ``.to(device)``, which
returns an operator on that device and leaves this one alone; an entry
point given an operator on another device moves it so, and raises for
an operator that cannot be moved.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

__all__ = ["LinearOperator", "PlanHints", "is_operator", "check_square",
           "device_of", "resolve_device"]


class PlanHints(NamedTuple):
    """What an operator tells the plan (`repro_torch.plan`).

    ``structure``        short tag ("dense", "stencil", ...) for diagnostics
    ``matvec_flops``     FLOPs one matvec column costs through this backend
    ``materializable``   True when `to_dense` is a cheap O(n^2) read
    ``device_count``     devices a matvec spans
    """
    structure: str
    matvec_flops: float
    materializable: bool = False
    device_count: int = 1


class LinearOperator:
    """Protocol base: square operator exposing the slab product ``mm``."""

    shape: Tuple[int, ...]
    dtype: torch.dtype = None
    device: torch.device = torch.device("cpu")

    def mm(self, v: torch.Tensor) -> torch.Tensor:
        """Product with a slab of column vectors: (n, k) -> (n, k)."""
        raise NotImplementedError

    def mv(self, v: torch.Tensor) -> torch.Tensor:
        """Single matvec (n,) -> (n,)."""
        return self.mm(v[:, None])[:, 0]

    def rmm(self, v: torch.Tensor) -> torch.Tensor:
        """Transposed product ``A^T v``; the default assumes symmetry."""
        return self.mm(v)

    def rmv(self, v: torch.Tensor) -> torch.Tensor:
        """Single transposed matvec ``A^T v``: (n,) -> (n,)."""
        return self.rmm(v[:, None])[:, 0]

    def diag(self) -> Optional[torch.Tensor]:
        """Operator diagonal (n,) when cheap, else None (unknown)."""
        return None

    def trace_hint(self) -> Optional[torch.Tensor]:
        """Exact trace when the structure makes it free (default: the sum
        of `diag` when that is available), else None."""
        d = self.diag()
        return None if d is None else d.sum(-1)

    def plan_hints(self) -> PlanHints:
        """The default assumes an unstructured implicit operator: a
        dense-cost matvec (2 n^2 FLOPs per column), not materializable."""
        n = self.shape[-1]
        return PlanHints(structure="implicit", matvec_flops=2.0 * n * n,
                         materializable=False)

    def to_dense(self) -> torch.Tensor:
        """Materialize as (n, n) -- n matvecs; testing / small n only."""
        return self.mm(torch.eye(self.n, dtype=self.dtype,
                                 device=device_of(self)))

    @property
    def n(self) -> int:
        return self.shape[0]


def is_operator(a) -> bool:
    """True if ``a`` satisfies the operator protocol (subclass or duck):
    operators expose ``mm`` and ``shape``; arrays and tensors expose
    ``ndim`` as well."""
    if isinstance(a, LinearOperator):
        return True
    return (hasattr(a, "mm") and hasattr(a, "shape")
            and not hasattr(a, "ndim"))


def check_square(shape, what: str = "matrix"):
    if len(shape) != 2 or shape[0] != shape[1]:
        raise ValueError(f"expected square {what}, got {tuple(shape)}")


def device_of(op) -> torch.device:
    """The device an operator's products run on (the CPU for a duck-typed
    operator that does not say)."""
    return torch.device(getattr(op, "device", "cpu"))


def resolve_device(device) -> torch.device:
    """The device an entry point of the port runs on: ``None`` is the
    card, and raises when there is none; ``"cpu"`` runs the plain PyTorch
    versions of the kernels."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device=\"cpu\" to run the plain PyTorch "
                "versions on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {dev} unsupported (cuda or cpu)")
    return dev
