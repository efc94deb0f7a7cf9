"""Toeplitz backend: constant-diagonal products via a circulant FFT.

Counterpart of `repro.estimators.operators.toeplitz`.  Stationary
covariances -- autoregressive processes, time-series kernels,
translation-invariant grids -- are Toeplitz: ``T[i, j] = t_{i-j}`` is
fixed by its first column ``c`` (and first row ``r`` when
non-symmetric).  Storage is O(n); the product embeds T in the
2n-circulant

    col(C) = [c_0, ..., c_{n-1}, 0, r_{n-1}, ..., r_1]

whose eigenvectors are the DFT, so

    T x = (C [x; 0])[:n] = irfft( rfft(col) * rfft([x; 0]) )[:n]

-- O(n log n) per probe column, ``rfft(col)`` computed once at
construction.  Exact to roundoff: the embedding is an identity.  The JAX
package leaves the FFTs to XLA, so here they are `torch.fft` (cuFFT on
the card), no kernel of the port.
"""
from __future__ import annotations

import math

import torch

from repro_torch.estimators.operators.base import LinearOperator, PlanHints

__all__ = ["ToeplitzOperator"]


def _symbol(col: torch.Tensor, first: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    """``rfft`` of the 2n-circulant column ``[col, 0, first[1:][::-1]]``."""
    zero = torch.zeros(1, dtype=dtype, device=col.device)
    return torch.fft.rfft(torch.cat([col.to(dtype), zero,
                                     first[1:].flip(0).to(dtype)]))


class ToeplitzOperator(LinearOperator):
    """Implicit Toeplitz operator from first column ``c`` (and row ``r``).

    ``c (n,)`` is the first column; ``r (n,)`` the first row (default
    ``c``: the symmetric case, the one SPD estimators assume).  ``r[0]``
    should equal ``c[0]``; the diagonal is taken from ``c``.  A symmetric
    operator holds the same tensor as ``c`` and ``r``.  It lives on
    ``device``, else on ``c``'s device (the CPU for an array).
    """

    def __init__(self, c, r=None, *, device=None):
        c = torch.as_tensor(c)
        if c.dim() != 1 or c.shape[0] < 1:
            raise ValueError(f"expected first column (n,), got "
                             f"{tuple(c.shape)}")
        if c.is_complex():
            raise ValueError("complex Toeplitz not supported (SPD context)")
        r = c if r is None else torch.as_tensor(r)
        if r.shape != c.shape:
            raise ValueError(f"first row shape {tuple(r.shape)} != column "
                             f"{tuple(c.shape)}")
        if r.is_complex():
            raise ValueError("complex Toeplitz not supported (SPD context)")
        self.device = torch.device(device) if device is not None \
            else c.device
        same = r is c
        self.c = c.to(self.device)
        self.r = self.c if same else r.to(self.device)
        n = c.shape[0]
        self.shape = (n, n)
        self.dtype = torch.result_type(c, r)
        self._m = 2 * n
        self._fcol = _symbol(self.c, self.r, self.dtype)
        self._fcol_t = None              # transposed symbol, built on demand

    def to(self, device) -> "ToeplitzOperator":
        """The same operator on ``device`` (this one is left alone)."""
        return ToeplitzOperator(self.c, None if self.r is self.c else self.r,
                                device=device)

    def _circulant_mm(self, fcol, v):
        if v.dim() != 2 or v.shape[0] != self.n:
            raise ValueError(f"expected ({self.n}, k) slab, got "
                             f"{tuple(v.shape)}")
        vp = torch.nn.functional.pad(v.to(self.dtype),
                                     (0, 0, 0, self._m - self.n))
        y = torch.fft.irfft(fcol[:, None] * torch.fft.rfft(vp, dim=0),
                            n=self._m, dim=0)
        return y[:self.n].to(self.dtype)

    def mm(self, v):  # (n, k) -> (n, k)
        return self._circulant_mm(self._fcol, v)

    def rmm(self, v):  # (n, k) -> (n, k): T^T via the swapped symbol
        if self._fcol_t is None:
            # the transpose swaps first column and first row; built lazily
            # so that mm-only uses never pay the extra rfft
            self._fcol_t = _symbol(self.r, self.c, self.dtype)
        return self._circulant_mm(self._fcol_t, v)

    def diag(self):
        return self.c[0].to(self.dtype).expand(self.n)

    def trace_hint(self):
        return self.n * self.c[0].to(self.dtype)

    def plan_hints(self):
        # three length-2n FFTs per column: ~ 15 n log2(n) real FLOPs
        n = max(self.n, 2)
        return PlanHints(structure="toeplitz",
                         matvec_flops=15.0 * n * math.log2(n),
                         materializable=False)

    def to_dense(self):
        i = torch.arange(self.n, device=self.device)
        d = i[:, None] - i[None, :]                          # i - j
        vals = torch.cat([self.r[1:].flip(0), self.c]).to(self.dtype)
        return vals[d + self.n - 1]                          # index d + n - 1
