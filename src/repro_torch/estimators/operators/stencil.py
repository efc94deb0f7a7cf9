"""Stencil backend: banded matrices as (offset, coefficient-row) pairs.

Counterpart of `repro.estimators.operators.stencil`.  Discretized
differential operators, graph Laplacians on grids and banded precision
matrices are defined by a few diagonals:

    A[i, i + offsets[d]] = bands[d, i]          (zero outside the bands)

Storage is O(nb n); the product ``y[i] = sum_d bands[d, i] x[i +
offsets[d]]`` costs O(nb n) per probe column and runs through
`repro_torch.kernels.ops.stencil_mv` (K8 on the card).  Entries whose
stencil pokes outside ``[0, n)`` read zero (Dirichlet boundary), as the
banded materialization in `to_dense` does.
"""
from __future__ import annotations

import torch

from repro_torch.estimators.operators.base import LinearOperator, PlanHints
from repro_torch.kernels import ops as _kops

__all__ = ["StencilOperator"]


def _transpose_bands(bands: torch.Tensor, offsets) -> torch.Tensor:
    """Band table of ``A^T``: row ``d`` holds ``bands[d]`` shifted by its
    offset (entries whose source row falls outside ``[0, n)`` address
    columns outside the matrix and are zeroed)."""
    n = bands.shape[1]
    out = torch.zeros_like(bands)
    for d, o in enumerate(offsets):
        if o >= 0:
            out[d, o:] = bands[d, :n - o]
        else:
            out[d, :n + o] = bands[d, -o:]
    return out


class StencilOperator(LinearOperator):
    """Implicit banded operator from diagonal offsets + coefficient rows.

    ``offsets`` -- distinct ints in (-n, n), one per band.
    ``bands``   -- (nb, n) per-row coefficients, or (nb,) constants
    broadcast along each diagonal (requires ``n``).  A tensor keeps its
    device; anything else becomes a CPU tensor.
    """

    def __init__(self, offsets, bands, n: int = None):
        offsets = tuple(int(o) for o in offsets)
        if len(set(offsets)) != len(offsets):
            raise ValueError(f"duplicate offsets: {offsets}")
        bands = torch.as_tensor(bands)
        if bands.dim() == 1:
            if n is None:
                raise ValueError("constant bands (nb,) require n")
            bands = bands[:, None].expand(bands.shape[0], n)
        elif bands.dim() == 2:
            n = bands.shape[1]
        else:
            raise ValueError(f"bands must be (nb,) or (nb, n), "
                             f"got {tuple(bands.shape)}")
        if bands.shape[0] != len(offsets):
            raise ValueError(f"{len(offsets)} offsets but "
                             f"{bands.shape[0]} band rows")
        if any(abs(o) >= n for o in offsets):
            raise ValueError(f"offsets {offsets} out of range for n={n}")
        self.offsets = offsets
        self.bands = bands.contiguous()
        self.shape = (n, n)
        self.dtype = bands.dtype
        self.device = bands.device
        # A^T has offset -o carrying bands[d] shifted; the shifted table
        # is built on first rmm use
        self._offsets_t = tuple(-o for o in offsets)
        self._bands_t = None

    def to(self, device) -> "StencilOperator":
        """The same operator on ``device`` (this one is left alone)."""
        return StencilOperator(self.offsets, self.bands.to(device))

    def _check_slab(self, v):
        if v.dim() != 2 or v.shape[0] != self.n:
            raise ValueError(f"expected ({self.n}, k) slab, got "
                             f"{tuple(v.shape)}")

    def mm(self, v):  # (n, k) -> (n, k)
        self._check_slab(v)
        return _kops.stencil_mv(self.bands, v.to(self.dtype).contiguous(),
                                offsets=self.offsets)

    def mv(self, v):
        return _kops.stencil_mv(self.bands, v.to(self.dtype).contiguous(),
                                offsets=self.offsets)

    def rmm(self, v):  # (n, k) -> (n, k): A^T via the transposed band table
        self._check_slab(v)
        if self._bands_t is None:
            self._bands_t = _transpose_bands(self.bands, self.offsets)
        return _kops.stencil_mv(self._bands_t,
                                v.to(self.dtype).contiguous(),
                                offsets=self._offsets_t)

    def diag(self):
        if 0 in self.offsets:
            return self.bands[self.offsets.index(0)]
        return torch.zeros(self.n, dtype=self.dtype, device=self.device)

    def plan_hints(self):
        # banded contraction: 2 FLOPs per band entry per column
        return PlanHints(structure="stencil",
                         matvec_flops=2.0 * len(self.offsets) * self.n,
                         materializable=False)

    def to_dense(self):
        n = self.n
        a = torch.zeros((n, n), dtype=self.dtype, device=self.device)
        for d, off in enumerate(self.offsets):
            if off >= 0:
                a = a + torch.diag(self.bands[d, :n - off], off)
            else:
                a = a + torch.diag(self.bands[d, -off:], off)
        return a
