"""K6 and K7 wrappers: the fused estimator steps on the card.

Launch the hand-written CUDA kernels in ``csrc/cheb_step.cu`` (the port
of `repro.kernels.fused_est.cheb_step_pallas`) and ``csrc/cg_step.cu``
(the port of `repro.kernels.fused_est.cg_step_pallas`).  Their plain
versions are `repro_torch.kernels.ref.cheb_step_ref` and
`repro_torch.kernels.ref.cg_step_ref`.

Bound: bytes at k = 32 f32 (A once; near the f32 FFMA ridge), which
the Pallas kernels meet by holding A in VMEM.  Both stream the (n, n)
matrix once and finish the recurrence on the product's tile, so the
slabs cross memory once; their column dots are reduced across blocks
through a (row blocks, k) buffer in a fixed order, so a repeated call is
bitwise repeatable.  Unlike the Pallas kernels they have no size budget:
on a CUDA tensor they run at every n.

K6 and K7 compute their product on K5's tile (``csrc/skinny_mma.cuh``:
128-row blocks, A streamed through a shared-memory ring by the copy
engine, DMMA in f64), cut by `matvec.plan` for ``(n, n, k)``: where that
cut splits the reduction axis, each range writes an (S, n, k) slice
allocated here, and the pass that adds the slices runs the epilogue (K6's
recurrence, K7's ``ap`` and dots); the partial dots take one row of k
per block of the cut's ``bm`` rows.  K7's second launch forms alpha from
them and runs both axpys.
On an H100 at n = 16384, k = 32, split in two, in f32 / f64: K6 0.556 /
0.761 ms (``tools/k1_k6_variants.py``; the axis whole 0.701 / 1.084,
the first K6 on a 32 x 32 FFMA tile 1.143 / 3.079); K7 0.551 / 0.763
(``tools/k7_variants.py``; the axis whole 0.700 / 1.091, the first K7
on that tile 1.130 / 3.077).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import matvec as _k5

__all__ = ["cheb_step", "cg_step", "cheb_step_launches", "cg_step_launches",
           "MAX_CG_COLUMNS"]

cheb_step_launches = 0   # since the last reset (ops.reset_launch_counts)
cg_step_launches = 0
MAX_CG_COLUMNS = 4096    # K7 keeps one alpha per column in shared memory;
                         # a wider slab runs in column blocks of this width


def _check(name: str, a: torch.Tensor, slabs, scalars=()):
    _build.require_cuda(name, a, (*slabs, *scalars))
    if any(t.dtype != a.dtype for t in (*slabs, *scalars)):
        raise TypeError(f"{name}: every operand must be {a.dtype}")
    n = a.shape[0]
    if a.dim() != 2 or a.shape[1] != n:
        raise ValueError(f"{name}: a must be square (n, n), got "
                         f"{tuple(a.shape)}")
    shape = slabs[0].shape
    if len(shape) != 2 or shape[0] != n or any(s.shape != shape
                                               for s in slabs):
        raise ValueError(f"{name}: slabs must all be ({n}, k), got "
                         f"{[tuple(s.shape) for s in slabs]}")
    return n, shape[1]


def cheb_step(a: torch.Tensor, w: torch.Tensor, w_prev: torch.Tensor,
              v: torch.Tensor, center: torch.Tensor, width: torch.Tensor):
    """One Chebyshev step -> ``(w_next (n, k), dots (k,))``.

    ``w_next = 2 (2 a w - center w) / width - w_prev``, ``dots = (v *
    w_next).sum(0)``.  ``center`` and ``width`` are one-element tensors on
    the card (read there, so the host never waits for them).  Two or three
    launches behind one entry point (the product with or without its
    split pass, then the column sums), counted as one.
    """
    global cheb_step_launches
    if center.numel() != 1 or width.numel() != 1:
        raise ValueError("cheb_step: center and width must hold one value")
    center, width = center.reshape(1), width.reshape(1)
    n, k = _check("cheb_step", a, (w, w_prev, v), (center, width))
    w_next = torch.empty_like(w)
    dots = torch.empty(k, dtype=a.dtype, device=a.device)
    p = _k5.plan(n, n, k, a.dtype, _k5._sm_count(a.device.index))
    partials = torch.empty((-(-n // p.bm), k), dtype=a.dtype, device=a.device)
    slices = (torch.empty(p.workspace, dtype=a.dtype, device=a.device)
              if p.workspace else None)
    fn = _build.function("cheb_step")
    with torch.cuda.device(a.device):
        rc = fn(_build.dtype_code(a.dtype), a.data_ptr(), w.data_ptr(),
                w_prev.data_ptr(), v.data_ptr(), center.data_ptr(),
                width.data_ptr(), w_next.data_ptr(), dots.data_ptr(),
                partials.data_ptr(),
                None if slices is None else slices.data_ptr(), n, k, p.bm,
                p.bn, p.chunk, p.splits, p.split_len, _build.stream(a))
    _build.check(rc, "cheb_step")
    cheb_step_launches += 1
    return w_next, dots


def cg_step(a: torch.Tensor, p: torch.Tensor, x: torch.Tensor,
            r: torch.Tensor, rz: torch.Tensor):
    """One CG matvec-and-axpy chain -> ``(x_new, r_new)``, each (n, k).

    ``ap = a p``, ``alpha = rz / (p . ap)`` per column (0 where the
    denominator is not above ``finfo.tiny``), ``x + alpha p`` and ``r -
    alpha ap``.  Two or three launches behind one entry point (the
    product with or without its split pass, then the update), counted as
    one.
    The columns are independent: a slab wider than ``MAX_CG_COLUMNS``
    runs as one such call per block of that many columns.
    """
    global cg_step_launches
    n, k = _check("cg_step", a, (p, x, r), (rz,))
    if rz.shape != (k,):
        raise ValueError(f"cg_step: rz must be ({k},), got {tuple(rz.shape)}")
    if k > MAX_CG_COLUMNS:
        parts = [cg_step(a, *(t[:, c:c + MAX_CG_COLUMNS].contiguous()
                              for t in (p, x, r)),
                         rz[c:c + MAX_CG_COLUMNS])
                 for c in range(0, k, MAX_CG_COLUMNS)]
        return (torch.cat([xp for xp, _ in parts], 1),
                torch.cat([rp for _, rp in parts], 1))
    x_new, r_new, ap = (torch.empty_like(p) for _ in range(3))
    cut = _k5.plan(n, n, k, a.dtype, _k5._sm_count(a.device.index))
    partials = torch.empty((-(-n // cut.bm), k), dtype=a.dtype,
                           device=a.device)
    slices = (torch.empty(cut.workspace, dtype=a.dtype, device=a.device)
              if cut.workspace else None)
    fn = _build.function("cg_step")
    with torch.cuda.device(a.device):
        rc = fn(_build.dtype_code(a.dtype), a.data_ptr(), p.data_ptr(),
                x.data_ptr(), r.data_ptr(), rz.data_ptr(), x_new.data_ptr(),
                r_new.data_ptr(), ap.data_ptr(), partials.data_ptr(),
                None if slices is None else slices.data_ptr(), n, k, cut.bm,
                cut.bn, cut.chunk, cut.splits, cut.split_len,
                _build.stream(a))
    _build.check(rc, "cg_step")
    cg_step_launches += 1
    return x_new, r_new
