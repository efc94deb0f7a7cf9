"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

``ops`` dispatches by device: CUDA tensors launch the kernels
(``csrc/*.cu``, built at first use by ``_build``), CPU tensors run
``ref``.  K1 ``condense_step``, K2 ``panel_update``, K3 ``fused_step``,
K4 ``panel_factor``, K5 ``matvec`` and K8 ``stencil_mv`` hold one wrapper
and one launch counter each; ``fused_est`` holds K6 and K7.
``autotune`` picks the panel width of the rank-K update from the
calibration table (`repro_torch.core.calibration`).
"""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
