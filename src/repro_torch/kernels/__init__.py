"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

``ops`` dispatches by device: CUDA tensors launch the kernels
(``csrc/*.cu``, built at first use by ``_build``), CPU tensors run
``ref``.  K1 ``condense_step``, K2 ``panel_update``, K3 ``fused_step``
and K4 ``panel_factor`` hold one wrapper and one launch counter each.
"""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
