"""Architecture configs -- counterpart of `repro.configs`: one module per
arch (+ shapes + registry)."""
from repro_torch.configs.registry import ARCHS, get_config, arch_ids
from repro_torch.configs.shapes import SHAPES, SHAPE_NAMES, ShapeSpec
