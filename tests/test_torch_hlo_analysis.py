"""Twins of tests/test_hlo_analysis.py for `repro_torch.launch.hlo_analysis`,
the shim over `repro_torch.analysis.ir`: its names are the ``ir``
objects; the roofline's math equals the JAX package's ``roofline`` given
the same hardware table; ``HW`` is the H100's data sheet (the JAX
table's keys); the collective accounting reads a recorded op stream
(the JAX function parses HLO text), with the JAX conventions for the
per-device wire bytes of each collective."""
from __future__ import annotations

import pytest

from repro.launch import hlo_analysis as J

from repro_torch.analysis import ir
from repro_torch.launch import hlo_analysis as H


def test_shim_names_are_the_ir_objects():
    assert H.__all__ == J.__all__
    for name in H.__all__:
        assert getattr(H, name) is getattr(ir, name)


@pytest.mark.parametrize("flops,hbm,wire,chips", [
    (197e12 * 256, 0.0, 0.0, 256), (1.0, 819e9 * 256 * 2.0, 49.5e9 * 0.5, 256),
    (3e15, 2e12, 1e9, 512), (0.0, 0.0, 5e9, 1), (1e18, 1e15, 1e12, 16)])
def test_roofline_math_equals_jax(flops, hbm, wire, chips):
    for hw in (J.HW, H.HW):
        got = H.roofline(flops=flops, hbm_bytes=hbm,
                         wire_bytes_per_chip=wire, chips=chips, hw=hw)
        want = J.roofline(flops=flops, hbm_bytes=hbm,
                          wire_bytes_per_chip=wire, chips=chips, hw=hw)
        assert got == want


def test_roofline_terms_and_bottleneck_on_the_h100():
    r = H.roofline(flops=989e12 * 256, hbm_bytes=0.0, wire_bytes_per_chip=0.0,
                   chips=256)
    assert r["compute_s"] == pytest.approx(1.0)
    assert r["bottleneck"] == "compute_s"
    r2 = H.roofline(flops=1.0, hbm_bytes=3.35e12 * 256 * 2.0,
                    wire_bytes_per_chip=450e9 * 0.5, chips=256)
    assert r2["memory_s"] == pytest.approx(2.0)
    assert r2["collective_s"] == pytest.approx(0.5)
    assert r2["bottleneck"] == "memory_s"
    assert r2["step_s_lower_bound"] == pytest.approx(2.0)


def test_roofline_hardware_constants():
    """NVIDIA H100 SXM data sheet: dense bf16, HBM3, NVLink 4 per
    direction; the keys are the JAX table's."""
    assert set(H.HW) == set(J.HW)
    assert H.HW["peak_flops_bf16"] == 989e12
    assert H.HW["hbm_bw"] == 3.35e12
    assert H.HW["ici_bw"] == 450e9


def _op(opcode, operand, result):
    return ir.Instruction(opcode, (ir.Shape("f32", result),),
                          (ir.Shape("f32", operand),))


def test_collective_bytes_of_a_recorded_module():
    """The JAX test's collectives, as recorded ops: counts and wire bytes
    by the JAX conventions (all-reduce 2x in; all-gather out - in;
    reduce-scatter in - out; the rest their buffer), and the port's
    broadcast (its buffer)."""
    p0, full = 16 * 1024 * 4, 256 * 1024 * 4
    mod = ir.Module(instructions=[
        _op("all-gather", (16, 1024), (256, 1024)),
        _op("all-reduce", (16, 1024), (16, 1024)),
        _op("reduce-scatter", (16, 1024), (1, 1024)),
        _op("all-to-all", (16, 1024), (16, 1024)),
        _op("collective-permute", (16, 1024), (16, 1024)),
        _op("broadcast", (16, 1024), (16, 1024)),
        _op("broadcast", (16, 1024), (16, 1024)),
        _op("aten.add", (16, 1024), (16, 1024)),
    ])
    st = H.collective_bytes(mod)
    assert st.counts == {"all-gather": 1, "all-reduce": 1,
                         "reduce-scatter": 1, "all-to-all": 1,
                         "collective-permute": 1, "broadcast": 2}
    assert st.by_op["all-reduce"] == 2 * p0
    assert st.by_op["all-gather"] == full - p0
    assert st.by_op["reduce-scatter"] == p0 - 4 * 1024
    assert st.by_op["collective-permute"] == p0
    assert st.by_op["broadcast"] == 2 * p0
    assert st.wire_bytes == sum(st.by_op.values())
