"""Tests of repro_torch that need a CUDA device (marker ``gpu``).

Each test asks the ``cuda`` fixture, which skips when no card is present
-- decided at run time, so every pytest-xdist worker collects the same
tests.  On a machine with a card (``--noconftest``: the shared
conftest imports jax, which such a machine need not have):

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Kernels against their plain versions at non-tile-multiple shapes: K1, K3
and K4's R and ls bitwise, K4's sign exactly, K4's logdet within 1e-6
(f32) / 1e-14 (f64) relative (the card's log against PyTorch's), K2
within its summation-order bound 2*K*eps*(|c|@|r|) + eps*|out|.
"""
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core.engine import EngineConfig, build_serial, stage_schedule
from repro_torch.kernels import condense_step, fused_step, ops, ref
from repro_torch.kernels import panel_factor as k4
from repro_torch.kernels import panel_update as k2

pytestmark = pytest.mark.gpu

VARIANTS = [(torch.float32, torch.float32), (torch.float64, torch.float64),
            (torch.float32, torch.bfloat16), (torch.float64, torch.bfloat16)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _randn(gen, *shape, dtype, device):
    return torch.randn(*shape, generator=gen, dtype=torch.float64).to(
        device=device, dtype=dtype)


@pytest.mark.parametrize("shape", [(1, 1), (7, 129), (129, 7), (255, 383),
                                   (33, 257)])
@pytest.mark.parametrize("dt,op", VARIANTS)
def test_rank1_and_fused_step_bitwise(cuda, shape, dt, op):
    gen = torch.Generator().manual_seed(0)
    m, n = shape
    a = _randn(gen, m, n, dtype=dt, device=cuda)
    pc = _randn(gen, m, dtype=op, device=cuda)
    pr = _randn(gen, n, dtype=op, device=cuda)
    assert torch.equal(condense_step.rank1_update(a, pc, pr),
                       ref.rank1_update_ref(a, pc, pr))
    l, last = torch.tensor([n // 2], device=cuda), n - 1
    cl, clast = a[:, n // 2].contiguous(), a[:, last].contiguous()
    assert torch.equal(fused_step.fused_step(a, l, last, pc, pr, cl, clast),
                       ref.fused_step_ref(a, l, last, pc, pr, cl, clast))


@pytest.mark.parametrize("shape", [(7, 129, 3), (65, 190, 33),
                                   (129, 257, 100), (256, 256, 32)])
@pytest.mark.parametrize("dt,op", VARIANTS)
def test_panel_update_within_bound(cuda, shape, dt, op):
    gen = torch.Generator().manual_seed(1)
    m, n, k = shape
    a = _randn(gen, m, n, dtype=dt, device=cuda)
    c = _randn(gen, m, k, dtype=op, device=cuda)
    r = _randn(gen, k, n, dtype=op, device=cuda)
    got, want = k2.panel_update(a, c, r), ref.panel_update_ref(a, c, r)
    acc = ref.accumulator_dtype(dt)
    tol = (2 * k * torch.finfo(acc).eps * (c.to(acc).abs() @ r.to(acc).abs())
           + torch.finfo(dt).eps * want.abs())
    assert bool(((got - want).abs() <= tol).all())


@pytest.mark.parametrize("k,n,m0", [(3, 33, 33), (5, 129, 100),
                                    (16, 200, 170), (32, 1000, 640)])
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_panel_factor_bitwise(cuda, k, n, m0, dt):
    gen = torch.Generator().manual_seed(2)
    panel = _randn(gen, k, n, dtype=dt, device=cuda)
    R, ls, s, ld = k4.panel_factor(panel, m0, 3)
    R0, ls0, s0, ld0 = ref.panel_factor_ref(panel, m0, 3)
    assert torch.equal(R, R0) and torch.equal(ls, ls0)
    assert s.item() == s0.item()
    rtol = 1e-6 if dt == torch.float32 else 1e-14
    assert abs(ld.item() - ld0.item()) <= rtol * abs(ld0.item())


def test_wrappers_check_their_operands(cuda):
    a = torch.zeros((4, 4), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        condense_step.rank1_update(a.t(), a[0].clone(), a[1].clone())
    with pytest.raises(TypeError, match="operands"):
        condense_step.rank1_update(a, a[0].double(), a[1].double())
    with pytest.raises(ValueError, match="m0"):
        k4.panel_factor(a[:2].contiguous(), 9)


@pytest.mark.parametrize("update", ["rank1", "panel"])
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_engine_on_the_card(cuda, update, dt):
    """The card agrees with the CPU run of the same plan, fused equals
    unfused bit for bit, and the launch counts show the kernels ran: K1
    or K3 for the rank-1 steps, K2 and K4 once per panel."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((200, 200))
    a = torch.from_numpy(x @ x.T / 200 + 2 * np.eye(200)).to(dt)
    a[7] = -a[7]
    kw = dict(schedule="staged", update=update, panel_k=16, min_size=32)
    s_cpu, ld_cpu = build_serial(EngineConfig(**kw))(a)
    out = {}
    for fused in (False, True):
        ops.reset_launch_counts()
        out[fused] = build_serial(EngineConfig(fused=fused, **kw))(a.to(cuda))
        counts = ops.launch_counts()
        assert counts["fused_step" if fused else "rank1_update"] > 0
        assert counts["rank1_update" if fused else "fused_step"] == 0
        if update == "panel":
            assert counts["panel_update"] == counts["panel_factor"] > 0
    assert torch.equal(out[False][0], out[True][0])
    assert torch.equal(out[False][1], out[True][1])
    assert out[False][0].item() == s_cpu.item() == -1.0
    rtol = 1e-4 if dt == torch.float32 else 1e-10
    assert abs(out[False][1].item() - ld_cpu.item()) <= rtol * abs(
        ld_cpu.item())


def test_plan_defaults_to_the_card(cuda):
    """device=None runs on the card; a CPU input is moved there and left
    unmodified."""
    rng = np.random.default_rng(6)
    a = torch.from_numpy(rng.standard_normal((96, 96)))
    before = a.clone()
    ops.reset_launch_counts()
    res = repro_torch.plan(a, method="exact")()
    assert res.sign.device.type == "cuda"
    assert ops.launch_counts()["rank1_update"] == sum(
        steps for _, steps in stage_schedule(96, 0.75, 64))
    assert torch.equal(a, before)
    s_np, ld_np = np.linalg.slogdet(a.numpy())
    assert res.sign.item() == s_np
    assert abs(res.logabsdet.item() - ld_np) <= 1e-10 * abs(ld_np)
