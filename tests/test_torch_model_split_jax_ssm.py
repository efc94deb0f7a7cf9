"""mamba2-370m's split mesh step on 1x2 and 2x2 grids of gloo ranks on the
CPU against the JAX package's jitted step on a fake-device mesh of the
same shape (`_torch_model_split_twins`): the smoke config (8 SSM heads
of 16 channels, state 16, one group), f32 activations, AdamW with the
logdet aux (``logdet_reg`` 0.05), one step from the JAX state carried
across, batch 4 x 16.

Each rank of a model line computes 4 of the 8 SSM heads: its columns of
the whole ``in_proj``, the conv on its channels, the scan on its heads,
the gated norm's sum of squares summed over the line, and its rows of
``out_proj`` (row-parallel); the other SSM leaves' gradients are each
rank's part, summed over the data and model lines at once.  GSPMD lays
the same rules out in JAX.

Held, on each grid: the reduced gradient within GRAD_TOL of the largest
element of JAX's, the metrics, the gathered gradient bitwise alike on
every rank, the collectives equal to `layout.step_plan`, and every rank's
share of the SSM heads and vocab rows."""
from __future__ import annotations

import pytest

import _torch_model_split_twins as T

# the SSM gate of the one-rank twins (tests/test_torch_model_split.py,
# PERF.md section 2): the port's one-device SSM step already differs
# from JAX's here by as much as the grid's own reorderings (the f32
# chunked scan's exp / cumsum and the gated norm, summed in other
# orders), each some 1e-5 of the largest element
GRAD_TOL = 1e-4
CASES = {"mamba2-370m": {"optimizer": "adamw", "logdet_reg": 0.05}}
SHARES = {"vocab": (128, 256), "ssm_heads": (4, 8)}
PARAMS = [(g, a) for g in T.GRIDS for a in CASES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return T.run(tmp_path_factory.mktemp("model_split_jax_ssm"), CASES)


@pytest.mark.parametrize("grid,arch", PARAMS)
def test_model_split_step_is_the_jax_meshs_step(runs, grid, arch):
    T.check_grads(runs, grid, arch, GRAD_TOL)


@pytest.mark.parametrize("grid,arch", PARAMS)
def test_every_rank_of_a_line_holds_the_same_bits(runs, grid, arch):
    T.check_bits(runs, grid, arch)


@pytest.mark.parametrize("grid,arch", PARAMS)
def test_collectives_equal_the_plan_and_each_rank_computes_its_heads(
        runs, grid, arch):
    plan = T.check_plan_and_shares(runs, grid, arch, SHARES)
    if grid == "1x2":
        # one data rank: the 7 whole leaves of each of the 2 SSM layers
        # are gathered over the model line and their gradients summed
        # over it, once a step
        assert plan["all_sum"] == plan["model_all_sum"] + 2 * 7 + 2
