"""zamba2-7b's split mesh step on 1x2 and 2x2 grids of gloo ranks on the
CPU against the JAX package's jitted step on a fake-device mesh of the
same shape (`_torch_model_split_twins`): the smoke config (5 SSM layers
of 8 SSM heads, two super-blocks sharing one attention block of 4
heads), f32 activations, AdamW, one step from the JAX state carried
across, batch 4 x 16.

Each rank of a model line computes 4 of the 8 SSM heads in every SSM
layer -- the super-blocks' inner lists under their checkpoints, and the
trailing SSM layer outside one, whose whole ``in_proj`` the backward
gathers again -- and 2 of the shared attention block's 4 heads (kv
heads too) and half of its mlp columns, at each of its two calls.

Held, on each grid: the reduced gradient within GRAD_TOL of the largest
element of JAX's, the metrics, the gathered gradient bitwise alike on
every rank, the collectives equal to `layout.step_plan`, and every
rank's share of the SSM heads, heads, kv heads, mlp columns and vocab
rows."""
from __future__ import annotations

import pytest

import _torch_model_split_twins as T

# the SSM gate of the one-rank twins (tests/test_torch_model_split.py,
# PERF.md section 2), as in tests/test_torch_model_split_jax_ssm.py
GRAD_TOL = 1e-4
CASES = {"zamba2-7b": {"optimizer": "adamw"}}
SHARES = {"heads": (2, 4), "kv_heads": (2, 4), "mlp": (64, 128),
          "vocab": (128, 256), "ssm_heads": (4, 8)}
PARAMS = [(g, a) for g in T.GRIDS for a in CASES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return T.run(tmp_path_factory.mktemp("model_split_jax_hybrid"), CASES)


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
        # one data rank: the gathers over the model line are the 5 SSM
        # layers' whole in_proj, conv_w and conv_b (2 blocks each), for
        # the forward and once more for the backward -- the inner lists'
        # by their super-block's recomputation too
        assert plan["broadcast"] == 2 * 3 * (4 * 3 + 2)
