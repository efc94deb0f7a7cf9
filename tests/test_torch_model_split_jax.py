"""The port's mesh step with the model split (`sharding.tensor`: tensor and
expert parallel on the "model" axis) on a 1x2 grid (model only) and a 2x2
grid of gloo ranks on the CPU, against the JAX package's jitted step on
a fake-device mesh of the same shape (``XLA_FLAGS=--xla_force_host_
platform_device_count=4``, in a subprocess: `_subproc.run_with_devices`),
laid out as the JAX launcher lays it out (``param_shardings`` in and out,
the batch by ``batch_spec``).  GSPMD computes the global program; each
port rank computes its share of the heads, mlp columns, experts and
vocab rows, and sums the partial products over its model line.

Two cases at the smoke configs, f32 activations, one step from the JAX
state carried across (`from_jax_train_state`), batch 4 x 16:

- gemma3-1b with the logdet aux (``logdet_reg`` 0.05, AdamW): 4 q heads
  split two ways while its one kv head stays whole (its k / v
  projections' gradients summed over the model line once), its mlp and
  vocab split;
- qwen2-moe-a2.7b (AdamW) at a batch where the capacity drops tokens
  (`tests/test_torch_split_jax.py` checks it drops): its experts and the
  shared experts' MLP split, ``qkv_bias``.

Held, on each grid: the reduced gradient before the clip (each rank's
blocks, gathered whole after the step) within GRAD_TOL of the largest
element of ``jax.grad`` of the JAX loss, the step's metrics within
METRIC_RTOL of the jitted step's, the gathered gradient bitwise the same
on every rank and every rank's gradient blocks bitwise its blocks of it,
the ranks that hold one block of a leaf after the step bitwise alike,
the step's collectives equal to `layout.step_plan`, and each rank of a
model line computing its own share of the heads (kv heads where they
divide), mlp columns, experts and vocab rows."""
from __future__ import annotations

import pytest

import _torch_model_split_twins as T

GRAD_TOL = 1e-5
CASES = {"gemma3-1b": {"optimizer": "adamw", "logdet_reg": 0.05},
         "qwen2-moe-a2.7b": {"optimizer": "adamw"}}
# what each rank of a model line of two computes: (its share, the whole)
SHARES = {"gemma3-1b": {"heads": (2, 4), "kv_heads": (1, 1),
                        "mlp": (64, 128), "vocab": (128, 256)},
          "qwen2-moe-a2.7b": {"heads": (2, 4), "kv_heads": (2, 4),
                              "mlp": (16, 32), "experts": (4, 8),
                              "vocab": (128, 256)}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return T.run(tmp_path_factory.mktemp("model_split_jax"), CASES)


PARAMS = [(g, a) for g in T.GRIDS for a in CASES]


@pytest.mark.parametrize("grid,arch", PARAMS)
def test_model_split_step_is_the_jax_meshs_step(runs, grid, arch):
    T.check_grads(runs, grid, arch, GRAD_TOL)


@pytest.mark.parametrize("grid,arch", PARAMS)
def test_every_rank_of_a_line_holds_the_same_bits(runs, grid, arch):
    assert T.check_bits(runs, grid, arch) > 0


@pytest.mark.parametrize("grid,arch", PARAMS)
def test_collectives_equal_the_plan_and_each_rank_computes_its_share(
        runs, grid, arch):
    plan = T.check_plan_and_shares(runs, grid, arch, SHARES[arch])
    if grid == "1x2":
        # one data rank: nothing is gathered but the leaves the model line
        # computes whole (the router), and only gemma3's whole k / v
        # projections' gradients are summed (over the model line)
        assert plan["broadcast"] == (8 if arch == "qwen2-moe-a2.7b" else 0)
        grads = 6 * 2 if arch == "gemma3-1b" else 0
        assert plan["all_sum"] == plan["model_all_sum"] + grads + 2
