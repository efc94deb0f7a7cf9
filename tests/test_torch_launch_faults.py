"""Restarts of `repro_torch.ft.run_training` on a 2x2 grid of gloo ranks on
the CPU (`launch.train.build`'s gemma3-1b smoke state, sharded by the
rules): faults raised on every rank at once, on one rank inside the
train step after its gathers, and on one rank before a step.

Every rank restarts at the same step, whether or not it raised itself
(the ranks agree on a fault before each step, and `sharding.layout
.mesh_step` commits on every rank or on none), restores the latest
checkpoint onto the grid (or, before the first, goes on from the blocks
it holds), and the run ends bitwise where an uninterrupted one-rank run
ends.  The ranks run `tests/test_torch_ranks.py`'s `launch_faults`."""
from __future__ import annotations

import pytest

from repro_torch.core.mesh import run_ranks

from test_torch_launch_mesh import block_of, jax_specs
from test_torch_ranks import FAULT_ARGV as ARGV
from test_torch_ranks import FAULTS, launch_faults


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("launch_faults")
    one = run_ranks(launch_faults, 1, backend="gloo", device="cpu",
                    timeout=300, args=(ARGV + ["--mesh", "1x1"], {},
                                       str(d / "one")))[0]
    grid = run_ranks(launch_faults, 4, backend="gloo", device="cpu",
                     timeout=300, args=(ARGV + ["--mesh", "2x2"], FAULTS,
                                        str(d / "grid")))
    return one, grid


def test_every_rank_restarts_on_every_fault(runs):
    one, grid = runs
    assert one["restarts"] == 0
    for r in grid:
        assert r["restarts"] == len(FAULTS)
        assert r["fired"] == sorted(s for s, (_, ranks) in FAULTS.items()
                                    if r["coords"]["data"] * 2
                                    + r["coords"]["model"] in ranks)


def test_the_restarted_grid_ends_bitwise_the_uninterrupted_run(runs):
    one, grid = runs
    fm, specs = jax_specs((2, 2))
    for r in grid:
        assert set(r["blocks"]) == set(one["blocks"])
        assert r["blocks"]["step"] == one["blocks"]["step"] == 12
        for k, spec in specs.items():
            if k == "step":
                continue
            want = block_of(one["blocks"][k], spec, r["coords"], fm)
            assert r["blocks"][k].shape == want.shape, (k, r["coords"])
            assert r["blocks"][k].tobytes() == want.tobytes(), (
                k, r["coords"])
