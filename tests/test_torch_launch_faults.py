"""Restarts of `repro_torch.ft.run_training` on a 2x2 grid of gloo ranks on
the CPU (`launch.train.build`'s gemma3-1b smoke state, sharded by the
rules): faults raised on every rank at once, on one rank inside the
train step's compute (between two of its collectives: the other rank of
its data line waits in the gradients' reduction until the grid's
collective timeout, `--collective-timeout`), and on one rank before a
step.

Every rank restarts at the same step, whether or not it raised itself
(the ranks agree on a fault before each step, and `sharding.layout
.mesh_step` commits on every rank or on none, after which they remake
their line groups), restores the latest
checkpoint onto the grid (or, before the first, goes on from the blocks
it holds), and the run ends bitwise where an uninterrupted run of the
same 2x2 grid ends, block for block.  The ranks run
`tests/test_torch_ranks.py`'s `launch_faults`."""
from __future__ import annotations

import pytest

from repro_torch.core.mesh import run_ranks

from test_torch_ranks import FAULT_ARGV as ARGV
from test_torch_ranks import FAULTS, launch_faults


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("launch_faults")
    clean = run_ranks(launch_faults, 4, backend="gloo", device="cpu",
                      timeout=300, args=(ARGV + ["--mesh", "2x2"], {},
                                         str(d / "clean")))
    grid = run_ranks(launch_faults, 4, backend="gloo", device="cpu",
                     timeout=300, args=(ARGV + ["--mesh", "2x2"], FAULTS,
                                        str(d / "grid")))
    return clean, grid


def test_every_rank_restarts_on_every_fault(runs):
    clean, grid = runs
    assert all(r["restarts"] == 0 for r in clean)
    for r in grid:
        assert r["restarts"] == len(FAULTS)
        assert r["fired"] == sorted(s for s, (_, ranks) in FAULTS.items()
                                    if r["coords"]["data"] * 2
                                    + r["coords"]["model"] in ranks)


def test_the_restarted_grid_ends_bitwise_the_uninterrupted_run(runs):
    clean, grid = runs
    for want, r in zip(clean, grid):
        assert r["coords"] == want["coords"]
        assert set(r["blocks"]) == set(want["blocks"])
        assert r["blocks"]["step"] == want["blocks"]["step"] == 12
        for k, v in want["blocks"].items():
            assert r["blocks"][k].shape == v.shape, (k, r["coords"])
            assert r["blocks"][k].tobytes() == v.tobytes(), (k, r["coords"])
