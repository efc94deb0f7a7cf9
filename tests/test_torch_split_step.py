"""The split mesh step's parts on the CPU, against the port's own
one-rank step (`sharding.layout`, `optim` ``blocks=``).

- The optimizer on blocks, in one process with no ranks: on the
  qwen2.5-3b and zamba2-7b smoke trees laid out on a 2x2 ("data",
  "model") grid by `layout.state_shardings`, each rank updates its
  blocks from its blocks of the gradient, over two steps.  AdamW's and
  SGD's are bitwise that block of the whole update.  Adafactor's moments
  are in the rules' blocks, and its means over a split dim are summed
  over the grid's lines (the four ranks run as threads here, `Lines`
  summing each line's parts in rank order): a leaf that no axis splits
  is bitwise the whole update's, a split one within FACTORED_RTOL of
  each moment, and of each parameter's moves (summed over the steps)
  plus a spacing a step (its means add the same terms in another
  order), and the ranks that hold one block hold the same bits.
- A rank's rows (`layout.batch_rows`): its share of every global
  microbatch, in microbatch order.
- Two microbatches on a 2x1 grid of gloo ranks against one rank in this
  process (`test_torch_ranks.split_step`; gemma3-1b and qwen2-moe-a2.7b
  smoke, f32 activations, batch 8 x 16, gemma3 with the logdet aux):
  the reduced gradient within GRAD_TOL of the largest element, the
  metrics within METRIC_RTOL, every rank's gradient (its blocks gathered
  whole) bitwise the same, and two reductions of the gradient a step
  (one a microbatch) in the collectives, which equal
  `layout.step_plan`."""
from __future__ import annotations

import collections
import copy
import math
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.mesh import run_ranks
from repro_torch.launch.mesh import GridMesh
from repro_torch.optim import (BlockSplit, OptConfig, get_optimizer,
                               jax_leaves)
from repro_torch.sharding import layout
from repro_torch.sharding.rules import PartitionSpec, Sharding
from repro_torch.train import TrainConfig, init_train_state

from test_torch_ranks import split_step
from test_torch_split_jax import _case

GRAD_TOL = 1e-5
# Adafactor's moments on a grid: each mean over a split dim adds its
# terms in another order (f32, a few ulp of the mean)
FACTORED_RTOL = 1e-6
METRIC_RTOL = {"grad_norm": 1e-4, "default": 1e-5}
MICRO = {"gemma3-1b": {"optimizer": "adamw", "logdet_reg": 0.05,
                       "microbatches": 2},
         "qwen2-moe-a2.7b": {"optimizer": "adamw", "microbatches": 2}}


def _grads(model, seed):
    rng = np.random.default_rng(seed)
    return {n: torch.from_numpy(rng.standard_normal(p.shape).astype(
        np.float32)).to(p.dtype) for n, p in model.named_parameters()}


class Lines:
    """All_sums over the lines of a grid whose ranks run as threads of
    one process: a line's n-th call waits for every rank of the line and
    gives each the sum of their tensors in rank order (the same bits)."""

    def __init__(self):
        self._cv = threading.Condition()
        self._parts = {}

    def sum_for(self, grid):
        calls = collections.Counter()

        def line_sum(ts, axes):
            line = (frozenset(axes), tuple(sorted(
                (a, c) for a, c in grid.coords.items() if a not in axes)))
            calls[line] += 1
            n = math.prod(grid.shape[a] for a in axes)
            with self._cv:
                parts = self._parts.setdefault((line, calls[line]), {})
                parts[grid.rank] = [t.clone() for t in ts]
                self._cv.notify_all()
                self._cv.wait_for(lambda: len(parts) == n, timeout=60)
                assert len(parts) == n, (line, sorted(parts))
                ordered = [parts[r] for r in sorted(parts)]
            out = []
            for i in range(len(ts)):
                acc = ordered[0][i].clone()
                for part in ordered[1:]:
                    acc = acc + part[i]
                out.append(acc)
            return out
        return line_sum


@pytest.mark.parametrize("opt", ["adamw", "adafactor", "sgd"])
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "zamba2-7b"])
def test_a_blocks_update_is_the_whole_updates_block(arch, opt):
    cfg = get_config(arch, smoke=True)
    tcfg = TrainConfig(opt=OptConfig(name=opt, lr=1e-2, warmup=1))
    state = init_train_state(cfg, tcfg, generator=torch.Generator()
                             .manual_seed(0), device="cpu")
    _, update = get_optimizer(tcfg.opt)
    grads = [_grads(state["params"], s) for s in (1, 2)]
    whole = copy.deepcopy(state)
    # each parameter's moves, step by step, summed
    moved = {p: torch.zeros_like(t) for p, t in layout.flat(state).items()}
    for g in grads:
        before = {p: t.detach().clone()
                  for p, t in layout.flat(whole).items()}
        update(g, whole["opt"], whole["params"])
        for p, t in layout.flat(whole).items():
            moved[p] += (t.detach() - before[p]).abs()
    want = {p: t.detach() for p, t in layout.flat(whole).items()}
    lines = Lines()

    def rank(r):
        grid = GridMesh(("data", "model"), (2, 2), rank=r, device="cpu")
        sh = layout.state_shardings(state, cfg, grid, opt)
        mine = layout.shard(copy.deepcopy(state), sh)
        psh = sh["params"]
        summed = lines.sum_for(grid)
        for g in grads:
            blocks = {n: x[layout.block_slices(x.shape, psh[n])]
                      for n, x in g.items()}
            if opt != "adafactor":          # elementwise
                update(blocks, mine["opt"], mine["params"])
                continue
            split = {n: BlockSplit(c.whole, c.dims, summed) for n, c in
                     layout.block_splits(psh, blocks).items()}
            update(blocks, mine["opt"], mine["params"], split=split)
        return grid, sh, mine
    with ThreadPoolExecutor(4) as pool:
        ranks = list(pool.map(rank, range(4)))
    # which JAX leaves an axis splits (their moments' means are summed)
    psh = ranks[0][1]["params"]
    cut = {}
    for leaf in jax_leaves(state["params"]):
        s = psh[leaf.names[0]]
        cut[("opt", "f") + leaf.path] = bool(layout.block_splits(
            {leaf.names[0]: s}, {leaf.names[0]: torch.empty(
                layout.shard_shape(dict(state["params"].named_parameters())[
                    leaf.names[0]].shape, s))})[leaf.names[0]].dims)
        cut.update({("params",) + tuple(n.split(".")): cut[
            ("opt", "f") + leaf.path] for n in leaf.names})
    split, held, worst = 0, {}, 0.0
    for grid, sh, mine in ranks:
        fsh = layout.flat(sh)
        for p, t in layout.flat(mine).items():
            if p[0] == "step":
                continue
            blk = want[p][layout.block_slices(want[p].shape, fsh[p])]
            t = t.detach()
            assert t.shape == blk.shape, p
            held.setdefault((p, str(layout.block_slices(
                want[p].shape, fsh[p]))), set()).add(t.numpy().tobytes())
            summed = opt == "adafactor" and cut.get(p[:-1] if p[0] == "opt"
                                                    else p, False)
            if not summed:
                assert torch.equal(t, blk), (arch, opt, grid.rank, p)
            elif p[0] == "opt":
                torch.testing.assert_close(t, blk, rtol=FACTORED_RTOL,
                                           atol=0)
            else:
                # each side rounds p - lr * step once a step; the steps
                # differ by what their means' order changes
                tol = len(grads) * torch.from_numpy(np.spacing(np.abs(
                    blk.numpy()))) + FACTORED_RTOL * moved[p][
                        layout.block_slices(want[p].shape, fsh[p])]
                assert ((t - blk).abs() <= tol).all(), (
                    arch, grid.rank, p, float((t - blk).abs().max()))
            split += t.shape != want[p].shape
        if opt == "adafactor":
            assert any(fsh[q].spec for q in fsh if q[-1] in ("vr", "vc"))
    assert all(len(v) == 1 for v in held.values())
    assert split > 0


def test_a_ranks_rows_are_its_share_of_every_microbatch():
    grid = GridMesh(("data", "model"), (2, 2), rank=2, device="cpu")
    bsh = {"tokens": Sharding(grid, PartitionSpec("data", None))}
    batch = {"tokens": torch.arange(8)[:, None].repeat(1, 3)}
    rows = layout.batch_rows(batch, bsh, microbatches=2)
    assert rows["tokens"][:, 0].tolist() == [2, 3, 6, 7]
    one = layout.batch_rows(batch, bsh)
    assert torch.equal(one["tokens"], layout.local_block(batch["tokens"],
                                                         bsh["tokens"]))
    with pytest.raises(ValueError):
        layout.batch_rows(batch, bsh, microbatches=3)


@pytest.fixture(scope="module")
def micro():
    cases = {a: (a, *_case(a, kw, batch=8), kw) for a, kw in MICRO.items()}
    threads = torch.get_num_threads()
    try:
        one = split_step(None, "1x1", cases)
    finally:
        torch.set_num_threads(threads)
    grid = run_ranks(split_step, 2, backend="gloo", device="cpu",
                     timeout=600, args=("2x1", cases))
    return one, grid


@pytest.mark.parametrize("arch", list(MICRO))
def test_two_microbatches_on_a_2x1_grid_are_one_ranks(micro, arch):
    one, grid = micro[0][arch], [r[arch] for r in micro[1]]
    gmax = max(float(np.abs(v).max()) for v in one["grads"].values())
    for k, g in grid[0]["grads"].items():
        err = float(np.abs(g - one["grads"][k]).max())
        assert err <= GRAD_TOL * gmax, (arch, k, err, gmax)
    for r in grid:
        assert r["digests"] == grid[0]["digests"]
        for k, v in one["metrics"].items():
            rtol = METRIC_RTOL.get(k, METRIC_RTOL["default"])
            assert abs(r["metrics"][k] - v) <= rtol * abs(v), (arch, k)
        plan = r["plan"]
        assert r["counts"] == {"broadcast": plan["broadcast"],
                               "all_sum": plan["all_sum"]}
    assert one["counts"] == {"broadcast": 0, "all_sum": 0}
    # each microbatch exchanges its statistics -- the nll, the aux's mean
    # and covariance, two a MoE layer and forward (remat runs the forward
    # again) -- and reduces every gradient by one all_sum; then the global
    # norm's and the agreement.  The broadcasts are the parameters'
    # gathers alone.
    n = len(one["grads"])
    assert grid[0]["counts"]["broadcast"] == grid[0]["plan"]["broadcast"]
    per_micro = {"gemma3-1b": 1 + 2, "qwen2-moe-a2.7b": 1 + 2 * 2 * 2}[arch]
    assert grid[0]["counts"]["all_sum"] == 2 * (per_micro + n) + 2
