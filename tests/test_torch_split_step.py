"""The split mesh step's parts on the CPU, against the port's own
one-rank step (`sharding.layout`, `optim` ``blocks=``).

- The optimizer on blocks, in one process with no ranks: on the
  qwen2.5-3b and zamba2-7b smoke trees laid out on a 2x2 ("data",
  "model") grid by `layout.state_shardings`, each rank's update of its
  blocks (AdamW and SGD from its blocks of the gradient, Adafactor from
  the whole gradient) is bitwise that block of the whole update, over
  two steps; Adafactor's moments are whole on every rank and bitwise the
  whole update's.
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

import copy

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.mesh import run_ranks
from repro_torch.launch.mesh import GridMesh
from repro_torch.optim import OptConfig, get_optimizer
from repro_torch.sharding import layout
from repro_torch.sharding.rules import PartitionSpec, Sharding
from repro_torch.train import TrainConfig, init_train_state

from test_torch_ranks import split_step
from test_torch_split_jax import _case

GRAD_TOL = 1e-5
METRIC_RTOL = {"grad_norm": 1e-4, "default": 1e-5}
MICRO = {"gemma3-1b": {"optimizer": "adamw", "logdet_reg": 0.05,
                       "microbatches": 2},
         "qwen2-moe-a2.7b": {"optimizer": "adamw", "microbatches": 2}}


def _grads(model, seed):
    rng = np.random.default_rng(seed)
    return {n: torch.from_numpy(rng.standard_normal(p.shape).astype(
        np.float32)).to(p.dtype) for n, p in model.named_parameters()}


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
    for g in grads:
        update(g, whole["opt"], whole["params"])
    want = {p: t.detach() for p, t in layout.flat(whole).items()}
    split = 0
    for rank in range(4):
        grid = GridMesh(("data", "model"), (2, 2), rank=rank, device="cpu")
        sh = layout.state_shardings(state, cfg, grid, opt)
        mine = layout.shard(copy.deepcopy(state), sh)
        psh = sh["params"]
        for g in grads:
            cut = {n: layout.block_slices(x.shape, psh[n])
                   for n, x in g.items()}
            if opt in layout.WHOLE_LEAF:
                update(g, mine["opt"], mine["params"], blocks=cut)
            else:
                update({n: x[cut[n]] for n, x in g.items()}, mine["opt"],
                       mine["params"])
        fsh = layout.flat(sh)
        for p, t in layout.flat(mine).items():
            if p[0] == "step":
                continue
            blk = want[p][layout.block_slices(want[p].shape, fsh[p])]
            assert t.shape == blk.shape, p
            assert torch.equal(t.detach(), blk), (arch, opt, rank, p)
            split += t.shape != want[p].shape
        if opt == "adafactor":
            assert all(s == Sharding(grid, PartitionSpec())
                       for s in layout.flat(sh["opt"]).values())
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
