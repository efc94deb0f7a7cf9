"""`sharding.layout.init_blocks`: a rank's blocks of a fresh train state,
built without the whole state (`launch.train.build`).

- For every smoke arch of the registry and AdamW, Adafactor and SGD, at
  every rank's coordinates of 1x2, 2x1 and 2x2 ("data", "model") grids
  (a `GridMesh` with coordinates and no process group: the build
  exchanges nothing), the blocks are bitwise
  ``layout.shard(init_train_state(...), shardings)`` of the same seed,
  and the generator's next draw is bitwise the one that follows
  `init_train_state`.  The shardings come from shapes alone
  (`layout.state_shapes`, on the meta device) and equal a built state's.
- At most one whole leaf is alive during the build: the high-water of
  whole bytes (`sharding.fsdp.watching`) is at most the largest
  parameter's bytes, and nothing whole is left once it returns.
- The draws are paired with their parameters by the model's construction
  order, which is not ``named_parameters``' order on any arch.
- `launch.train.rank_restore` draws nothing: it restores a one-rank
  run's checkpoint with `models.common.normal_init` raising, bitwise the
  saved state, and goes on bitwise as the run went on.
"""
from __future__ import annotations

import gc

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.launch import train as T
from repro_torch.launch.mesh import GridMesh
from repro_torch.models import Model
from repro_torch.models import common
from repro_torch.models.common import empty_init
from repro_torch.models.model import init_model
from repro_torch.optim import OptConfig
from repro_torch.sharding import fsdp, layout
from repro_torch.train import TrainConfig, init_train_state

GRIDS = [(1, 2), (2, 1), (2, 2)]
SEED = 3


def _state(cfg, tcfg, gen):
    return init_train_state(cfg, tcfg, generator=gen, device="cpu")


@pytest.mark.parametrize("opt", ["adamw", "adafactor", "sgd"])
@pytest.mark.parametrize("arch", ARCHS)
def test_blocks_are_the_whole_states_blocks(arch, opt):
    cfg = get_config(arch, smoke=True)
    tcfg = TrainConfig(opt=OptConfig(name=opt))
    gen = torch.Generator().manual_seed(SEED)
    whole = _state(cfg, tcfg, gen)
    after = torch.randn(8, generator=gen)
    largest = max(p.numel() * p.element_size()
                  for p in whole["params"].parameters())
    split = 0
    for dims in GRIDS:
        for rank in range(dims[0] * dims[1]):
            grid = GridMesh(("data", "model"), dims, rank=rank, device="cpu")
            sh = layout.state_shardings(layout.state_shapes(cfg, tcfg), cfg,
                                        grid, opt)
            built_sh = layout.state_shardings(whole, cfg, grid, opt)
            assert {p: s.spec for p, s in layout.flat(sh).items()} == {
                p: s.spec for p, s in layout.flat(built_sh).items()}
            want = layout.flat(layout.shard(_state(
                cfg, tcfg, torch.Generator().manual_seed(SEED)), sh))
            gen = torch.Generator().manual_seed(SEED)
            with fsdp.watching() as high:
                got = layout.init_blocks(cfg, tcfg, sh, generator=gen,
                                         device="cpu")
                gc.collect()
                high.look()
                left = sum(n for _, r, n in high._refs if r() is not None)
            assert torch.equal(torch.randn(8, generator=gen), after)
            assert high.bytes <= largest, (dims, rank, high.bytes, largest)
            assert left == 0
            got = layout.flat(got)
            assert set(got) == set(want)
            for k, w in want.items():
                g = got[k].detach()
                assert g.dtype == w.dtype and g.shape == w.shape, k
                assert torch.equal(g, w.detach()), (arch, opt, dims, rank, k)
                split += g.shape != layout.flat(whole)[k].shape
            if dims == (2, 2):
                assert high.bytes > 0
    assert split > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_draws_pair_with_parameters_by_construction_order(arch):
    """The model draws in construction order, which is not
    ``named_parameters``' order: a build that paired the draws with the
    parameters by that order would put one parameter's numbers in
    another's place."""
    cfg = get_config(arch, smoke=True)
    order = layout._draw_order(cfg)
    names = [n for n, _ in Model(cfg, empty_init(torch.device("meta")))
             .named_parameters()]
    assert sorted(order) == sorted(names) and order != names
    # the i-th draw of a seeded init is the parameter named order[i]
    model = init_model(cfg, generator=torch.Generator().manual_seed(SEED),
                       device="cpu")
    gen = torch.Generator().manual_seed(SEED)
    draw = common.normal_init(gen, "cpu")
    made = []

    def init(shape, dtype, scale):
        made.append(draw(shape, dtype, scale))
        return made[-1]
    Model(cfg, init)
    named = dict(model.named_parameters())
    for name, t in zip(order, made):
        assert torch.equal(named[name].detach(), t), (arch, name)


def test_restore_draws_nothing(tmp_path, monkeypatch):
    """A one-rank run's step-1 checkpoint restored by `rank_restore` with
    `normal_init` raising: bitwise the saved leaves, and the step after
    it bitwise the run's."""
    argv = ["--arch", "gemma3-1b", "--steps", "2", "--batch", "2", "--seq",
            "8", "--lr", "3e-3", "--ckpt-every", "1", "--log-every", "100",
            "--device", "cpu", "--optimizer", "adafactor"]
    args = T.parser().parse_args(argv + ["--ckpt-dir", str(tmp_path / "a")])
    _, losses, _ = T._run(args, T._mesh("1x1", "cpu"), dtype=torch.float32)

    def raising(*a, **k):
        raise AssertionError("the restore drew a parameter")
    monkeypatch.setattr(common, "normal_init", raising)
    out = T.rank_restore(None, argv + ["--ckpt-dir", str(tmp_path / "b")],
                         "1x1", str(tmp_path / "a"), 1, dtype=torch.float32)
    assert out["at"] == 1 and out["restored_bitwise"]
    assert out["losses"] == losses[1:]
    saved = {p.stem.replace("__", "."): np.load(p)
             for p in (tmp_path / "a" / "step_00000002").glob("*.npy")}
    assert set(out["blocks"]) == set(saved)
    for k, v in out["blocks"].items():
        assert v.tobytes() == saved[k].tobytes(), k
