"""Training launcher -- counterpart of `repro.launch.train`:
``python -m repro_torch.launch.train --arch <id> [...]``.

End to end: config -> mesh -> sharded state -> fault-tolerant train loop
(checkpoint/restart, straggler monitor) -> metrics log, on the card
unless ``--device cpu``.

``--mesh AxB`` (or ``PxAxB``) lays the state out on a grid of A·B ranks
by the JAX package's sharding rules (`repro_torch.sharding`).  Called
with no process group, `main` starts the ranks itself
(`core.mesh.run_ranks`): NCCL when there is a card per rank, gloo
otherwise (on the CPU, or several ranks sharing a card).  Each rank
runs the same `build` and loop, and rank 0 prints the log.  With no
``--mesh`` the run is one rank.  The step on a mesh computes the global
program on every rank over the sharded resident state
(`sharding.layout.mesh_step`).
"""
from __future__ import annotations

import argparse
import hashlib
import math
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.registry import get_config
from repro_torch.core import mesh as core_mesh
from repro_torch.core.mesh import run_ranks
from repro_torch.data.synthetic import DataConfig, synth_batch
from repro_torch.ft.driver import FTConfig, run_training
from repro_torch.launch.mesh import make_mesh_like, parse_mesh
from repro_torch.optim.optimizers import OptConfig
from repro_torch.sharding import hints, layout
from repro_torch.sharding.rules import (PartitionSpec, Sharding, batch_spec,
                                        param_shardings)
from repro_torch.train.step import (TrainConfig, init_train_state,
                                    make_train_step)

__all__ = ["build", "main", "parser"]


def build(arch: str, *, smoke: bool, mesh, tcfg: TrainConfig, seed: int = 0,
          batch: int = 8, seq: int = 128, layers: int | None = None):
    """-> (cfg, this rank's state, step_fn, batch_fn, state shardings) on
    ``mesh`` (a `launch.mesh.GridMesh`; its device is the rank's).
    ``layers`` cuts the config's depth (a full-width run at reduced
    depth)."""
    cfg = get_config(arch, smoke=smoke)
    if layers is not None:
        cfg = cfg.replace(n_layers=layers)
    hints.configure(cfg, mesh)
    data = DataConfig(seed=seed, batch=batch, seq=seq, kind="markov")
    dev = mesh.device
    state = init_train_state(cfg, tcfg, generator=torch.Generator(
        device=dev).manual_seed(seed), device=dev)
    state_shardings = {
        "params": param_shardings(state["params"], cfg, mesh),
        "opt": param_shardings(state["opt"], cfg, mesh),
        "step": Sharding(mesh, PartitionSpec()),
    }
    bshard = {k: Sharding(mesh, s) for k, s in
              batch_spec(cfg, mesh, kind="train", batch=batch).items()}
    state = layout.shard(state, state_shardings)
    step_fn = layout.mesh_step(make_train_step(cfg, tcfg), state_shardings,
                               bshard)

    def batch_fn(step: int):
        b = synth_batch(cfg, data, step, device=dev)
        return layout.shard(b, {k: bshard[k] for k in b})

    return cfg, state, step_fn, batch_fn, state_shardings


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")  # validated by registry
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--mesh", default="",
                    help="e.g. 2x2 / 2x2x2; default one rank")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--logdet-reg", type=float, default=0.0)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (default)")
    return ap


def _tcfg(args) -> TrainConfig:
    return TrainConfig(
        opt=OptConfig(name=args.optimizer, lr=args.lr,
                      decay_steps=max(args.steps, 2)),
        microbatches=args.microbatches,
        logdet_reg=args.logdet_reg,
        grad_compression=args.grad_compression,
    )


def _run(args, mesh, layers=None):
    """One rank's run -> (state, losses, stats)."""
    return _drive(args, mesh, build(
        args.arch, smoke=args.smoke, mesh=mesh, tcfg=_tcfg(args),
        batch=args.batch, seq=args.seq, layers=layers))


def _drive(args, mesh, built):
    """The loop of `_run` on `build`'s result."""
    cfg, state, step_fn, batch_fn, shardings = built
    lead = mesh.rank == 0
    losses = []

    def on_metrics(step, m):
        losses.append(float(m["loss"]))
        if lead and step % args.log_every == 0:
            print(f"step {step:5d}  loss {m['loss']:.4f}  "
                  f"nll {m['nll']:.4f}  gnorm {m['grad_norm']:.3f}",
                  flush=True)

    ft = FTConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    t0 = time.time()
    state, stats = run_training(
        state=state, train_step=step_fn, batch_fn=batch_fn,
        n_steps=args.steps, ft=ft, shardings=shardings,
        on_metrics=on_metrics)
    dt = time.time() - t0
    if lead:
        print(f"\n{args.steps} steps in {dt:.1f}s "
              f"({1000 * dt / max(len(stats.times), 1):.0f} ms/step "
              f"median-ish); restarts={stats.restarts} "
              f"stragglers={stats.stragglers[:5]}")
        print(f"loss: first={losses[0]:.4f} last={losses[-1]:.4f}",
              flush=True)
    return state, losses, stats


def _mesh(spec: str, device):
    """The grid of a ``--mesh`` spec (a 1-D spec is a ("rows",) grid)."""
    return make_mesh_like(spec, device=device, grid=True)


def rank_main(mesh, argv, threads=None, detail=False, layers=None,
              digest=False):
    """One spawned rank of `main` (``mesh``, run_ranks' 1-D mesh, is
    replaced by the ``--mesh`` grid over the same group) -> its losses,
    restarts and stragglers.  A CPU rank takes ``threads`` threads
    (default: the host's cores shared among the ranks).  With ``detail``
    also its coordinates, step seconds and final blocks (numpy
    arrays by `layout.flat` path joined with dots:
    ``params.blocks.0.attn.wq``, ``opt.m.embed``, ``step``; with
    ``digest``, (shape, sha256 of the bytes) in their place), then the
    collectives of one more step (``counts``) beside `layout.step_plan`
    (``plan``).  ``layers`` as in `build`."""
    args = parser().parse_args(argv)
    if mesh.device.type == "cpu":
        torch.set_num_threads(threads or max(
            1, (os.cpu_count() or 1) // mesh.size))
    grid = _mesh(args.mesh, args.device)
    built = build(args.arch, smoke=args.smoke, mesh=grid, tcfg=_tcfg(args),
                  batch=args.batch, seq=args.seq, layers=layers)
    state, losses, stats = _drive(args, grid, built)
    out = {"losses": losses, "restarts": stats.restarts,
           "stragglers": stats.stragglers}
    if not detail:
        return out
    blocks = {}
    for p, t in layout.flat(state).items():
        a = t.detach().cpu().numpy()
        blocks[".".join(p)] = (a.shape, hashlib.sha256(
            np.ascontiguousarray(a).data).hexdigest()) if digest else a.copy()
    cfg, _, step_fn, batch_fn, sh = built
    bsh = {k: Sharding(grid, s) for k, s in batch_spec(
        cfg, grid, kind="train", batch=args.batch).items()}
    batch = batch_fn(0)
    core_mesh.reset_collective_counts()
    state, _ = step_fn(state, batch)
    out.update(coords=grid.coords, device=str(grid.device), blocks=blocks,
               counts=core_mesh.collective_counts(),
               plan=layout.step_plan({"state": sh, "batch": bsh},
                                     layout.whole_like(
                                         {"state": state, "batch": batch},
                                         {"state": sh, "batch": bsh})),
               step_s=stats.times)
    return out


def _backend(n: int, device) -> str:
    on_card = device is None or torch.device(device).type == "cuda"
    if on_card and torch.cuda.is_available() \
            and torch.cuda.device_count() >= n:
        return "nccl"
    return "gloo"


def main(argv=None):
    """Returns the state (this process's ranks' blocks); when it starts
    the ranks itself, rank 0's `rank_main` result."""
    args = parser().parse_args(argv)
    spec = args.mesh or "1x1"
    n = math.prod(parse_mesh(spec)[1])
    if n > 1 and not dist.is_initialized():
        argv = sys.argv[1:] if argv is None else list(argv)
        return run_ranks(rank_main, n, backend=_backend(n, args.device),
                         device=args.device, timeout=7 * 86400.0,
                         args=(argv,))[0]
    state, _, _ = _run(args, _mesh(spec, args.device))
    return state


if __name__ == "__main__":
    main()
