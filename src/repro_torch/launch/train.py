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
``--mesh`` the run is one rank.  The step on a mesh
(`sharding.layout.mesh_step`) splits the arithmetic over the data axes
and over "model": each rank steps its rows of every global microbatch
on its share of the heads, mlp columns, experts, vocab rows and SSM
heads, the gradients are reduced over the data line, and each rank's
optimizer updates its own blocks.  A rank that waits in a collective
over a line of the grid for longer than ``--collective-timeout``
seconds raises (another rank of the line failed in the step), and the
ranks restart the step together (`ft.run_training`).  `rank_restore`
restores a run's checkpoint onto a grid of another shape (elastic) and
trains on.
"""
from __future__ import annotations

import argparse
import hashlib
import math
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.registry import get_config
from repro_torch.core import mesh as core_mesh
from repro_torch.core.mesh import run_ranks
from repro_torch.data.synthetic import DataConfig, synth_batch
from repro_torch.ft.driver import FTConfig, run_training
from repro_torch.launch.mesh import make_mesh_like, parse_mesh
from repro_torch.optim.optimizers import OptConfig
from repro_torch.sharding import fsdp, hints, layout, tensor
from repro_torch.sharding.rules import Sharding, batch_spec
from repro_torch.train.step import TrainConfig, make_grad_fn

__all__ = ["build", "main", "parser", "rank_main", "rank_restore"]


def build(arch: str, *, smoke: bool, mesh, tcfg: TrainConfig, seed: int = 0,
          batch: int = 8, seq: int = 128, layers: int | None = None,
          dtype=None, on_grads=None, draw: bool = True):
    """-> (cfg, this rank's state, step_fn, batch_fn, state shardings) on
    ``mesh`` (a `launch.mesh.GridMesh`; its device is the rank's).
    ``layers`` cuts the config's depth (a full-width run at reduced
    depth), ``dtype`` sets the activations' (the config's by default);
    ``on_grads`` as in `sharding.layout.mesh_step`.  ``batch_fn(step)``
    gives this rank's rows of the global batch (`layout.batch_rows`).
    The state's shardings come from its shapes alone and the rank builds
    its blocks only (`layout.init_blocks`), drawn from ``seed`` -- or,
    without ``draw``, left uninitialized for a restore to fill."""
    cfg = get_config(arch, smoke=smoke)
    if layers is not None:
        cfg = cfg.replace(n_layers=layers)
    if dtype is not None:
        cfg = cfg.replace(dtype=dtype)
    hints.configure(cfg, mesh)
    data = DataConfig(seed=seed, batch=batch, seq=seq, kind="markov")
    dev = mesh.device
    state_shardings = layout.state_shardings(
        layout.state_shapes(cfg, tcfg), cfg, mesh, tcfg.opt.name)
    gen = torch.Generator(device=dev).manual_seed(seed) if draw else None
    state = layout.init_blocks(cfg, tcfg, state_shardings, generator=gen,
                               device=dev)
    bshard = {k: Sharding(mesh, s) for k, s in
              batch_spec(cfg, mesh, kind="train", batch=batch).items()}
    step_fn = layout.mesh_step(make_grad_fn(cfg, tcfg), tcfg.opt,
                               state_shardings, bshard, on_grads=on_grads)

    def batch_fn(step: int):
        b = synth_batch(cfg, data, step, device=dev)
        return layout.batch_rows(b, bshard, tcfg.microbatches)

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
    ap.add_argument("--collective-timeout", type=float, default=600.0,
                    help="seconds a rank waits in a collective over a "
                         "line of the --mesh grid before it raises")
    return ap


def _tcfg(args) -> TrainConfig:
    return TrainConfig(
        opt=OptConfig(name=args.optimizer, lr=args.lr,
                      decay_steps=max(args.steps, 2)),
        microbatches=args.microbatches,
        logdet_reg=args.logdet_reg,
        grad_compression=args.grad_compression,
    )


def _run(args, mesh, layers=None, dtype=None, on_grads=None):
    """One rank's run -> (state, losses, stats)."""
    return _drive(args, mesh, build(
        args.arch, smoke=args.smoke, mesh=mesh, tcfg=_tcfg(args),
        batch=args.batch, seq=args.seq, layers=layers, dtype=dtype,
        on_grads=on_grads))


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


def _mesh(spec: str, device, timeout=None):
    """The grid of a ``--mesh`` spec (a 1-D spec is a ("rows",) grid);
    ``timeout`` as in `launch.mesh.GridMesh`."""
    return make_mesh_like(spec, device=device, grid=True, timeout=timeout)


def _threads(mesh, threads) -> None:
    """A CPU rank of run_ranks' ``mesh`` takes ``threads`` threads
    (default: the host's cores shared among the ranks)."""
    if mesh is not None and mesh.device.type == "cpu":
        torch.set_num_threads(threads or max(
            1, (os.cpu_count() or 1) // mesh.size))


def _host(t, digest: bool):
    a = t.detach().cpu().numpy()
    if digest:
        return a.shape, hashlib.sha256(np.ascontiguousarray(a).data) \
            .hexdigest()
    return a.copy()


def rank_main(mesh, argv, threads=None, detail=False, layers=None,
              digest=False, dtype=None, after=None):
    """One spawned rank of `main` (``mesh``, run_ranks' 1-D mesh, is
    replaced by the ``--mesh`` grid over the same group) -> its losses,
    restarts and stragglers.  A CPU rank takes ``threads`` threads
    (default: the host's cores shared among the ranks).  With ``detail``
    also its coordinates, step seconds and final blocks (numpy
    arrays by `layout.flat` path joined with dots:
    ``params.blocks.0.attn.wq``, ``opt.m.embed``, ``step``), the first
    step's reduced gradients by parameter name (``grads``: its blocks,
    kept on the host and gathered whole after the run) and metrics
    (``grad_metrics``), the collectives of the run's last step
    (``counts``) beside `layout.step_plan` (``plan``), the high-water of
    whole parameter bytes alive at once in it (``whole_peak_bytes``,
    ``whole_peak_units``: `sharding.fsdp.watching`), the shares of the
    heads, mlp columns, experts, vocab rows and SSM heads it computed
    (``shares``: `sharding.tensor.recording`) and, on a card, its
    peak allocation (``step_peak_bytes``); of its `build`, the
    high-water of whole parameter bytes alive at once
    (``build_whole_peak_bytes``: `sharding.fsdp.watching`) and, on a card,
    the peak allocation at its end (``build_peak_bytes``); with
    ``digest``, (shape, sha256 of the bytes) in place of every array.
    ``layers`` and ``dtype`` as in `build`.  ``after(grid, cfg, state,
    shardings)``, when given, runs on the trained state (this rank's
    blocks) once the run ends, every rank of the grid alike, and its
    result is ``after``'s entry."""
    args = parser().parse_args(argv)
    _threads(mesh, threads)
    grid = _mesh(args.mesh, args.device, args.collective_timeout)
    on_card = grid.device.type == "cuda"
    first, last = {}, {}

    def keep_first(grads, metrics):
        if not first and detail:
            first["grads"] = {k: g.detach().cpu() for k, g in grads.items()}
            first["grad_metrics"] = {k: float(v) for k, v in metrics.items()}
    tcfg = _tcfg(args)
    if on_card:
        torch.cuda.synchronize(grid.device)
        torch.cuda.reset_peak_memory_stats(grid.device)
    with fsdp.watching() as built:
        cfg, state, step_fn, batch_fn, sh = build(
            args.arch, smoke=args.smoke, mesh=grid, tcfg=tcfg,
            batch=args.batch, seq=args.seq, layers=layers, dtype=dtype,
            on_grads=keep_first)
    made = {"build_whole_peak_bytes": built.bytes,
            "build_peak_bytes": torch.cuda.max_memory_allocated(grid.device)
            if on_card else None}

    def measured(state, batch):
        if on_card:
            torch.cuda.synchronize(grid.device)
            torch.cuda.reset_peak_memory_stats(grid.device)
        core_mesh.reset_collective_counts()
        with fsdp.watching() as high, tensor.recording() as shares:
            out = step_fn(state, batch)
        last.update(counts=core_mesh.collective_counts(),
                    step_peak_bytes=torch.cuda.max_memory_allocated(
                        grid.device) if on_card else None,
                    whole_peak_bytes=high.bytes, whole_peak_units=high.units,
                    shares={k: sorted(v, key=str) for k, v in shares.items()},
                    rows=batch)
        return out
    state, losses, stats = _drive(args, grid, (
        cfg, state, measured if detail else step_fn, batch_fn, sh))
    out = {"losses": losses, "restarts": stats.restarts,
           "stragglers": stats.stragglers}
    if after is not None:
        out["after"] = after(grid, cfg, state, sh)
    if not detail:
        return out
    # the first step's gradient blocks gathered whole (every rank of the
    # grid calls this, in one order)
    first["grads"] = {k: _host(layout.gather_leaf(
        g.to(grid.device), sh["params"][k]), digest)
        for k, g in first["grads"].items()}
    bsh = {k: Sharding(grid, s) for k, s in batch_spec(
        cfg, grid, kind="train", batch=args.batch).items()}
    plan = layout.step_plan(cfg, tcfg, sh, bsh, layout.whole_like(
        state["params"], sh["params"]), rows=last.pop("rows"))
    out.update(first)
    out.update(last, **made, coords=grid.coords, device=str(grid.device),
               blocks={".".join(p): _host(t, digest)
                       for p, t in layout.flat(state).items()},
               plan=plan, step_s=stats.times)
    return out


def rank_restore(mesh, argv, spec, ckpt_dir, step, threads=None,
                 dtype=None):
    """One rank of a ``spec`` grid (spawned by run_ranks, whose ``mesh``
    sets the threads as in `rank_main`; None in a process of its own):
    `build`'s state restored from ``ckpt_dir`` at ``step`` onto this
    grid (elastic: each rank reads its blocks), then trained on to
    ``--steps``, its checkpoints in ``--ckpt-dir`` -> its coordinates,
    the step restored (``at``), whether its blocks are bitwise the saved
    files' blocks at its coordinates (``restored_bitwise``), its blocks
    as restored and at the end (``restored``, ``blocks``: numpy by
    `layout.flat` path, as `rank_main` names them) and the losses of the
    steps after the restore."""
    args = parser().parse_args(argv)
    _threads(mesh, threads)
    grid = _mesh(spec, args.device, args.collective_timeout)
    # every leaf is read from the checkpoint: nothing is drawn
    cfg, state, step_fn, batch_fn, sh = build(
        args.arch, smoke=args.smoke, mesh=grid, tcfg=_tcfg(args),
        batch=args.batch, seq=args.seq, dtype=dtype, draw=False)
    state, at = ckpt.restore(ckpt_dir, state, step=step, shardings=sh,
                             device=grid.device)
    saved, fsh = Path(ckpt_dir) / f"step_{step:08d}", layout.flat(sh)
    restored = {".".join(p): _host(t, False)
                for p, t in layout.flat(state).items()}
    same = True
    for p in layout.flat(state):
        whole = np.load(saved / f"{'__'.join(p)}.npy")
        block = whole[layout.block_slices(whole.shape, fsh[p], grid.coords)]
        same = same and restored[".".join(p)].tobytes() == block.tobytes()
    state, losses, _ = _drive(args, grid, (cfg, state, step_fn, batch_fn,
                                           sh))
    return {"coords": grid.coords, "at": at, "restored_bitwise": same,
            "restored": restored, "losses": losses,
            "blocks": {".".join(p): _host(t, False)
                       for p, t in layout.flat(state).items()}}


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
    state, _, _ = _run(args, _mesh(spec, args.device,
                                   args.collective_timeout))
    return state


if __name__ == "__main__":
    main()
