"""The ranks of the port's mesh, on the CPU, and what they run.

`repro_torch.core.mesh.run_ranks` spawns one process per rank and pickles
the function it runs by name, so the functions that tests/test_torch_mesh.py
and tests/test_torch_gpu.py run on their ranks live here, in a module the
ranks can import without importing JAX.  Each takes the rank's mesh and
numpy inputs and returns plain Python values.

The tests here: `run_ranks` reports a failing or hanging rank and stops
every process, `make_mesh` and `rank_device` resolve devices as
documented, and several processes that build the same kernel hash at
once (`kernels._build.ensure_built`, with a stand-in for nvcc) leave one
complete build and no debris.
"""
from __future__ import annotations

import os
import stat
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import estimators as est
from repro_torch.core.api import pad_to_multiple
from repro_torch.core import mesh as M
from repro_torch.core.engine import EngineConfig, build_mesh
from repro_torch.core.gaussian import parallel_slogdet_ge
from repro_torch.core.plan import clear_plan_cache
from repro_torch.core.scalapack import parallel_slogdet_lu
from repro_torch.kernels import _build, ops

PANEL_K = 8
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _pair(res):
    sign, logabsdet = res
    return float(sign), float(logabsdet)


def exact_routes(mesh, cases: dict, bf16_case: str = None) -> dict:
    """``{"case|dtype|update|la": (sign, logabsdet)}`` of the mesh engine
    (f64 for every case, f32 for every case but near_singular), each
    matrix padded to a multiple of the mesh size; with ``bf16_case`` also
    ``"case|float32|update|la|bf16"``, that case's f32 routes with bf16
    operands."""
    torch.set_num_threads(1)
    out = {}
    for case, a in cases.items():
        for dname, dt in DTYPES.items():
            if dname == "float32" and case == "near_singular":
                continue
            at = pad_to_multiple(torch.from_numpy(a).to(dt), mesh.size)
            precisions = [None]
            if case == bf16_case and dname == "float32":
                precisions.append("bf16")
            for update in ("rank1", "panel"):
                for la in (False, True):
                    for prec in precisions:
                        cfg = EngineConfig(schedule="mesh", update=update,
                                           panel_k=PANEL_K, lookahead=la,
                                           precision=prec)
                        key = f"{case}|{dname}|{update}|{int(la)}" + (
                            f"|{prec}" if prec else "")
                        out[key] = _pair(build_mesh(cfg, mesh)(at))
    return out


def sharded(mesh, a: np.ndarray, probes: np.ndarray, bounds, v: np.ndarray,
            degree: int, num_steps: int) -> dict:
    """A `ShardedOperator` of ``a``: its products against ``v``, diagonal,
    trace and dense form; Chebyshev and SLQ on ``probes`` (Chebyshev on
    ``bounds``); a CG solve against ``v``."""
    torch.set_num_threads(1)
    at = torch.from_numpy(a)
    op = est.ShardedOperator(at, mesh)
    vt = torch.from_numpy(v)
    pt = torch.from_numpy(probes)
    cheb = est.logdet_chebyshev(op, probes=pt, lmin=bounds[0],
                                lmax=bounds[1], degree=degree, device="cpu")
    slq = est.logdet_slq(op, probes=pt, num_steps=num_steps, device="cpu")
    cg = est.cg_solve(op, vt, tol=1e-12, device="cpu")
    return {"mm": op.mm(vt).numpy(), "mv": op.mv(vt[:, 0]).numpy(),
            "rmm": op.rmm(vt).numpy(), "diag": op.diag().numpy(),
            "trace": float(op.trace_hint()), "dense": op.to_dense().numpy(),
            "hints": tuple(op.plan_hints()),
            "local_rows": op.local.shape[0],
            "cheb": (float(cheb.est), float(cheb.sem)),
            "slq": (float(slq.est), float(slq.sem)),
            "cg_x": cg.x.numpy(), "cg_iters": cg.iters,
            "cg_converged": bool(cg.converged)}


def plans(mesh, a_exact: np.ndarray, a_spd: np.ndarray,
          probes: np.ndarray, bounds) -> dict:
    """`repro_torch.plan` with a mesh: the resolved schedule, padding,
    device count and results of exact and estimator plans (``probes`` has
    at least the padded side's rows), and the rejections that depend on
    the mesh."""
    torch.set_num_threads(1)
    clear_plan_cache()
    out = {}
    for update in ("rank1", "panel"):
        p = repro_torch.plan(a_exact, method="exact", update=update,
                             k=PANEL_K, mesh=mesh)
        res = p()
        out[f"exact|{update}"] = (p.config.schedule, p.diagnostics.padded_n,
                                  p.diagnostics.device_count,
                                  _pair(res), str(res.sign.device))
    p = repro_torch.plan(a_exact, method="exact", schedule="staged",
                         mesh=mesh)
    out["exact|staged"] = (p.config.schedule, p.diagnostics.device_count,
                           _pair(p()))
    padded = -(-a_spd.shape[0] // mesh.size) * mesh.size
    for method, kw in (("chebyshev", dict(degree=16, lmin=bounds[0],
                                          lmax=bounds[1])),
                       ("slq", dict(num_steps=12))):
        p = repro_torch.plan(a_spd, method=method, num_probes=probes.shape[1],
                             mesh=mesh, **kw)
        res = p(probes=torch.from_numpy(probes[:padded]))
        out[method] = (p.diagnostics.padded_n, p.diagnostics.device_count,
                       float(res.logabsdet), float(res.sem))
    p = repro_torch.plan(a_spd, method="chebyshev", degree=16, num_probes=4,
                         seed=3, mesh=mesh)
    out["chebyshev|seeded"] = float(p().logabsdet)
    rejected = {}
    for name, kw in (("fused", dict(method="exact", fused=True)),
                     ("batched", dict(method="exact")),
                     ("operator", dict(method="slq"))):
        x = {"batched": np.zeros((2, 4, 4)),
             "operator": est.DenseOperator(torch.eye(4))}.get(name, a_exact)
        try:
            repro_torch.plan(x, mesh=mesh, **kw)
            rejected[name] = None
        except (TypeError, ValueError) as e:
            rejected[name] = type(e).__name__
    out["rejected"] = rejected
    return out


def grad_routes(mesh, a: np.ndarray, spd: np.ndarray, probes: np.ndarray,
                bounds, nbs) -> dict:
    """Gradients on the mesh, f64.  ``"exact|update|la"``, ``"pge"`` and
    ``"plu<nb>"`` on ``a``: ``(logabsdet, autograd grad, grad_fn name,
    value_and_grad logabsdet, value_and_grad grad)``; ``"chebyshev"`` and
    ``"slq"`` on ``spd``: ``(logabsdet, autograd grad)`` on ``probes``
    (Chebyshev on ``bounds``), then ``value_and_grad``'s ``(logabsdet,
    grad, cg_iters)`` and ``__call__``'s logabsdet at one seed."""
    torch.set_num_threads(1)
    clear_plan_cache()
    out = {}
    routes = [(f"exact|{u}|{int(la)}",
               dict(method="exact", update=u, k=PANEL_K, lookahead=la))
              for u in ("rank1", "panel") for la in (False, True)]
    routes += [("pge", dict(method="pge"))]
    routes += [(f"plu{nb}", dict(method="plu", nb=nb)) for nb in nbs]
    for name, kw in routes:
        x = torch.from_numpy(a).requires_grad_()
        p = repro_torch.plan(a, mesh=mesh, **kw)
        ld = p.logdet(x)
        ld.backward()
        res, g = p.value_and_grad()
        out[name] = (float(ld.detach()), x.grad.numpy(), ld.grad_fn.name(),
                     float(res.logabsdet), g.numpy())
    for method, kw in (("chebyshev", dict(degree=16, lmin=bounds[0],
                                          lmax=bounds[1])),
                       ("slq", dict(num_steps=12))):
        x = torch.from_numpy(spd).requires_grad_()
        p = repro_torch.plan(spd, method=method, num_probes=probes.shape[1],
                             mesh=mesh, **kw)
        padded = p.diagnostics.padded_n
        ld = p.logdet(x, probes=torch.from_numpy(probes[:padded]))
        ld.backward()
        res, g = p.value_and_grad(generator=torch.Generator().manual_seed(7))
        call = p(generator=torch.Generator().manual_seed(7))
        out[method] = (float(ld.detach()), x.grad.numpy(),
                       float(res.logabsdet),
                       g.numpy(), res.diagnostics.cg_iters,
                       float(call.logabsdet))
    return out


def everything(mesh, payload: dict) -> dict:
    """One spawn per mesh size: the parts ``payload`` names."""
    out = {"exact": exact_routes(mesh, payload["cases"],
                                 payload.get("bf16_case"))}
    if "nan" in payload:
        out["nan"] = exact_routes(mesh, payload["nan"])
    if "sharded" in payload:
        out["sharded"] = sharded(mesh, **payload["sharded"])
    if "plans" in payload:
        out["plans"] = plans(mesh, **payload["plans"])
    return out


def _counting(names):
    """Wrap the `ops` entry points ``names`` to count their calls (on the
    CPU no kernel launches, so the launch counters stay at 0); returns the
    counter and a function that restores them."""
    calls = dict.fromkeys(names, 0)
    saved = {name: getattr(ops, name) for name in names}

    def wrap(name):
        def call(*args, **kwargs):
            calls[name] += 1
            return saved[name](*args, **kwargs)
        return call

    for name in names:
        setattr(ops, name, wrap(name))

    def restore():
        for name, fn in saved.items():
            setattr(ops, name, fn)

    return calls, restore


def baseline_routes(mesh, cases: dict, pad_to: int, nbs,
                    pge_only: dict = None) -> dict:
    """``{"case|dtype|method": (sign, logabsdet, calls, collectives)}``:
    parallel GE (method "pge") and blocked LU ("plu<nb>") on every case
    padded with diag(A, I) to ``pad_to`` rows, in f64 and (but for
    near_singular) f32, with the calls of `ops.rank1_update` /
    `ops.panel_update` and the collectives of each call; ``pge_only``
    ``{name: (a, pad)}`` runs pge alone, f64, on ``a`` padded to ``pad``
    (``"name|pge"``); plus the plans ``plan(method="pge"|"plu")`` on the
    unpadded first case."""
    torch.set_num_threads(1)
    out = {}
    calls, restore = _counting(("rank1_update", "panel_update"))
    routes = {"pge": parallel_slogdet_ge(mesh),
              **{f"plu{nb}": parallel_slogdet_lu(mesh, nb=nb) for nb in nbs}}
    try:
        for case, a in cases.items():
            for dname, dt in DTYPES.items():
                if dname == "float32" and case == "near_singular":
                    continue
                at = pad_to_multiple(torch.from_numpy(a).to(dt), pad_to)
                for name, fn in routes.items():
                    for key in calls:
                        calls[key] = 0
                    M.reset_collective_counts()
                    res = fn(at)
                    out[f"{case}|{dname}|{name}"] = (
                        *_pair(res), dict(calls), M.collective_counts())
        for name, (a, pad) in (pge_only or {}).items():
            at = pad_to_multiple(torch.from_numpy(a), pad)
            out[f"{name}|pge"] = _pair(routes["pge"](at))
    finally:
        restore()
    case, a = next(iter(cases.items()))
    for method, kw in (("pge", {}), ("plu", {"nb": nbs[-1]})):
        p = repro_torch.plan(a, method=method, mesh=mesh, **kw)
        out[f"plan|{method}"] = (_pair(p()), p.diagnostics.padded_n,
                                 p.diagnostics.device_count)
    return out


def card_baselines(mesh, a: np.ndarray, nbs) -> dict:
    """On the card: pge and plu (each ``nbs``) with their launch counts and
    collectives."""
    at = torch.from_numpy(a).to(mesh.device)
    out = {}
    for name, fn in (("pge", parallel_slogdet_ge(mesh)),
                     *((f"plu{nb}", parallel_slogdet_lu(mesh, nb=nb))
                       for nb in nbs)):
        ops.reset_launch_counts()
        M.reset_collective_counts()
        res = fn(at)
        out[name] = (_pair(res), ops.launch_counts(), M.collective_counts())
    return out


def obs_mesh_names(mesh, a: np.ndarray, k: int) -> dict:
    """``{"update|lookahead": (stage names, metric names)}`` the port's
    obs records in trace mode on each exact mesh route (tests/
    test_torch_obs.py), then the same routes' results under obs off,
    metrics and trace (``"update|lookahead|mode"``), for the bitwise
    check."""
    from repro_torch import obs
    x = torch.from_numpy(a)
    out = {}
    try:
        for update in ("rank1", "panel"):
            for la in (False, True):
                route = f"{update}|{la}"
                for mode in ("off", "metrics", "trace"):
                    obs.reset()
                    obs.configure(mode)
                    clear_plan_cache()
                    res = repro_torch.plan(x, method="exact", mesh=mesh,
                                           update=update, k=k,
                                           lookahead=la)()
                    out[f"{route}|{mode}"] = _pair(res)
                names = sorted({e["name"] for e in obs.events()})
                metrics = sorted({key.split("{")[0]
                                  for group in obs.snapshot().values()
                                  for key in group})
                out[route] = (names, metrics)
    finally:
        obs.reset()
        obs.configure("off")
    return out


def legacy_mesh_routes(mesh, cases: dict) -> dict:
    """``{"case|dtype|method": (sign, logabsdet, same_bits)}`` for the
    legacy mesh route strings ``pmc`` / ``pmc_blocked``, through the plan
    and through the deprecated `core.api.slogdet` shim (``"|shim"``), each
    against its ``method="exact"`` mesh plan bit for bit (f64 for every
    case, f32 for every case but near_singular, each matrix padded to a
    multiple of the mesh size by the plan)."""
    import warnings
    from repro_torch.core.api import slogdet as api_slogdet
    torch.set_num_threads(1)
    clear_plan_cache()
    out = {}
    for case, a in cases.items():
        for dname, dt in DTYPES.items():
            if dname == "float32" and case == "near_singular":
                continue
            at = torch.from_numpy(a).to(dt)
            for method, update in (("pmc", "rank1"),
                                   ("pmc_blocked", "panel")):
                want = repro_torch.plan(at, method="exact", update=update,
                                        k=PANEL_K, mesh=mesh)()
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore", DeprecationWarning)
                    got = repro_torch.plan(at, method=method, k=PANEL_K,
                                           mesh=mesh)()
                    shim = api_slogdet(at, method=method, mesh=mesh,
                                       k=PANEL_K)
                for tag, (s, ld) in (("", (got.sign, got.logabsdet)),
                                     ("|shim", shim)):
                    same = bool(torch.equal(s, want.sign)
                                and torch.equal(ld, want.logabsdet))
                    out[f"{case}|{dname}|{method}{tag}"] = (
                        float(s), float(ld), same)
    return out


def planted_collective(mesh, n: int) -> tuple:
    """collective-payload-budget on this rank's recordings of an exact
    mesh plan (rank1 and panel, f32; clean) and of a broadcast of 2 N P
    floats (a planted fault); returns the reports' JSON and the clean
    recordings' collective opcodes, counts and wire bytes."""
    from repro_torch.analysis import (AuditContext, collective_bytes,
                                      record, run_passes)
    torch.set_num_threads(1)
    a = torch.eye(n, dtype=torch.float32) * 2.0
    out, ops_seen = {}, {}
    for update in ("rank1", "panel"):
        ctx = AuditContext(label=f"mesh|{update}", method="exact",
                           schedule="mesh", update=update, panel_k=PANEL_K,
                           n=n, devices=mesh.size, itemsize=4,
                           dtype="float32")
        plan = repro_torch.plan(a, method="exact", update=update, k=PANEL_K,
                                mesh=mesh)
        mod = record(plan, a)
        ops_seen[update] = sorted({i.opcode for i in mod.collectives()})
        stats = collective_bytes(mod)
        ops_seen[f"{update}|bytes"] = (stats.counts, stats.wire_bytes)
        out[update] = run_passes(mod, ctx,
                                 ("collective-payload-budget",)).to_json()
    leak = torch.zeros(2 * n * mesh.size, dtype=torch.float32)
    mod = record(M.broadcast, mesh, leak, 0)
    ctx = AuditContext(label="mesh|rank1", method="exact", schedule="mesh",
                       update="rank1", n=n, devices=mesh.size, itemsize=4,
                       dtype="float32")
    out["planted"] = run_passes(mod, ctx,
                                ("collective-payload-budget",)).to_json()
    return out, ops_seen


def grid_on_mesh(mesh, n: int) -> str:
    """`analysis.audit_grid` on the caller's mesh (nothing spawned):
    this rank's report as JSON."""
    from repro_torch.analysis import audit_grid
    torch.set_num_threads(1)
    return audit_grid(n=n, mesh=mesh).to_json()


def fail_on_rank(mesh, bad: int):
    """Rank ``bad`` raises; the others wait for it in a collective."""
    if mesh.rank == bad:
        raise ValueError(f"planted failure on rank {bad}")
    torch.distributed.barrier()


def hang(mesh, seconds: float):
    """Every rank sleeps past the caller's timeout."""
    time.sleep(seconds)


def build_race(root: str, fake_nvcc: str) -> bool:
    """`_build.ensure_built` of one kernel hash under ``root`` with
    ``fake_nvcc`` standing in for nvcc; returns whether it found the
    build done (by another process)."""
    _build._nvcc = lambda: fake_nvcc
    return _build.ensure_built(Path(root) / "hash")


def mesh_launches(L: int, P: int, rank: int, k: int, update: str,
                  lookahead: bool) -> dict:
    """The kernel launches of one mesh route on rank ``rank``, L rows per
    rank: rank-1 steps (L - 1) P plus the P x P tail's P - 1; panels R =
    (L - 1) // k per rank (K4 on the owner, K2 on every rank) and the
    rank-1 remainder; lookahead early-applies every step (K1) or panel
    (K2) after the first that the rank owns."""
    counts = dict.fromkeys(("rank1_update", "panel_update", "fused_step",
                            "panel_factor", "matvec", "cheb_step",
                            "cg_step", "stencil_mv"), 0)
    early = (L - 1 if update == "rank1" else (L - 1) // k) - (rank == 0)
    if update == "rank1":
        counts["rank1_update"] = (L - 1) * P + P - 1 + lookahead * early
    else:
        r = (L - 1) // k
        counts["panel_factor"] = r
        counts["panel_update"] = r * P + lookahead * early
        counts["rank1_update"] = ((L - 1) - r * k) * P + P - 1
    return counts


def card_routes(mesh, a: np.ndarray, k: int, degree: int) -> dict:
    """On the card: the four mesh routes with their launch counts, and a
    sharded Chebyshev estimate with its K5 count."""
    from repro_torch.kernels import ops
    at = torch.from_numpy(a).to(mesh.device)
    out = {}
    for update in ("rank1", "panel"):
        for la in (False, True):
            cfg = EngineConfig(schedule="mesh", update=update, panel_k=k,
                               lookahead=la)
            ops.reset_launch_counts()
            res = build_mesh(cfg, mesh)(at)
            out[f"{update}|{int(la)}"] = (_pair(res), ops.launch_counts())
    op = est.ShardedOperator(at, mesh)
    ops.reset_launch_counts()
    res = est.logdet_chebyshev(op, degree=degree, num_probes=8, seed=1,
                               device=mesh.device)
    out["chebyshev"] = (float(res.est), ops.launch_counts())
    return out


# ------------------------------------------------------------------ tests

FAKE_NVCC = """#!{python}
import random, sys, time
out = sys.argv[sys.argv.index("-o") + 1]
time.sleep(random.uniform(0.0, 0.3))
with open(out, "w") as f:
    f.write("not a library")
print("ptxas info    : Used 10 registers, 0 bytes smem")
"""


def test_run_ranks_reports_the_failing_rank():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="planted failure on rank 1"):
        M.run_ranks(fail_on_rank, 3, backend="gloo", device="cpu",
                    timeout=120, args=(1,))
    assert time.monotonic() - t0 < 100


def test_run_ranks_times_out_and_stops_the_ranks():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="unfinished"):
        M.run_ranks(hang, 2, backend="gloo", device="cpu", timeout=8,
                    args=(300.0,))
    assert time.monotonic() - t0 < 60


def test_mesh_devices_and_helpers_without_a_group():
    assert M.rank_device(3, "cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported"):
        M.rank_device(0, "meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            M.rank_device(0, None)
    if not torch.distributed.is_initialized():
        with pytest.raises(RuntimeError, match="init_process_group"):
            M.make_mesh(device="cpu")
    mesh = M.Mesh(group=None, size=4, rank=2, device=torch.device("cpu"))
    assert mesh.block(12) == slice(6, 9)
    with pytest.raises(ValueError, match="divisible"):
        mesh.block(10)


def test_concurrent_builds_of_one_hash(tmp_path):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    root = tmp_path / "build"
    ctx = torch.multiprocessing.get_context("spawn")
    with ctx.Pool(4) as pool:
        found = pool.starmap(build_race, [(str(root), str(nvcc))] * 4,
                             chunksize=1)
    out = root / "hash"
    assert found.count(False) >= 1, found     # somebody built it
    assert sorted(os.listdir(root)) == ["hash"]  # no temporary debris
    for name in _build.SOURCES:
        assert (out / f"lib{name}.so").read_text() == "not a library"
        assert "Used 10 registers" in (out / f"{name}.ptxas.txt").read_text()
    assert float((out / "build_seconds.txt").read_text()) >= 0
    assert _build.ensure_built(out) is True   # a later load finds it done


# --------------------------------------------------------------------------
# repro_torch.launch.train on a grid of gloo ranks (tests/test_torch_launch_mesh.py)
# --------------------------------------------------------------------------

# tests/test_torch_launch_faults.py's run (on the CPU; the card test
# swaps the device): step -> (where, ranks), before the first checkpoint
# on every rank, after it inside the step's compute on rank 2 (in the
# backward, at a unit's gradient reduction: rank 0, on its data line,
# waits in that reduction until the collective timeout), then before the
# step on rank 1
FAULT_ARGV = ["--arch", "gemma3-1b", "--steps", "12", "--batch", "4",
              "--seq", "32", "--lr", "3e-3", "--ckpt-every", "5",
              "--device", "cpu", "--collective-timeout", "20"]
FAULTS = {3: ("driver", (0, 1, 2, 3)), 6: ("step", (2,)),
          8: ("driver", (1,))}


def launch_faults(mesh, argv: list, faults: dict, ckpt_dir: str) -> dict:
    """One rank of `launch.train.build`'s run through `ft.run_training`
    with faults: ``faults[step]`` is ``(where, ranks)``, ``where``
    "driver" (raised by the fault injector before the step) or "step"
    (raised inside the step's compute, in the backward, at the first
    unit's gradient reduction, `sharding.fsdp.reduce`: the other ranks
    of its data line wait in that reduction), on the listed ranks of the
    grid.  -> its coordinates, restarts and final blocks."""
    torch.set_num_threads(1)
    from repro_torch.ft.driver import FTConfig, run_training
    from repro_torch.launch import train as T
    from repro_torch.sharding import fsdp, layout
    args = T.parser().parse_args(argv)
    grid = T._mesh(args.mesh, args.device, args.collective_timeout)
    reduce = fsdp.reduce
    fired, at = set(), {}

    def fault(where, step):
        plan = faults.get(step)
        if plan and plan[0] == where and grid.rank in plan[1] \
                and step not in fired:
            fired.add(step)
            raise RuntimeError(f"injected {where} fault at step {step}")

    def driver(step):
        at["step"] = step
        fault("driver", step)

    def faulty_reduce(unit, grads, blocks):
        fault("step", at["step"])
        return reduce(unit, grads, blocks)
    _, state, step_fn, batch_fn, sh = T.build(
        args.arch, smoke=args.smoke, mesh=grid, tcfg=T._tcfg(args),
        batch=args.batch, seq=args.seq)
    fsdp.reduce = faulty_reduce
    state, stats = run_training(
        state=state, train_step=step_fn, batch_fn=batch_fn,
        n_steps=args.steps, shardings=sh, fault_injector=driver,
        ft=FTConfig(ckpt_dir=ckpt_dir, ckpt_every=args.ckpt_every))
    fsdp.reduce = reduce
    return {"coords": grid.coords, "restarts": stats.restarts,
            "fired": sorted(fired),
            "blocks": {".".join(p): t.detach().cpu().numpy().copy()
                       for p, t in layout.flat(state).items()}}


def split_step(mesh, spec: str, cases: dict) -> dict:
    """One rank of a ``spec`` grid ("2x2", "2x1", "1x2", ...) taking one
    split mesh step (`sharding.layout.mesh_step`) per case.  ``cases``
    maps a name to (arch, a JAX train state's numpy tree or an int seed
    of the port's own `init_train_state`, a numpy global batch,
    `TrainConfig` keywords with ``optimizer`` and, optionally, the
    config's ``remat``, ``vocab``, ``n_layers``, ``param_dtype`` or
    ``n_experts``): the
    smoke config at f32 activations, the state carried across
    (`from_jax_train_state`) and laid out by `layout.state_shardings`,
    the step on this rank's rows (`layout.batch_rows`).  -> {name: its coordinates, the reduced
    gradients before the clip, gathered whole after the step (numpy on
    data rank 0 of model column 0, else None), their sha256 digests, the
    digests of this rank's blocks of them (``grad_blocks``), the step's
    metrics, its collectives and `layout.step_plan`, the shares of the
    heads, mlp columns, experts and vocab rows it computed
    (`sharding.tensor.recording`), and the sha256 of every block after
    it}."""
    import hashlib
    torch.set_num_threads(1)
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh_like
    from repro_torch.models.convert import from_jax_train_state
    from repro_torch.optim import OptConfig
    from repro_torch.sharding import layout, tensor
    from repro_torch.sharding.rules import Sharding, batch_spec
    from repro_torch.train import TrainConfig, init_train_state, make_grad_fn
    grid = make_mesh_like(spec, device="cpu", grid=True)

    def digest(t):
        return hashlib.sha256(np.ascontiguousarray(
            t.detach().numpy()).data).hexdigest()
    out = {}
    for name, (arch, np_state, batch, kw) in cases.items():
        kw = dict(kw)
        over = {k: kw.pop(k) for k in ("remat", "vocab", "n_layers",
                                       "param_dtype", "n_experts")
                if k in kw}
        tcfg = TrainConfig(opt=OptConfig(name=kw.pop("optimizer")), **kw)
        cfg = get_config(arch, smoke=True).replace(dtype=torch.float32,
                                                   **over)
        if isinstance(np_state, int):
            state = init_train_state(cfg, tcfg, generator=torch.Generator()
                                     .manual_seed(np_state), device="cpu")
        else:
            state = from_jax_train_state(np_state, cfg, tcfg, device="cpu")
        sh = layout.state_shardings(state, cfg, grid, tcfg.opt.name)
        state = layout.shard(state, sh)
        b = next(iter(batch.values())).shape[0]
        bsh = {k: Sharding(grid, s) for k, s in batch_spec(
            cfg, grid, kind="train", batch=b).items()}
        seen = {}
        step = layout.mesh_step(make_grad_fn(cfg, tcfg), tcfg.opt, sh, bsh,
                                on_grads=lambda g, m: seen.update(g=g))
        rows = layout.batch_rows({k: torch.from_numpy(v)
                                  for k, v in batch.items()}, bsh,
                                 tcfg.microbatches)
        M.reset_collective_counts()
        with tensor.recording() as shares:
            state, metrics = step(state, rows)
        counts = M.collective_counts()
        whole = {k: layout.gather_leaf(g, sh["params"][k])
                 for k, g in seen["g"].items()}
        lead = all(v == 0 for v in grid.coords.values())
        out[name] = {
            "coords": grid.coords,
            "grads": {k: g.numpy().copy() for k, g in whole.items()}
            if lead else None,
            "digests": {k: digest(g) for k, g in whole.items()},
            "grad_blocks": {k: digest(g) for k, g in seen["g"].items()},
            "metrics": {k: float(v) for k, v in metrics.items()},
            "counts": counts,
            "shares": {k: sorted(v, key=str) for k, v in shares.items()},
            "plan": layout.step_plan(
                cfg, tcfg, sh, bsh,
                layout.whole_like(state["params"], sh["params"]),
                rows=rows),
            "blocks": {".".join(p): digest(t)
                       for p, t in layout.flat(state).items()}}
    return out


def mutated_split_step(mesh, spec: str, cases: dict, mutation: str) -> dict:
    """`split_step` with one fault planted in the model split
    (tests/test_torch_model_split.py shows that its gates catch each):

    - ``partial_unsummed``: an attention's k / v projection left whole
      while its q heads split is reduced over the data line only, so each
      rank keeps its part of the gradient;
    - ``partial_twice``: that gradient summed over the model line once
      more after its reduction;
    - ``to_model_unsummed``: a column-parallel input's gradient not
      summed over the model line in the backward;
    - ``lse_per_rank``: the vocab-parallel cross-entropy's log-sum-exp
      from this rank's logits alone (the target logit still exchanged)."""
    from repro_torch.core import mesh as core_mesh
    from repro_torch.sharding import fsdp, tensor
    if mutation == "partial_unsummed":
        real_modes = tensor.leaf_modes

        def modes(shardings):
            return {k: tensor.FULL if v == tensor.PARTIAL else v
                    for k, v in real_modes(shardings).items()}
        tensor.leaf_modes = modes
    elif mutation == "partial_twice":
        real_reduce = fsdp.reduce

        def reduce(unit, grads, blocks):
            out = real_reduce(unit, grads, blocks)
            line = tensor.current().line
            if line is None:        # shape only (`layout.step_plan`)
                return out
            return [core_mesh.all_sum(line, g.clone())
                    if unit.plan.modes[n] == tensor.PARTIAL else g
                    for n, g in zip(unit.names, out)]
        fsdp.reduce = reduce
    elif mutation == "to_model_unsummed":
        tensor._ToModel.backward = staticmethod(lambda ctx, g: (g, None))
    elif mutation == "lse_per_rank":
        real_each = tensor.each

        def each(t):
            out = real_each(t)
            if t.dim() >= 1 and t.shape[0] == 3:     # the CE's exchange
                out[:, 0] = t[0]
                out[:, 1] = 0
                out[tensor.current().rank, 1] = t[1]
            return out
        tensor.each = each
    else:
        raise ValueError(mutation)
    return split_step(mesh, spec, cases)


# --------------------------------------------------------------------------
# the unit-by-unit gather's memory (tests/test_torch_layer_gather_memory.py)
# --------------------------------------------------------------------------

def layer_gather_memory(mesh, spec: str, runs: list) -> list:
    """One rank of a ``spec`` grid taking one mesh step (`layout
    .mesh_step`, AdamW, the logdet aux) per run of ``runs`` ((arch,
    n_layers, remat, the activations' dtype name), the smoke config from
    seed 0),
    watched by weak references of this function's own: it wraps
    `sharding.fsdp.gather` to hold a weak reference to every whole it
    makes, and `sharding.fsdp.reduce` to hold one to every whole
    gradient of a split leaf it is handed; at every gather and every
    reduction it looks at what is alive.  -> per run: the most layer
    units with a whole alive at once (``units``), whether a root whole
    was alive there (``root``), the most whole bytes alive at once
    (``bytes``), the whole gradients found alive after their unit's
    reduction returned (``grads_after``) and after the step
    (``grads_at_end``), the gathers made, and the step's loss."""
    import weakref
    torch.set_num_threads(1)
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh_like
    from repro_torch.optim import OptConfig
    from repro_torch.sharding import fsdp, layout
    from repro_torch.sharding.rules import Sharding, batch_spec
    from repro_torch.train import TrainConfig, init_train_state, make_grad_fn
    grid = make_mesh_like(spec, device="cpu", grid=True)
    real_gather, real_reduce = fsdp.gather, fsdp.reduce
    out = []
    for arch, layers, remat, dtype in runs:
        wholes, grads, seen = [], [], {"units": 0, "root": False,
                                       "bytes": 0, "grads_after": 0,
                                       "gathers": 0}

        def look():
            live = [(u, n) for u, r, n in wholes if r() is not None]
            seen["units"] = max(seen["units"], len({u for u, _ in live
                                                    if u != ""}))
            seen["root"] = seen["root"] or any(u == "" for u, _ in live)
            seen["bytes"] = max(seen["bytes"], sum(n for _, n in live))
            seen["grads_after"] += sum(r() is not None and done
                                       for r, done in grads)

        def gather(unit, blocks):
            got = real_gather(unit, blocks)
            seen["gathers"] += 1
            for w, b in zip(got, blocks):
                if w is not b:
                    wholes.append((unit.name, weakref.ref(w),
                                   w.numel() * w.element_size()))
            look()
            return got

        def reduce(unit, gs, blocks):
            look()
            mine = [[weakref.ref(g), False] for g, b in zip(gs, blocks)
                    if g is not None and g.numel() > b.numel()]
            got = real_reduce(unit, gs, blocks)
            grads.extend(mine)
            for m in mine:
                m[1] = True
            return got

        tcfg = TrainConfig(opt=OptConfig(name="adamw"), logdet_reg=0.05)
        cfg = get_config(arch, smoke=True).replace(
            dtype=getattr(torch, dtype), n_layers=layers, remat=remat)
        state = init_train_state(cfg, tcfg, generator=torch.Generator()
                                 .manual_seed(0), device="cpu")
        sh = layout.state_shardings(state, cfg, grid, "adamw")
        state = layout.shard(state, sh)
        bsh = {k: Sharding(grid, s) for k, s in batch_spec(
            cfg, grid, kind="train", batch=4).items()}
        rng = np.random.default_rng(0)
        tok = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 16)))
        rows = layout.batch_rows({"tokens": tok,
                                  "targets": torch.roll(tok, -1, 1)}, bsh)
        step = layout.mesh_step(make_grad_fn(cfg, tcfg), tcfg.opt, sh, bsh)
        fsdp.gather, fsdp.reduce = gather, reduce
        try:
            state, metrics = step(state, rows)
        finally:
            fsdp.gather, fsdp.reduce = real_gather, real_reduce
        out.append(dict(seen, grads_at_end=sum(r() is not None
                                               for r, _ in grads),
                        grads_seen=len(grads),
                        loss=float(metrics["loss"])))
    return out
