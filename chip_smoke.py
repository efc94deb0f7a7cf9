#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It fails (nonzero exit, no result line) without a CUDA device, and when
it is not next to the repository's ``src/repro_torch``.  Phases, one
printed line each, any failure ends the run:

1. device   the card's name, and its name and power limit from nvidia-smi;
2. build    nvcc builds the eight kernels K1-K8 from
            ``src/repro_torch/kernels/csrc`` (sm_90a), once, in this
            process, with each kernel's registers, shared memory, stack
            frame, spills;
3. kernels  every kernel against its plain PyTorch version on the card,
            at the main paths' shapes, in f32 and f64 (and bf16 operands
            for K1-K3): bitwise for K1, K3, K8 and K4's R and ls (NaNs
            by position), K4's sign exactly (NaN where the plain
            version's is), K4's logdet and K2 to the tolerances stated
            below; K4 at the staged route's widths, with dead columns,
            a zero pivot row, NaN and inf entries, and on its
            global-memory branch (K4_SHAPES, K4_GLOBAL), and K4 and K2
            at the widths method="auto" runs, K = 64 and 128 (K4_AUTO,
            K2_AUTO, each K4 panel on the branch it lists); K5, K6 and K7
            (on their routes' own operands) and their plain versions
            against the same function in f64, within its probabilistic
            rounding bound (`ref.matvec_bound`, `ref.cheb_step_bound`,
            `ref.cg_step_bound`), which planted faults must break; then
            each kernel's time beside its plain version, its bound and,
            where one PyTorch call computes the same function, that call
            (K1: `torch.addr`, K2: `torch.addmm`, K4:
            `torch.linalg.lu_factor_ex`, K8: `torch.sparse.mm` on a CSR
            matrix of the bands): K1-K3 in f32 and f64, K2 also with bf16
            operands and on the mesh lookahead's 32 rows, K1 also on its
            one row and beside a pure copy of its bytes (`copy_ms`), K6
            and K7 beside cuBLAS's product alone (`matmul_ms`) and K5's
            (`matvec_ms`, the tile they share); K1-K4 on the STACKS
            shapes, one launch for the whole stack (their batch grids):
            bitwise against the batched plain version (K2 within its
            bound), matrix b bitwise equal to the single-matrix launch on
            it, each time beside B times the single launch's, its bound
            and `torch.baddbmm` (K1, K2) or `torch.linalg.lu_factor_ex`
            (K4);
4. main path ``repro_torch.plan(a, method="exact", ...)`` on the card at
            N = 8192 f32 (the paper's largest size, rounded to the panel
            width) for staged x rank1 and staged x panel, each unfused and
            fused, and staged x panel with bf16 operands: sign exact,
            log|det| against an f64 reference, fused bitwise equal to
            unfused, and the launch counts of K1-K4 equal to the schedule;
            a small matrix with a NaN entry must give sign and log|det|
            NaN through staged x rank1 and staged x panel;
4b. auto    ``repro_torch.plan(x)`` with no method on the committed
            calibration table (its source must be ``measured:cuda``,
            every term positive): the exact cell with ``rtol=1e-6``
            takes staged x panel at the autotuned width (sign, log|det|,
            launches; its wall beside phase 4's), an SPD matrix of the
            same side takes the route the card runs faster, exact or
            slq, both timed here beside the model's seconds, the dense
            estimator cell slq (chebyshev with bounds) and the lattice
            slq, each against its exact reference; the N at which the
            table moves dense SPD input from exact to slq;
5. estimators ``repro_torch.plan(x, method="chebyshev"|"slq")`` and
            ``estimators.cg_solve(x, b)`` on a dense SPD N = 16384 f32
            matrix and on the 1024 x 1024 lattice precision of a Matern
            (SPDE) field (the constants EST_N, SIDE, DEGREE, NUM_STEPS,
            PROBES below): estimates against exact f64 references, each
            route against the same route through the plain versions on
            the card (same probes and bounds), CG's true residual, and
            the launch counts of K6-K8 equal to the route's formula;
6. mesh     the paper's parallel condensation and the sharded estimators
            through ``repro_torch.plan(..., mesh=...)`` and
            ``estimators.cg_solve(ShardedOperator(...))``, on one rank
            under NCCL and on MESH_RANKS ranks sharing the card under
            gloo (spawned processes, `core.mesh.run_ranks`): mesh x
            rank1 and mesh x panel, plain and lookahead, on the exact
            cell (sign exact, log|det| against the f64 slogdet,
            lookahead bitwise equal to plain), sharded Chebyshev, SLQ
            and CG on the dense estimator cell (against the exact f64
            reference and the same route through the plain product, CG's
            true residual), the launch counts and collectives of every
            rank, and every rank's result equal to rank 0's; then the
            paper's baselines ge, pge, plu (nb = 1, 32) on the exact cell
            (one rank: N = 8192, the ``[table3]`` line beside mesh x
            rank1 and x panel; four ranks: N = 1024), sign and log|det|
            against the f64 slogdet, launches and collectives against
            their formulas, and a NaN entry giving sign NaN; then (for
            phase 12) ``method="pmc"`` and ``"pmc_blocked"`` at
            BASELINE_SHARED_N bitwise their ``method="exact"`` mesh
            plans with the same launches and a DeprecationWarning, and a
            broadcast of 2 N P floats recorded on the rank's card caught
            by collective-payload-budget; and ``audit_grid(n=32,
            mesh=...)`` on every rank (nothing spawned), clean;
7. grad     gradients through ``plan(...).value_and_grad`` and autograd of
            ``plan(...).logdet(x)``: on phase 4's matrix (staged x panel,
            staged x rank1, ge) sign and log|det| equal to phase 4's, the
            gradient bitwise equal across the routes and the two paths,
            ||A G^T - I|| / sqrt(N) under INV_RESIDUAL, a directional
            derivative against a central difference of the f64 slogdet,
            K1-K4 launches of the forward unchanged and none in the
            backward; on the dense estimator cell (slq, chebyshev with
            bounds) the value bitwise equal to ``__call__``'s, ||G -
            inv(A)^T|| within 3 sqrt(sum sem^2), the transposed CG's true
            residual under its tolerance, K7 never launched and K6 at its
            forward formula; on the lattice (slq) a finite (5, n) band
            gradient equal to the same pullback through the plain
            `ref.stencil_mv_ref` within its rounding bound, K8 launched CG
            iterations + 1 times by the backward, and on a 64 x 64 lattice
            within 3 sem of inv(A)^T at the bands' positions; on phase 6's
            ranks (run there), mesh x panel plain and lookahead: every
            rank's gradient equal to rank 0's and to the single-device
            plan's, and sharded Chebyshev's equal to dense Chebyshev's
            (same probes and bounds) within ROUTE_RTOL's f32 figure;
8. stacks   (B, n, n) stacks through ``repro_torch.plan`` (STACKS: the
            UBM stack 2048 x 60 x 60 and 16 x 4096 x 4096, f32, x x^T / n
            + 2 I per matrix, one with a negated row): the exact routes
            (staged x rank1, the default, serial x rank1, serial x panel
            at the autotuned K, fused, bf16 operands, ge; on the large
            stack staged x rank1 and x panel) with every sign exact,
            log|det| within E2E_RTOL of each matrix's f64 slogdet, the
            launches of ONE matrix's formula whatever B, matrix b against
            the single-matrix plan on it (bitwise; panel within
            STACK_PANEL_RTOL, bitwise or not printed) and the stack's
            wall beside B times the single wall; ``method="auto"`` on the
            UBM stack beside the two routes it prices; a NaN matrix
            leaving the other seven alone; `BatchedOperator` slq,
            chebyshev with bounds and cg_solve on the large SPD stack
            (against the f64 Cholesky reference, the true residual, no
            kernel launched); value_and_grad on the stacks (exact: G
            bitwise across serial x panel and ge, the inverse residual;
            slq: within 3 sqrt(sum sem^2) of inv(A)^T); and
            examples/gmm_fit_torch.py's train() for 5 SGD steps at dim
            60, 64 components, 4096 samples, exact and slq;
9. structured  `estimators.KroneckerOperator` (KRON_SIDE x KRON_SIDE
            factors x x^T / (2 side) + 2 I: n = 1,048,576, a spatio-
            temporal GP's 1024 sites x 1024 times) and
            `estimators.ToeplitzOperator` (the AR(1) column AR_RHO^k, n =
            2^20), f32 on the card: chebyshev (on the spectrum's closed-
            form bounds), slq and auto (PROBES probes) within N_SEM sem +
            EST_RTOL of the closed forms
            nB log|A| + nA log|B| and (n - 1) log(1 - rho^2), cg_solve
            with PROBES right-hand sides (true residual in f64), and
            value_and_grad of slq against the closed-form gradients (nB
            A^-T and nA B^-T; the Toeplitz column's d/dc_0, d/dc_1, zero
            beyond) within 3 sqrt(sum sem^2) of the probe noise (the
            Toeplitz entries c_0, c_1 also within N_SEM of their own
            sem); no kernel launched (their products are GEMMs and FFTs);
            then examples/gmm_loglik_torch.py, one EM run at dim TWIN_DIM
            with slq and CG and one exact with direct solves: finite, each
            slq logdet within N_SEM sem of the exact one and the
            log-likelihoods within N_SEM sem;
10. trace   staged x panel and staged x rank1 on phase 4's matrix under
            obs off, metrics and trace (`repro_torch.obs`): the same bits
            in the three modes, no engine or kernel range in a profile of
            the off call, the launches of phase 4's formula; of the traced
            call inside `torch.profiler` (CPU and CUDA), the host time per
            stage from the spans, the card time per kernel, the card's
            idle share (staged x panel's off call profiled too); the spans
            as a Chrome trace in obs_out/, checked by
            ``python -m repro_torch.obs validate`` (the staged x panel
            profile beside it);
11. serve   `repro_torch.serve` on the card with the traffic of
            ``benchmarks/serve_bench.py`` (SERVE_REQUESTS f64 matrices,
            sides uniform in SERVE_N, exact, open-loop) in its three
            modes: naive (a plan per request), bucketed (the service at
            max_batch 1) and batched (max_batch SERVE_MAX_BATCH), under
            obs metrics: every sign exact and log|det| within SERVE_RTOL
            of numpy's, each batched result bitwise the same request's
            bucketed one, after warmup no plan-cache miss, K1 launching
            sum over batches of (bucket - 1) and no other kernel;
            throughput, p50 / p99 latency and warmup printed per mode
            (not gated); slq requests through the default ladder within
            N_SEM sem + EST_RTOL, no launch; then ``python -m
            repro_torch.serve export`` of the ladder and a fresh
            ``--plan-dir`` server process: its HTTP answers bitwise the
            in-process service's, every plan and the kernels' libraries
            loaded at warmup and nothing loaded or built by the requests,
            the artifacts' fingerprint naming this card, capability
            (9, 0) and this kernel build; last, K1 in f64 at every shape
            the drains gave it, bitwise the plain version and each
            matrix its single launch, SERVE_K1_TIMED timed for the
            kernels line;
12. audit   `repro_torch.analysis` on the card: the JAX default grid
            at n = 32, audited in phase 6's ranks (one under NCCL, four
            sharing the card under gloo), clean on every rank, with the
            JAX ``passes_run``; at N = 8192 ``plan.audit()`` of auto's exact
            route (staged x panel), of staged x rank1 and of slq with
            ``include_grad``, one ``[audit]`` line per recording (ops,
            ops per eliminated row, host reads and their sites, kernel
            records, collectives, seconds; the trace recording of
            stage-coverage: its scopes): each clean, its kernel records
            equal to the launch counters over the same call, its result
            bitwise an unrecorded call's; every pass fails on
            a fault planted with CUDA tensors (a ``.item()`` in the
            exact step loop, an f32 -> f64 copy, a Cholesky in a
            matrix-free context, a bf16 context whose K2 has f32
            operands, a missing and a phantom stage; the over-budget
            broadcast in phase 6's ranks); ``core.api.slogdet(a,
            method="mc_blocked")`` at N = 8192 bitwise serial x panel
            with the same launches and its two DeprecationWarnings.
13. models  `repro_torch.models` / `.configs` / `.data`: the ten archs
            at their smoke configs in f32, card against CPU forward and
            prefill + decode against forward (MoE routing margins
            first); gemma3-1b at full width, 6 layers in f32 against the
            CPU's f64 forward, and all 26 layers with bf16 activations
            (prefill, greedy decode, rates, peak memory); no kernel
            launched by either; `data.random_matrix`'s kinds through the
            exact plan (rank1, panel) against numpy's slogdet with phase
            4's launches; `synth_batch` on the card bitwise the CPU's;
14. train   `repro_torch.optim` / `.train` / `.checkpoint` / `.ft`, with
            the logdet aux (``logdet_reg``) through K1: (a) one train
            step of every arch at its smoke config in f32 (adamw, weight
            decay 0.01, TRAIN_MICRO microbatches; gradient compression
            on TRAIN_COMPRESSION_ARCH; sgd and adafactor on
            TRAIN_OPT_ARCHS) on the card against the same step on the
            CPU from one seeded state: the metrics, the clipped
            gradients (TRAIN_GRAD_TOL of the largest element, plus a bf16
            rounding where one is taken), the card's optimizer on the
            CPU's gradient against the CPU's step (TRAIN_OPT_RTOL), the deltas
            card against CPU printed, K1 launched microbatches x
            (d_model - 1) times a step and K2-K8 never; (b) gemma3-1b at
            full width, 6 layers, f32, one adamw step with the aux at 2 x
            64 tokens, card against CPU as (a) (the gradient per JAX leaf
            group printed), and the aux alone on the pooled embeddings
            within LOGDET_KU sqrt(d) cond(Cov + eps I) 2^-24 of the CPU's;
            (c)
            gemma3-1b at full depth, bf16 activations, adamw with the
            aux, 2 microbatches of 2 x 512 tokens: a warm-up step and 3
            timed (step ms, tokens/s, peak memory, K1 2 x 1151 a step,
            finite metrics) and the aux alone timed as a share of the
            step; (d) `ft.run_training` on the card (async checkpoints
            every DRIVER_CKPT steps, a node failure, a sleep): one
            restart, the straggler flagged, the final parameters bitwise
            an uninterrupted run's, and one synchronous save of (b)'s
            state restored onto the CPU, bitwise, with its GB/s;
15. launch  `repro_torch.sharding` / `.launch`: (a) `launch.train` on
            gemma3-1b at full width and depth with the aux, one rank
            (LAUNCH_STEPS steps of LAUNCH_SHAPE tokens in LAUNCH_MICRO
            microbatches): finite losses, K1 exactly steps x
            microbatches x (d_model - 1) and nothing else, no
            collective; step s, tokens/s, peak memory, the checkpoint's
            seconds; (b) the JAX launcher test's run (LAUNCH_ARGV) with
            the aux, f32, on a 2x2 grid of four gloo ranks sharing the
            card, on the split step (each rank its share of the batch,
            the parameters gathered one unit at a time, each unit's
            gradient reduced in its backward, its optimizer on its
            blocks), against
            one rank here: the first reduced gradient within
            TRAIN_GRAD_TOL of its largest element, its metrics within
            TRAIN_METRIC_RTOL, every step's loss within LAUNCH_LOSS_RTOL,
            the mean loss over the run's batches lower with the grid's
            last parameters than with the first; bitwise: every rank's
            reduced gradient, the ranks holding one block alike, the
            shapes of the rules' shards, the last step's collectives
            equal to `layout.step_plan` (no optimizer leaf gathered); K1
            (d_model - 1) a step on every rank; the grid's
            step-LAUNCH_RESTORE_AT checkpoint restored onto a 2x2 grid
            bitwise the saved blocks and ending on the 2x2 run's last
            checkpoint bit for bit, onto a 2x1 grid bitwise the saved
            blocks and on within LAUNCH_LOSS_RTOL of the 2x2 run, and
            onto one rank; then the same grid
            at full width and depth (gemma3-1b at LAUNCH_WIDE_LAYERS
            layers, LAUNCH_WIDE_STEPS steps of LAUNCH_WIDE_SHAPE, the
            aux, f32, its final checkpoint gathered and written): the
            same bitwise checks, the first reduced gradient within
            TRAIN_GRAD_TOL of one rank's largest element and the losses
            within LAUNCH_LOSS_RTOL, K1 exactly steps x (d_model - 1) on
            every rank, a rank's step s and peak, the high-water of whole
            parameter bytes alive at once, the bytes a step, resident
            bytes a rank, beside the step that gathered every parameter
            whole once a step (LAUNCH_WIDE_GATHER_ALL); (c)
            `launch.serve.generate` on LAUNCH_SERVE against the CPU on
            the same parameters (f32 logits within SMOKE_ATOL, greedy
            tokens equal until a near tie), tokens/s, and the CLI; (d)
            the dry run's DRYRUN_CELLS at full size, argument bytes,
            broadcasts, all_sums and their bytes equal to the JAX rules'
            totals recorded beside each cell (a train cell: rank 0's share of
            the split step), the memory tracker's temp bytes where the
            cell is not fast, the records printed beside the
            gather-all step's (DRYRUN_GATHER_ALL).

The line before the last is the ``kernels`` JSON; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense, no sparsity); f64 at the FP64
# tensor cores' rate (K5 runs on them; DFMA alone peaks at 34e12)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 67e12}

# time_ms(queued=True): about 20 ms at the H100's clock
SLEEP_CYCLES = 40_000_000

# K4 logdet: the card's log against PyTorch's log, summed over K pivots
LOGDET_RTOL = {"float32": 1e-6, "float64": 1e-14}
# end to end, against the f64 slogdet of the same matrix
E2E_RTOL = {None: 1e-4, "bf16": 5e-3}

KERNEL_META = {
    "rank1_update": ("src/repro_torch/kernels/csrc/condense_step.cu",
                     "src/repro/kernels/condense_step.py:36"),
    "panel_update": ("src/repro_torch/kernels/csrc/panel_update.cu",
                     "src/repro/kernels/panel_update.py:35"),
    "fused_step": ("src/repro_torch/kernels/csrc/fused_step.cu",
                   "src/repro/kernels/fused_step.py:40"),
    "panel_factor": ("src/repro_torch/kernels/csrc/panel_factor.cu",
                     "src/repro/kernels/panel_factor.py:31"),
    "matvec": ("src/repro_torch/kernels/csrc/matvec.cu",
               "src/repro/kernels/matvec.py:34"),
    "cheb_step": ("src/repro_torch/kernels/csrc/cheb_step.cu",
                  "src/repro/kernels/fused_est.py:40"),
    "cg_step": ("src/repro_torch/kernels/csrc/cg_step.cu",
                "src/repro/kernels/fused_est.py:85"),
    "stencil_mv": ("src/repro_torch/kernels/csrc/stencil_mv.cu",
                   "src/repro/kernels/stencil_mv.py:34"),
}
# the estimator cells: a dense SPD matrix of side EST_N and the SPDE
# (Matern, alpha = 1) lattice precision kappa^2 I + L_2D on SIDE x SIDE
# nodes; Chebyshev of degree DEGREE, SLQ of NUM_STEPS steps, PROBES probes
# (and CG right-hand sides)
EST_N, SIDE, KAPPA2 = 16384, 1024, 0.1
DEGREE, NUM_STEPS, PROBES = 64, 25, 32
# estimate against its exact reference: N_SEM standard errors of the
# probe noise plus a relative allowance for truncation bias and f32
# rounding (f32 against f64 with the same probes measured up to 2.5e-4
# on the lattice, CPU: inside 5 sem, which is 6.6e-4 there)
N_SEM, EST_RTOL = 5.0, 1e-4
# a route through a kernel against the same route through the plain
# versions, same probes and bounds: K6 sums A @ w in another order (f32);
# routes without a summation-order difference must agree to 1e-6
ROUTE_RTOL = {"dense|chebyshev": 1e-4, "dense|slq": 1e-6,
              "lattice|chebyshev": 1e-6, "lattice|slq": 1e-6}
CG_TOL, CG_RESIDUAL, CG_X_RTOL = 1e-6, 1e-5, 1e-5
# phase 6: ranks of the shared-card mesh, and each run's time limit (s)
MESH_RANKS, MESH_TIMEOUT = 4, 600
# the paper's baselines in phase 6: (method, nb); their side on the
# shared-card mesh (correctness only; 2048 before phase 15's 26-layer
# grid, cut to keep the script inside its time limit: pge and plu there
# are latency-bound, three collectives a column), and of the NaN-entry
# matrix
BASELINES = [("ge", 1), ("pge", 1), ("plu", 1), ("plu", 32)]
BASELINE_SHARED_N, BASELINE_NAN_N = 1024, 256
# phase 7: the exact gradient G = inv(A)^T in f32 at N = 8192, its residual
# ||A G^T - I||_F / sqrt(N) (f64 product; the cell's condition number is
# about 3); the directional derivative <G, E> (E = randn / sqrt(N))
# against the central difference of the f64 slogdet at step FD_STEP,
# within FD_RTOL (its truncation and rounding are far below)
INV_RESIDUAL, FD_STEP, FD_RTOL = 1e-4, 1e-4, 1e-3
# the estimator backward's CG tolerance on the dense and lattice cells: f32
# solves reach a true residual of about 1e-6 at these conditions (phase 5),
# so at 1e-4 "true residual under the tolerance" is the solve's doing, not
# rounding's; on the mesh, where sharded and dense Chebyshev are compared
# within ROUTE_RTOL, 1e-6
GRAD_CG_TOL, MESH_GRAD_CG_TOL = 1e-4, 1e-6
# Chebyshev's bounds on the dense cell (spectrum of x x^T / n + 2 I inside
# [2, 6]), and the side of the small lattice held against a dense inverse
CHEB_BOUNDS, SMALL_SIDE = (1.9, 6.5), 64


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields, default=str), flush=True)


def time_ms(fn, *, warmup: int = 3, iters: int = 20,
            queued: bool = False) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls;
    ``queued`` puts them behind a sleeping kernel, so that a call shorter
    than the host's enqueue is timed on the card, not on the host (and
    fails if the enqueue outlasted the sleep)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        s0 = torch.cuda.Event(enable_timing=True)
        s0.record()
        torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    if queued:
        slept = s0.elapsed_time(start)
        require(host_ms < slept, f"enqueue of {iters} calls took {host_ms} "
                f"ms, longer than the {slept} ms sleep: raise SLEEP_CYCLES")
    return start.elapsed_time(end) / iters


def bound_ms(bytes_moved: float, ops: float, dtype: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------

# the dtype variants of phase 3 that are timed: "buffer/operands" -> key
# (K1 and K3 in the buffer's dtype only)
TIMED_VARIANTS = {"float32/float32": "float32", "float64/float64": "float64",
                  "float32/bfloat16": "bf16_operands"}


def kernel_phase(n: int, k: int, gen) -> dict:
    import torch
    from repro_torch.kernels import condense_step, fused_step, ref
    from repro_torch.kernels import panel_update as k2

    dev = "cuda"
    variants = [(torch.float32, torch.float32), (torch.float64, torch.float64),
                (torch.float32, torch.bfloat16), (torch.float64, torch.bfloat16)]
    timings = {}

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev,
                           dtype=torch.float64).to(dtype)

    for dt, op in variants:
        tag = f"{str(dt)[6:]}/{str(op)[6:]}"
        a = randn(n, n, dtype=dt)
        pc, pr = randn(n, dtype=op), randn(n, dtype=op)
        c, r = randn(n, k, dtype=op), randn(k, n, dtype=op)
        l = torch.tensor([n // 3], dtype=torch.int64, device=dev)
        last = n - 1
        col_l, col_last = a[:, n // 3].contiguous(), a[:, last].contiguous()

        # K1, bitwise
        got, want = condense_step.rank1_update(a, pc, pr), \
            ref.rank1_update_ref(a, pc, pr)
        torch.cuda.synchronize()
        err1 = (got - want).abs().max().item()
        require(torch.equal(got, want), f"K1 {tag}: not bitwise, {err1}")

        # K3, bitwise against its plain version and against swap + K1
        got3 = fused_step.fused_step(a, l, last, pc, pr, col_l, col_last)
        want3 = ref.fused_step_ref(a, l, last, pc, pr, col_l, col_last)
        sw = a.clone()
        sw[:, n // 3], sw[:, last] = col_last, col_l
        torch.cuda.synchronize()
        err3 = (got3 - want3).abs().max().item()
        require(torch.equal(got3, want3), f"K3 {tag}: not bitwise, {err3}")
        require(torch.equal(got3, condense_step.rank1_update(sw, pc, pr)),
                f"K3 {tag}: differs from swap + K1")

        # K2: the sums run in another order than cuBLAS's.  Elementwise
        # bound 2*K*eps_acc*(|c|@|r|) + eps_buf*|a - c@r| (the product's
        # rounding in either order, then one rounding of the subtract)
        got2, want2 = k2.panel_update(a, c, r), ref.panel_update_ref(a, c, r)
        acc = ref.accumulator_dtype(dt)
        tol2 = ref.panel_update_bound(a, c, r, want2)
        diff2 = (got2 - want2).abs()
        err2 = diff2.max().item()
        require(bool((diff2 <= tol2).all()),
                f"K2 {tag}: outside the summation-order bound, {err2}")
        say("kernels", variant=tag, rank1_update_bitwise=True,
            fused_step_bitwise=True, panel_update_max_abs_err=err2,
            panel_update_max_rel_to_bound=(
                diff2 / tol2.clamp_min(torch.finfo(acc).tiny)).max().item())

        key = TIMED_VARIANTS.get(tag)
        if key is not None:
            times = kernel_times(n, k, a, pc, pr, c, r, l, last, col_l,
                                 col_last, (err1, err2, err3))
            for name, t in times.items():
                timings.setdefault(name, {})[key] = t
                say("timing", kernel=name, variant=key, shape=[n, n], k=k,
                    ms=t["ms"], plain_ms=t["plain_ms"],
                    library_ms=t["library_ms"], copy_ms=t.get("copy_ms"),
                    bound_ms=t["bound"][0], bound_by=t["bound"][1])
                for shape, ts in t.get("shapes", {}).items():
                    say("timing", kernel=name, variant=key, shape=shape, **ts)
            if key == "float32":
                # K2 on the mesh lookahead's 32 rows: shorter than the
                # host's enqueue, so timed behind a sleeping kernel
                rows = slice(0, 32)
                ar, cr = a[rows], c[rows].contiguous()
                t = dict(
                    ms=time_ms(lambda: k2.panel_update(ar, cr, r),
                               queued=True),
                    plain_ms=time_ms(lambda: ref.panel_update_ref(ar, cr, r),
                                     queued=True),
                    library_ms=time_ms(lambda: torch.addmm(ar, cr, r,
                                                           alpha=-1),
                                       queued=True),
                    bound_ms=bound_ms((2 * 32 * n + 32 * k + k * n) * 4,
                                      2 * 32 * n * k + 32 * n,
                                      "float32")[0])
                timings["panel_update"]["shapes"] = {f"32x{n}": t}
                say("timing", kernel="panel_update", variant=key,
                    shape=[32, n], k=k, **t)
        del a, pc, pr, c, r, got, want, got2, want2, got3, want3, sw
        torch.cuda.empty_cache()
    # the f32 fields at the top, each other variant under its key
    return {name: dict(by_key.pop("float32"), **by_key)
            for name, by_key in timings.items()}


def kernel_times(n, k, a, pc, pr, c, r, l, last, col_l, col_last, errs):
    """Times of K1-K3 on phase 3's operands, each beside its plain version,
    its bound and the PyTorch call computing the same function (none for
    K3, or for operands in another dtype than the buffer)."""
    import torch
    from repro_torch.kernels import condense_step, fused_step, ref
    from repro_torch.kernels import panel_update as k2

    err1, err2, err3 = errs
    name_dt = str(a.dtype)[6:]
    size, op_size = a.element_size(), c.element_size()
    same = a.dtype == c.dtype
    out = {"panel_update": dict(
        max_abs_err=err2,
        ms=time_ms(lambda: k2.panel_update(a, c, r)),
        plain_ms=time_ms(lambda: ref.panel_update_ref(a, c, r)),
        bound=bound_ms(2 * n * n * size + 2 * n * k * op_size,
                       2 * n * n * k + n * n, name_dt))}
    # bf16 operands: addmm's out_dtype overload widens them into an f32
    # product; where the card refuses it, its error stands in the line
    try:
        lib = (lambda: torch.addmm(a, c, r, alpha=-1)) if same else \
            (lambda: torch.addmm(a, c, r, out_dtype=a.dtype, alpha=-1))
        out["panel_update"]["library_ms"] = time_ms(lib)
    except RuntimeError as e:
        out["panel_update"].update(library_ms=None,
                                   library_error=str(e).splitlines()[0])
    if not same:
        return out
    o = torch.empty_like(a)
    a1, pc1 = a[:1], pc[:1]
    out["rank1_update"] = dict(
        max_abs_err=err1,
        ms=time_ms(lambda: condense_step.rank1_update(a, pc, pr)),
        plain_ms=time_ms(lambda: ref.rank1_update_ref(a, pc, pr)),
        library_ms=time_ms(lambda: torch.addr(a, pc, pr, alpha=-1)),
        # a pure stream of K1's bytes: a read once, the output written once
        copy_ms=time_ms(lambda: o.copy_(a)),
        bound=bound_ms((2 * n * n + 2 * n) * size, 2 * n * n, name_dt),
        # the mesh lookahead's one-row calls: shorter than the host's
        # enqueue, so timed behind a sleeping kernel
        shapes={f"1x{n}": dict(
            ms=time_ms(lambda: condense_step.rank1_update(a1, pc1, pr),
                       queued=True),
            plain_ms=time_ms(lambda: ref.rank1_update_ref(a1, pc1, pr),
                             queued=True),
            library_ms=time_ms(lambda: torch.addr(a1, pc1, pr, alpha=-1),
                               queued=True),
            bound_ms=bound_ms((3 * n + 1) * size, 2 * n, name_dt)[0])})
    del o
    out["fused_step"] = dict(
        max_abs_err=err3,
        ms=time_ms(lambda: fused_step.fused_step(a, l, last, pc, pr, col_l,
                                                 col_last)),
        plain_ms=time_ms(lambda: ref.fused_step_ref(a, l, last, pc, pr,
                                                    col_l, col_last)),
        library_ms=None,
        bound=bound_ms((2 * n * n + 4 * n) * size + 8, 2 * n * n, name_dt))
    return out


def same_bits(a, b) -> bool:
    """``a`` and ``b`` equal bit for bit (so -0 differs from +0), NaNs
    compared by position only: ``torch.equal`` is false on any NaN."""
    import torch
    na, nb = torch.isnan(a), torch.isnan(b)
    if not torch.equal(na, nb):
        return False
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}[a.dtype]
    return torch.equal(a.masked_fill(na, 0).view(ints),
                       b.masked_fill(nb, 0).view(ints))


def same_value(x: float, y: float, rtol: float) -> bool:
    """Both NaN, equal (infinities too), or within ``rtol`` relative."""
    if x != x or y != y:
        return x != x and y != y
    return x == y or abs(x - y) <= rtol * max(abs(y), 1e-300)


# K4 panels of phase 3: (K, N, m0, r_pos, kind); N the staged route's
# stage widths at N = 8192 (and the mesh's full width), m0 < N leaves dead
# columns; kinds plant a zero pivot row, a NaN and an inf entry
K4_SHAPES = [(32, 8192, 8192, 0, "random"), (32, 8192, 8192, 1, "random"),
             (32, 8192, 6000, 1, "random"),
             (32, 4608, 4608, 1, "random"), (32, 4608, 4000, 0, "random"),
             (32, 1944, 1944, 0, "random"), (32, 1944, 1900, 1, "random"),
             (32, 462, 462, 1, "random"), (32, 462, 300, 0, "random"),
             (32, 64, 64, 0, "random"), (32, 64, 40, 1, "random"),
             (32, 8192, 8192, 0, "zero_row"), (32, 8192, 8000, 1, "nan"),
             (32, 8192, 8192, 0, "inf"), (32, 1944, 1944, 1, "nan"),
             (32, 462, 462, 0, "inf")]
# one width of the global-memory branch per dtype (K4's plan)
K4_GLOBAL = {"float32": (32, 32768, 30000, 1, "random"),
             "float64": (32, 16384, 16000, 0, "random")}
# K4 at the widths method="auto" runs (resolved_panel_k: 64 at N = 8192,
# 128 at 16384), each with the branch its plan must take (True: shared
# memory); f64 at 64 and f32 at 128 exceed the shared-memory budget
K4_AUTO = {"float32": [((64, 8192, 8192, 0, "random"), True),
                       ((64, 8192, 7000, 1, "nan"), True),
                       ((128, 16384, 16384, 0, "random"), False),
                       ((128, 16384, 15000, 1, "inf"), False)],
           "float64": [((64, 8192, 8192, 0, "random"), False),
                       ((64, 8192, 7000, 1, "nan"), False)]}
K4_TIMED = {"float32": [(32, 8192), (32, 4608), (64, 8192), (128, 16384)],
            "float64": [(32, 8192), (32, 4608), (64, 8192)]}
# K2 at the auto widths: (buffer dtype, side, K)
K2_AUTO = [("float32", 8192, 64), ("float64", 8192, 64),
           ("float32", 16384, 128)]


def k4_panel(k: int, n: int, kind: str, gen, dtype):
    import torch
    p = torch.randn(k, n, generator=gen, device="cuda",
                    dtype=torch.float64).to(dtype)
    if kind == "zero_row":
        p[3] = 0.0
    elif kind == "nan":
        p[2, 100] = float("nan")
    elif kind == "inf":
        p[4, 7] = float("inf")
    return p


def lu_factor_ms(a, backend) -> float:
    """Time of ``torch.linalg.lu_factor_ex(a)`` with PyTorch's linear
    algebra backend set to ``backend`` (None: its default choice, which
    for a tall (N, 32) matrix is not the faster cuSOLVER)."""
    import torch
    prev = torch.backends.cuda.preferred_linalg_library()
    if backend is not None:
        torch.backends.cuda.preferred_linalg_library(backend)
    try:
        return time_ms(lambda: torch.linalg.lu_factor_ex(a))
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)


def panel_factor_phase(gen) -> dict:
    """K4 against its plain version: R and ls bit for bit, the sign exactly
    (NaN where the plain version's is NaN), log|det| within LOGDET_RTOL,
    at every K4_SHAPES panel, the K4_GLOBAL width and the K4_AUTO panels
    (each on the branch it lists), f32 and f64; then times at K4_TIMED
    beside the plain version, the bound and
    ``torch.linalg.lu_factor_ex`` of the transposed live panel (the same
    K eliminations with the same pivot rule; its input transposed outside
    the timing), on cuSOLVER and on PyTorch's default backend.  Returns
    the kernels-line fields, f32 (32, 8192) first."""
    import torch
    from repro_torch.kernels import panel_factor as k4
    from repro_torch.kernels import ref

    out = {}
    for dt in (torch.float32, torch.float64):
        name_dt = str(dt)[6:]
        rtol = LOGDET_RTOL[name_dt]
        shapes = [(s, None) for s in K4_SHAPES] \
            + [(K4_GLOBAL[name_dt], False)] + K4_AUTO[name_dt]
        for (k, n, m0, r_pos, kind), shared in shapes:
            plan = k4.plan(k, n, dt)
            panel = k4_panel(k, n, kind, gen, dt)
            R, ls, s, ld = k4.panel_factor(panel, m0, r_pos)
            R0, ls0, s0, ld0 = ref.panel_factor_ref(panel, m0, r_pos)
            torch.cuda.synchronize()
            tag = f"K4 {name_dt} {(k, n, m0, r_pos, kind)}"
            require(same_bits(R, R0), f"{tag}: R not bitwise")
            require(torch.equal(ls, ls0), f"{tag}: ls differ")
            require(same_value(s.item(), s0.item(), 0.0),
                    f"{tag}: sign {s.item()} != {s0.item()}")
            require(same_value(ld.item(), ld0.item(), rtol),
                    f"{tag}: logdet {ld.item()} vs {ld0.item()}")
            if kind == "nan":
                require(s.item() != s.item(), f"{tag}: sign not NaN")
            require(shared is None or plan.shared == shared,
                    f"{tag}: shared-memory branch {plan.shared}, expected "
                    f"{shared}")
            say("kernels", kernel="panel_factor", variant=name_dt,
                shape=[k, n], m0=m0, r_pos=r_pos, kind=kind,
                plan=plan._asdict(), R_ls_bitwise=True, sign=s.item(),
                logdet=ld.item(), logdet_rtol=rtol)
        size = torch.finfo(dt).bits // 8
        for k, n in K4_TIMED[name_dt]:
            plan = k4.plan(k, n, dt)
            say("launch", kernel="panel_factor", dtype=name_dt, shape=[k, n],
                cluster=plan.cluster, cols_per_block=plan.cols,
                shared=plan.shared, smem_bytes_per_block=plan.smem_bytes)
            panel = k4_panel(k, n, "random", gen, dt)
            lu_in = panel.mT.contiguous()
            R, _, _, _ = k4.panel_factor(panel, n)
            R0, _, _, _ = ref.panel_factor_ref(panel, n)
            torch.cuda.synchronize()
            ms = time_ms(lambda: k4.panel_factor(panel, n))
            t = dict(
                max_abs_err=(R - R0).abs().max().item(), ms=ms,
                ms_per_step=ms / k,
                plain_ms=time_ms(lambda: ref.panel_factor_ref(panel, n),
                                 warmup=1, iters=5),
                library_ms=lu_factor_ms(lu_in, "cusolver"),
                library_default_ms=lu_factor_ms(lu_in, None),
                bound=bound_ms(2 * k * n * size + k * 8 + 2 * size,
                               k * (n + 2 * k * n + n), name_dt),
                plan=plan._asdict())
            out[f"{name_dt}|{k}|{n}"] = t
            say("timing", kernel="panel_factor", dtype=name_dt, shape=[k, n],
                ms=t["ms"], ms_per_step=t["ms_per_step"],
                plain_ms=t["plain_ms"], library_ms=t["library_ms"],
                library="torch.linalg.lu_factor_ex (cuSOLVER)",
                library_default_ms=t["library_default_ms"],
                bound_ms=t["bound"][0], bound_by=t["bound"][1])
        torch.cuda.empty_cache()
    return out


def panel_update_auto_phase(gen) -> dict:
    """K2 at the widths method="auto" runs (K2_AUTO): within its
    summation-order bound of the plain version, a repeated call bitwise
    equal, then timed beside the plain version, the bound and
    ``torch.addmm``.  Returns ``{"<side>x<side>x<K>|<dtype>": fields}``."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import panel_update as k2

    out = {}
    for name_dt, n, k in K2_AUTO:
        dt = getattr(torch, name_dt)
        size = torch.finfo(dt).bits // 8

        def randn(*shape):
            return torch.randn(*shape, generator=gen, device="cuda",
                               dtype=torch.float64).to(dt)

        a, c, r = randn(n, n), randn(n, k), randn(k, n)
        got, want = k2.panel_update(a, c, r), ref.panel_update_ref(a, c, r)
        tol = ref.panel_update_bound(a, c, r, want)
        diff = (got - want).abs()
        tag = f"{n}x{n}x{k}|{name_dt}"
        require(bool((diff <= tol).all()),
                f"K2 {tag}: outside the summation-order bound, "
                f"{diff.max().item()}")
        require(torch.equal(k2.panel_update(a, c, r), got),
                f"K2 {tag}: a repeated call differs")
        t = dict(max_abs_err=diff.max().item(),
                 ms=time_ms(lambda: k2.panel_update(a, c, r)),
                 plain_ms=time_ms(lambda: ref.panel_update_ref(a, c, r)),
                 library_ms=time_ms(lambda: torch.addmm(a, c, r, alpha=-1)),
                 bound_ms=bound_ms(2 * n * n * size + 2 * n * k * size,
                                   2 * n * n * k + n * n, name_dt)[0])
        out[tag] = t
        say("timing", kernel="panel_update", variant=name_dt,
            shape=[n, n], k=k, **t)
        del a, c, r, got, want, tol, diff
        torch.cuda.empty_cache()
    return out


# phase 3 and 8: the stacks.  STACKS: name -> (B, n), the UBM stack (a
# full-covariance universal background model of speaker recognition:
# 2048 components over 60-dimensional features) and a few-but-large
# stack; their kernel shapes in phase 3 (K2 and K4 at the panel widths
# the routes run: K = 8 on the UBM stack padded to 64, 32 and 64 on the
# large one); STACK_SAMPLES matrices of each stack held against the
# single-matrix launch or plan
STACKS = {"ubm": (2048, 60), "large": (16, 4096)}
STACK_K2 = [("ubm", 64, 8), ("large", 4096, 32), ("large", 4096, 64)]
STACK_K4 = [("ubm", 8, 64, 64), ("large", 32, 4096, 4096),
            ("large", 64, 4096, 4096)]
STACK_SAMPLES = {"ubm": 8, "large": 2}
# phase 8: a panel route's matrix b of a stack against the single-matrix
# plan on it when not bitwise (a batched triangular solve may round
# otherwise)
STACK_PANEL_RTOL = 1e-6


def stack_samples(name: str) -> list:
    """The matrices of stack ``name`` held against single-matrix runs:
    STACK_SAMPLES evenly spaced from the first to the last, and matrix 1
    (phase 8 negates one of its rows)."""
    b, k = STACKS[name][0], STACK_SAMPLES[name]
    return sorted({round(i * (b - 1) / (k - 1)) for i in range(k)} | {1})


def stack_kernel_phase(gen) -> dict:
    """K1-K4 on the STACKS shapes, f32: one launch for the whole stack,
    bitwise (K1, K3, K4's R and ls) or within the summation-order bound
    (K2) of the batched plain version, and matrix b bitwise equal to the
    single-matrix launch on it at `stack_samples`; then times beside B
    times the single launch's, the bound (B times the single one's), the
    plain version and the one PyTorch call computing the same function
    (K1 and K2: `torch.baddbmm`; K4: `torch.linalg.lu_factor_ex` on the
    transposed live panels; K3: none).  Returns ``{kernel: {shape tag:
    fields}}``."""
    import torch
    from repro_torch.kernels import condense_step, fused_step, ref
    from repro_torch.kernels import panel_factor as k4
    from repro_torch.kernels import panel_update as k2

    dt, size, name_dt = torch.float32, 4, "float32"
    out = {n: {} for n in ("rank1_update", "fused_step", "panel_update",
                           "panel_factor")}

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda",
                           dtype=torch.float64).to(dt)

    def record(kernel, tag, b, launch, single, plain, library, bound, err,
               **extra):
        """Time a stack launch beside B single launches (queued: a single
        small launch is shorter than the host's enqueue)."""
        ms = time_ms(launch)
        one = time_ms(single, queued=True)
        t = dict(max_abs_err=err, ms=ms, single_ms=one,
                 b_times_single_ms=b * one,
                 plain_ms=time_ms(plain, warmup=1, iters=3),
                 library_ms=None if library is None else time_ms(library),
                 bound_ms=bound[0], bound_by=bound[1], batch=b, **extra)
        out[kernel][tag] = t
        say("timing", kernel=kernel, variant=name_dt, stack=tag, **t)

    for name, (b, n) in STACKS.items():
        samples = stack_samples(name)
        # K1 and K3 at step 0 of the rank-1 routes: (B, n, n)
        a = randn(b, n, n)
        pc, pr = randn(b, n), randn(b, n)
        l = torch.randint(0, n, (b,), generator=gen, device="cuda")
        last = n - 1
        col_l = a.gather(2, l[:, None, None].expand(b, n, 1))[..., 0]
        col_last = a[:, :, last].contiguous()
        got, want = condense_step.rank1_update(a, pc, pr), \
            ref.rank1_update_ref(a, pc, pr)
        got3 = fused_step.fused_step(a, l, last, pc, pr, col_l, col_last)
        want3 = ref.fused_step_ref(a, l, last, pc, pr, col_l, col_last)
        torch.cuda.synchronize()
        tag = f"{b}x{n}x{n}"
        require(torch.equal(got, want), f"K1 stack {tag}: not bitwise")
        require(torch.equal(got3, want3), f"K3 stack {tag}: not bitwise")
        for i in samples:
            require(torch.equal(got[i], condense_step.rank1_update(
                a[i], pc[i], pr[i])), f"K1 stack {tag}: matrix {i} differs "
                "from its single launch")
            require(torch.equal(got3[i], fused_step.fused_step(
                a[i], l[i:i + 1], last, pc[i], pr[i], col_l[i],
                col_last[i])), f"K3 stack {tag}: matrix {i} differs from "
                "its single launch")
        say("kernels", stack=tag, rank1_update_bitwise=True,
            fused_step_bitwise=True, samples_bitwise=samples)
        a0, pc0, pr0 = a[0], pc[0], pr[0]
        record("rank1_update", tag, b,
               lambda: condense_step.rank1_update(a, pc, pr),
               lambda: condense_step.rank1_update(a0, pc0, pr0),
               lambda: ref.rank1_update_ref(a, pc, pr),
               lambda: torch.baddbmm(a, pc[..., None], pr[..., None, :],
                                     alpha=-1),
               bound_ms(b * (2 * n * n + 2 * n) * size, b * 2 * n * n,
                        name_dt), 0.0)
        l0, cl0, cla0 = l[:1], col_l[0], col_last[0]
        record("fused_step", tag, b,
               lambda: fused_step.fused_step(a, l, last, pc, pr, col_l,
                                             col_last),
               lambda: fused_step.fused_step(a0, l0, last, pc0, pr0, cl0,
                                             cla0),
               lambda: ref.fused_step_ref(a, l, last, pc, pr, col_l,
                                          col_last),
               None, bound_ms(b * ((2 * n * n + 4 * n) * size + 8),
                              b * 2 * n * n, name_dt), 0.0)
        del a, pc, pr, col_l, col_last, got, want, got3, want3
        torch.cuda.empty_cache()

    for name, n, k in STACK_K2:
        b = STACKS[name][0]
        samples = stack_samples(name)
        a, c, r = randn(b, n, n), randn(b, n, k), randn(b, k, n)
        got, want = k2.panel_update(a, c, r), ref.panel_update_ref(a, c, r)
        tol = ref.panel_update_bound(a, c, r, want)
        diff = (got - want).abs()
        tag = f"{b}x{n}x{n}x{k}"
        require(bool((diff <= tol).all()),
                f"K2 stack {tag}: outside the summation-order bound")
        for i in samples:
            require(torch.equal(got[i], k2.panel_update(a[i], c[i], r[i])),
                    f"K2 stack {tag}: matrix {i} differs from its single "
                    "launch")
        say("kernels", stack=tag, panel_update_within_bound=True,
            samples_bitwise=samples)
        a0, c0, r0 = a[0], c[0], r[0]
        record("panel_update", tag, b,
               lambda: k2.panel_update(a, c, r),
               lambda: k2.panel_update(a0, c0, r0),
               lambda: ref.panel_update_ref(a, c, r),
               lambda: torch.baddbmm(a, c, r, alpha=-1),
               bound_ms(b * (2 * n * n + 2 * n * k) * size,
                        b * (2 * n * n * k + n * n), name_dt),
               diff.max().item(), k=k)
        del a, c, r, got, want, tol, diff
        torch.cuda.empty_cache()

    for name, k, n, m0 in STACK_K4:
        b = STACKS[name][0]
        samples = stack_samples(name)
        panel = randn(b, k, n)
        R, ls, s, ld = k4.panel_factor(panel, m0)
        R0, ls0, s0, ld0 = ref.panel_factor_ref(panel, m0)
        torch.cuda.synchronize()
        tag = f"{b}x{k}x{n}"
        require(same_bits(R, R0) and torch.equal(ls, ls0),
                f"K4 stack {tag}: R or ls not bitwise")
        require(torch.equal(s, s0), f"K4 stack {tag}: signs differ")
        require(torch.allclose(ld, ld0, rtol=LOGDET_RTOL[name_dt], atol=0),
                f"K4 stack {tag}: logdet differs")
        for i in samples:
            R1, ls1, s1, ld1 = k4.panel_factor(panel[i], m0)
            require(same_bits(R[i], R1) and torch.equal(ls[i], ls1)
                    and torch.equal(s[i], s1) and torch.equal(ld[i], ld1),
                    f"K4 stack {tag}: matrix {i} differs from its single "
                    "launch")
        plan = k4.plan(k, n, dt)
        say("kernels", stack=tag, panel_factor_R_ls_bitwise=True,
            samples_bitwise=samples, plan=plan._asdict())
        lu_in = panel[..., :m0].mT.contiguous()
        p0 = panel[0]
        record("panel_factor", tag, b,
               lambda: k4.panel_factor(panel, m0),
               lambda: k4.panel_factor(p0, m0),
               lambda: ref.panel_factor_ref(panel, m0),
               lambda: torch.linalg.lu_factor_ex(lu_in),
               bound_ms(b * (2 * k * n * size + k * 8 + 2 * size),
                        b * k * (n + 2 * k * n + n), name_dt),
               (R - R0).abs().nan_to_num().max().item(),
               plan=plan._asdict())
        del panel, R, R0, lu_in
        torch.cuda.empty_cache()
    return out


def cheb_step_inputs(a, gen):
    """K6's operands at the dense Chebyshev route's second step: ``(w,
    w_prev, v, center, width)`` with ``v`` the Rademacher probes, ``w = B
    v`` and the route's bracket from `spectral_bounds`."""
    from repro_torch import estimators as est
    lo, hi = est.spectral_bounds(est.DenseOperator(a), gen)
    v = est.make_probes(gen, a.shape[0], PROBES, dtype=a.dtype,
                        device=a.device)
    c, wd = (hi + lo).reshape(1), (hi - lo).reshape(1)
    return (2.0 * (a @ v) - c * v) / wd, v, v, c, wd


def cg_step_inputs(a, gen):
    """K7's operands at the dense CG route's first step (Jacobi, x0 = 0,
    seeded right-hand sides): ``(p, x, r, rz)``."""
    import torch
    r = torch.randn(a.shape[0], PROBES, generator=gen, device=a.device,
                    dtype=torch.float64).to(a.dtype)
    z = r / torch.diagonal(a)[:, None]
    return z, torch.zeros_like(r), r, (r * z).sum(0)


def held(step, bound, args, outs) -> float:
    """max over the outputs of |out - exact| / bound: ``exact`` is ``step``
    evaluated in f64 on the same operands, ``bound`` the rounding bound of
    one evaluation in their dtype (`ref.cheb_step_bound` /
    `ref.cg_step_bound`), doubled for f64 operands, where the f64
    evaluation is itself one.  Above 1 is a failure."""
    import torch
    want = step(*(t.double() for t in args))
    factor = 2.0 if args[0].dtype == torch.float64 else 1.0
    tiny = torch.finfo(torch.float64).tiny
    return max(((o.double() - w).abs()
                / (factor * t.double()).clamp_min(tiny)).max().item()
               for o, w, t in zip(outs, want, bound(*args)))


def planted_faults(kind: str, args, outs) -> dict:
    """Outputs of a broken K6/K7 on the same operands, each of which
    `held` must reject: one 32-column chunk of A skipped (the exact step
    without it), the dots zeroed (K6), alpha negated (K7)."""
    import torch
    from repro_torch.kernels import ref
    a = args[0]
    c0 = (a.shape[1] // 2) // 32 * 32
    skipped = a.to(torch.float64, copy=True)
    skipped[:, c0:c0 + 32] = 0
    step = ref.cheb_step_ref if kind == "cheb_step" else ref.cg_step_ref
    faults = {"chunk_skipped": tuple(
        o.to(a.dtype) for o in step(skipped, *(t.double() for t in args[1:])))}
    del skipped
    if kind == "cheb_step":
        faults["dots_zeroed"] = (outs[0], torch.zeros_like(outs[1]))
    else:
        p, x, r, _ = args[1:]
        faults["alpha_negated"] = (2 * x - outs[0], 2 * r - outs[1])
    return faults


def estimator_kernel_phase(n: int, side: int, gen) -> dict:
    """K6 and K7 at the dense cell's shape (n, n) x (n, PROBES) on the
    route's own operands, K8 at the lattice's, each in f32 and f64:
    parity, then times.  Returns ``{kernel: {dtype: fields}}``."""
    import torch
    from repro_torch.kernels import fused_est, matvec, ref
    from repro_torch.kernels import stencil_mv as k8

    k = PROBES
    out = {"cheb_step": {}, "cg_step": {}, "stencil_mv": {}}
    kernels = {"cheb_step": (fused_est.cheb_step, ref.cheb_step_ref,
                             ref.cheb_step_bound, cheb_step_inputs),
               "cg_step": (fused_est.cg_step, ref.cg_step_ref,
                           ref.cg_step_bound, cg_step_inputs)}
    for dt in (torch.float32, torch.float64):
        name_dt = str(dt)[6:]
        size = torch.finfo(dt).bits // 8
        a = dense_spd(n, gen, dt)
        fields, operands = {}, {}
        for name, (kernel, plain, bound, inputs) in kernels.items():
            # K6 / K7 against the f64 step, within the probabilistic
            # rounding bound; the plain version too; each planted fault
            # outside it; a repeated call bitwise equal
            args = (a, *inputs(a, gen))
            got, want = kernel(*args), plain(*args)
            torch.cuda.synchronize()
            rel, plain_rel = (held(plain, bound, args, o) for o in (got, want))
            faults = {f: held(plain, bound, args, o)
                      for f, o in planted_faults(name, args, got).items()}
            require(rel <= 1.0, f"{name} {name_dt}: {rel} of its bound")
            require(plain_rel <= 1.0, f"{name} {name_dt}: the plain version "
                    f"is at {plain_rel} of the bound")
            require(min(faults.values()) > 1.0,
                    f"{name} {name_dt}: a planted fault passes: {faults}")
            again = kernel(*args)
            require(all(torch.equal(g, h) for g, h in zip(got, again)),
                    f"{name} {name_dt}: a repeated call differs")
            err = max((g - w).abs().max().item() for g, w in zip(got, want))
            say("kernels", kernel=name, variant=name_dt, n=n, k=k,
                max_abs_err=err, max_rel_to_bound=rel,
                plain_max_rel_to_bound=plain_rel,
                planted_faults_rel_to_bound=faults, repeat_bitwise=True,
                error_lambda=ref.ERROR_LAMBDA)
            fields[name] = err
            operands[name] = args
            del got, want, again

        # K8 bitwise, slab and vector form, at the lattice's shape
        op = lattice_operator(side, dt)
        xs = torch.randn(op.n, k, generator=gen, device="cuda",
                         dtype=torch.float64).to(dt)
        y8 = k8.stencil_mv(op.bands, xs, op.offsets)
        y80 = ref.stencil_mv_ref(op.bands, xs, offsets=op.offsets)
        xv = xs[:, 0].contiguous()
        torch.cuda.synchronize()
        err8 = (y8 - y80).abs().max().item()
        require(torch.equal(y8, y80), f"K8 {name_dt}: not bitwise, {err8}")
        require(torch.equal(k8.stencil_mv(op.bands, xv, op.offsets),
                            ref.stencil_mv_ref(op.bands, xv,
                                               offsets=op.offsets)),
                f"K8 {name_dt}: vector form not bitwise")
        say("kernels", kernel="stencil_mv", variant=name_dt,
            lattice=[side, side], k=k, bitwise=True)

        nn, nb = op.n, len(op.offsets)
        a6, a7 = operands["cheb_step"], operands["cg_step"]
        csr = lattice_csr(op)
        lib8 = torch.sparse.mm(csr, xs)
        torch.cuda.synchronize()
        say("kernels", kernel="stencil_mv", variant=name_dt,
            library="torch.sparse.mm (CSR)", library_max_abs_diff=(
                lib8 - y80).abs().max().item())
        del lib8
        timings = {
            "cheb_step": dict(
                max_abs_err=fields["cheb_step"],
                ms=time_ms(lambda: fused_est.cheb_step(*a6)),
                plain_ms=time_ms(lambda: ref.cheb_step_ref(*a6)),
                library_ms=None, matmul_ms=time_ms(lambda: a @ a6[1]),
                # K5 alone: the product on the tile K6 shares
                matvec_ms=time_ms(lambda: matvec.matvec(a, a6[1])),
                bound=bound_ms((n * n + 4 * n * k + k) * size,
                               2 * n * n * k + 8 * n * k, name_dt)),
            "cg_step": dict(
                max_abs_err=fields["cg_step"],
                ms=time_ms(lambda: fused_est.cg_step(*a7)),
                plain_ms=time_ms(lambda: ref.cg_step_ref(*a7)),
                library_ms=None, matmul_ms=time_ms(lambda: a @ a7[1]),
                # K5 alone: the product on the tile K7 shares
                matvec_ms=time_ms(lambda: matvec.matvec(a, a7[1])),
                bound=bound_ms((n * n + 5 * n * k + k) * size,
                               2 * n * n * k + 6 * n * k, name_dt)),
            "stencil_mv": dict(
                max_abs_err=err8,
                ms=time_ms(lambda: k8.stencil_mv(op.bands, xs, op.offsets)),
                plain_ms=time_ms(lambda: ref.stencil_mv_ref(
                    op.bands, xs, offsets=op.offsets)),
                library_ms=time_ms(lambda: torch.sparse.mm(csr, xs)),
                matmul_ms=None,
                bound=bound_ms((2 * nn * k + nb * nn) * size,
                               2 * nb * nn * k, name_dt)),
        }
        for name, t in timings.items():
            out[name][name_dt] = t
            say("timing", kernel=name, dtype=name_dt,
                shape=[nn, k] if name == "stencil_mv" else [n, n, k],
                ms=t["ms"], plain_ms=t["plain_ms"],
                library_ms=t["library_ms"], matmul_ms=t["matmul_ms"],
                matvec_ms=t.get("matvec_ms"), bound_ms=t["bound"][0],
                bound_by=t["bound"][1])
        del a, a6, a7, operands, op, xs, y8, y80, csr
        torch.cuda.empty_cache()
    return out


def matvec_phase(n: int, ranks: int, gen) -> dict:
    """K5 at the sharded estimators' shapes: the full (n, n) block (one
    rank) and one rank's (n / ranks, n) block, against a slab of PROBES
    columns, of 64 columns (the widest block of the tile path) and a
    single column, in f32 and f64.  Kernel and plain version each within
    `ref.matvec_bound` of the f64 product (twice it for f64 input, itself
    one evaluation); two planted faults (one 32-column chunk of A
    skipped, a block of output rows zeroed) must break it; a repeated
    call bitwise equal; then times: the kernel's beside cuBLAS's ``a @
    x`` (the plain version and the library call at once), timed in turns
    (library, kernel, kernel, library) and averaged.  Each shape's line
    names its launch plan (`matvec.plan`: tile, split).  Returns
    ``{"<dtype>|<rows>|<k>": fields}``."""
    import torch
    from repro_torch.kernels import matvec as k5
    from repro_torch.kernels import ref

    out = {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dt in (torch.float32, torch.float64):
        name_dt = str(dt)[6:]
        size = torch.finfo(dt).bits // 8
        factor = 2.0 if dt == torch.float64 else 1.0
        full = torch.randn(n, n, generator=gen, device="cuda",
                           dtype=torch.float64).to(dt)
        for rows in (n, n // ranks):
            a = full[:rows]
            a64 = a.double()
            c0 = (n // 2) // 32 * 32
            skipped = a64.clone()
            skipped[:, c0:c0 + 32] = 0
            for k in (PROBES, 64, 1):
                x = torch.randn(n, k, generator=gen, device="cuda",
                                dtype=torch.float64).to(dt)
                exact = a64 @ x.double()
                bound = factor * ref.matvec_bound(a, x).double()
                tiny = torch.finfo(torch.float64).tiny

                def rel(o):
                    return ((o.double() - exact).abs()
                            / bound.clamp_min(tiny)).max().item()

                got, want = k5.matvec(a, x), ref.matvec_ref(a, x)
                zeroed = got.clone()
                zeroed[rows // 2:rows // 2 + 32] = 0
                faults = {"chunk_skipped": rel(skipped @ x.double()),
                          "rows_zeroed": rel(zeroed)}
                torch.cuda.synchronize()
                r_k, r_p = rel(got), rel(want)
                tag = f"{name_dt}|{rows}|{k}"
                require(r_k <= 1.0, f"K5 {tag}: {r_k} of its bound")
                require(r_p <= 1.0, f"K5 {tag}: plain at {r_p} of its bound")
                require(min(faults.values()) > 1.0,
                        f"K5 {tag}: a planted fault passes: {faults}")
                require(torch.equal(k5.matvec(a, x), got),
                        f"K5 {tag}: a repeated call differs")
                plan = k5.plan(rows, n, k, dt, sms)._asdict()
                lib1, ms1, ms2, lib2 = (
                    time_ms(f) for f in (lambda: ref.matvec_ref(a, x),
                                         lambda: k5.matvec(a, x),
                                         lambda: k5.matvec(a, x),
                                         lambda: ref.matvec_ref(a, x)))
                t = dict(max_abs_err=(got - want).abs().max().item(),
                         ms=(ms1 + ms2) / 2, plain_ms=(lib1 + lib2) / 2,
                         library_ms=(lib1 + lib2) / 2, plan=plan,
                         bound=bound_ms((rows * n + n * k + rows * k) * size,
                                        2 * rows * n * k, name_dt),
                         max_rel_to_bound=r_k, plain_max_rel_to_bound=r_p,
                         planted_faults_rel_to_bound=faults)
                out[tag] = t
                say("kernels", kernel="matvec", variant=name_dt,
                    shape=[rows, n, k], plan=plan, max_rel_to_bound=r_k,
                    plain_max_rel_to_bound=r_p,
                    planted_faults_rel_to_bound=faults, repeat_bitwise=True,
                    error_lambda=ref.ERROR_LAMBDA)
                say("timing", kernel="matvec", dtype=name_dt,
                    shape=[rows, n, k], ms=t["ms"], plain_ms=t["plain_ms"],
                    library_ms=t["library_ms"], bound_ms=t["bound"][0],
                    bound_by=t["bound"][1])
            del a64, skipped
        del full
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# phase 4: the main path, end to end
# --------------------------------------------------------------------------

def expected_launches(n: int, k: int, update: str, fused: bool) -> dict:
    from repro_torch.core.engine import stage_schedule
    panels = rank1 = 0
    for size, steps in stage_schedule(n, 0.75, 64):
        if size - steps <= 1:           # last stage: blocked or rank-1
            p = (size - 1) // k if update == "panel" and size > k else 0
            panels, rank1 = panels + p, rank1 + size - 1 - p * k
        elif update == "panel" and steps >= k:
            panels, rank1 = panels + steps // k, rank1 + steps % k
        else:
            rank1 += steps
    return {"rank1_update": 0 if fused else rank1,
            "fused_step": rank1 if fused else 0,
            "panel_update": panels, "panel_factor": panels, "matvec": 0,
            "cheb_step": 0, "cg_step": 0, "stencil_mv": 0}


def main_path_phase(n: int, k: int, gen) -> dict:
    import torch
    import repro_torch
    from repro_torch.kernels import ops

    x = torch.randn(n, n, generator=gen, device="cuda", dtype=torch.float64)
    a64 = x @ x.T / n + 2.0 * torch.eye(n, device="cuda", dtype=torch.float64)
    a64[3] = -a64[3]
    a = a64.to(torch.float32).contiguous()
    del x, a64
    s_ref, ld_ref = torch.linalg.slogdet(a.double())
    s_ref, ld_ref = s_ref.item(), ld_ref.item()
    require(s_ref == -1.0, f"reference sign {s_ref}, expected -1")
    a_before = a.clone()

    routes = [("rank1", False, None), ("rank1", True, None),
              ("panel", False, None), ("panel", True, None),
              ("panel", False, "bf16")]
    # warm-up at a small size (cuBLAS handles, allocator) on a matrix of
    # the same family in f64: each route's sign exact and its log|det|
    # against torch.linalg.slogdet and against the same plan on the CPU
    # (f64: rel 1e-10; bf16 operands: the 5e-3 error model); its launches
    # are not counted
    small = 256
    xs = torch.randn(small, small, generator=gen, device="cuda",
                     dtype=torch.float64)
    xs = xs @ xs.T / small + 2.0 * torch.eye(small, device="cuda",
                                             dtype=torch.float64)
    xs[5] = -xs[5]
    ws, wl = (v.item() for v in torch.linalg.slogdet(xs))
    for update, fused, prec in routes:
        tol = 1e-10 if prec is None else E2E_RTOL[prec]
        kw = dict(method="exact", update=update, k=k, fused=fused,
                  precision=prec)
        s, ld = (v.item() for v in repro_torch.plan(xs, **kw)())
        cs, cl = (v.item() for v in repro_torch.plan(xs.cpu(), device="cpu",
                                                     **kw)())
        require(s == ws == cs and abs(ld - wl) <= tol * abs(wl)
                and abs(ld - cl) <= tol * abs(cl),
                f"warm-up {update} fused={fused} {prec}: card ({s}, {ld}), "
                f"cpu ({cs}, {cl}), slogdet ({ws}, {wl})")
    # a NaN entry: sign NaN and log|det| NaN, never the 0 of "singular"
    xn = xs.to(torch.float32)
    xn[5, 7] = float("nan")
    for update in ("rank1", "panel"):
        s, ld = (v.item() for v in repro_torch.plan(
            xn, method="exact", update=update, k=k)())
        say("main_path", route=f"staged|{update}", n=small, case="nan_entry",
            sign=s, logabsdet=ld)
        require(s != s and ld != ld,
                f"NaN entry, staged|{update}: ({s}, {ld}), expected NaN")

    results = {}
    launches = {}
    walls = {}
    for update, fused, prec in routes:
        name = f"staged|{update}" + ("|fused" if fused else "") \
            + (f"|{prec}" if prec else "")
        p = repro_torch.plan(a, method="exact", update=update, k=k,
                             fused=fused, precision=prec)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        res = p()
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        s, ld = res.sign.item(), res.logabsdet.item()
        rel = abs(ld - ld_ref) / abs(ld_ref)
        want = expected_launches(n, k, update, fused)
        say("main_path", route=name, n=n, sign=s, logabsdet=ld,
            ref_logabsdet=ld_ref, rel_err=rel, rtol=E2E_RTOL[prec],
            wall_s=res.diagnostics.wall_time_s, peak_mem_bytes=peak,
            launches=counts, expected_launches=want)
        require(s == s_ref, f"{name}: sign {s} != {s_ref}")
        require(rel <= E2E_RTOL[prec], f"{name}: rel err {rel}")
        require(counts == want, f"{name}: launches {counts} != {want}")
        results[name] = (res.sign, res.logabsdet)
        launches[name] = counts
        walls[name] = res.diagnostics.wall_time_s
    require(torch.equal(a, a_before), "the caller's tensor was modified")
    for update in ("rank1", "panel"):
        u, f = results[f"staged|{update}"], results[f"staged|{update}|fused"]
        require(torch.equal(u[0], f[0]) and torch.equal(u[1], f[1]),
                f"staged|{update}: fused {f[1].item()!r} != unfused "
                f"{u[1].item()!r}")
    say("main_path", fused_equals_unfused_bitwise=True)
    # phase 7 takes the matrix and the unfused routes' results
    cell = (a, {r: results[r] for r in ("staged|rank1", "staged|panel")})
    return launches, walls, cell


def exact_cell(n: int, gen):
    """The exact cell: x x^T / n + 2 I made in f64, row 3 negated, stored
    in f32; with its f64 slogdet ``(sign, logabsdet)``."""
    import torch
    x = torch.randn(n, n, generator=gen, device=gen.device,
                    dtype=torch.float64)
    a64 = x @ x.T / n + 2.0 * torch.eye(n, device=gen.device,
                                        dtype=torch.float64)
    del x
    a64[3] = -a64[3]
    s_ref, ld_ref = (v.item() for v in torch.linalg.slogdet(a64))
    return a64.to(torch.float32).contiguous(), s_ref, ld_ref


# --------------------------------------------------------------------------
# phase 4b: method="auto" on the port's measured table
# --------------------------------------------------------------------------

def auto_phase(n: int, gen, walls: dict) -> dict:
    """``repro_torch.plan(x)`` with no method: the committed table is the
    card's; the exact cell with ``rtol=1e-6`` takes staged x panel at the
    autotuned width (sign, log|det|, launches), its wall beside phase 4's
    routes; on an SPD matrix of the same side auto takes the route that
    is faster on the card, exact or slq, both measured here (and the
    estimate is checked); the dense estimator cell takes slq, or
    chebyshev with bounds, the lattice slq (each checked against its
    exact reference); the N where the table moves dense SPD input from
    exact to slq.  Returns the launch counts by route."""
    import torch
    import repro_torch
    from repro_torch.core.calibration import (calibration_path, estimator_cost,
                                              exact_cost, load_calibration)
    from repro_torch.core.plan import (ProblemSpec, _BOUNDS_COLS,
                                       _DEFAULT_EST_COLS, select_method,
                                       select_route)
    from repro_torch.kernels import ops
    from repro_torch.kernels.autotune import resolved_panel_k

    cal = load_calibration()
    terms = {f: getattr(cal, f) for f in (
        "gemm_flops", "stream_bytes", "collective_lat", "collective_bytes",
        "gemm_flops_bf16", "host_rank1_row_s", "host_panel_row_s")}
    say("auto", table=str(calibration_path()), source=cal.source, **terms)
    require(cal.source.startswith("measured:cuda"),
            f"the calibration table is {cal.source!r}, not the card's")
    require(all(v is not None and v > 0 for v in terms.values()),
            f"a calibration term is not positive: {terms}")
    launches = {}

    def run(p, **kw):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        res = p(**kw)
        return res, ops.launch_counts()

    # the exact cell, rtol=1e-6
    a, s_ref, ld_ref = exact_cell(n, gen)
    k = resolved_panel_k(n, itemsize=4)
    p = repro_torch.plan(a, rtol=1e-6)
    route = (p.method, p.config.schedule, p.config.update, p.config.k)
    require(route == ("exact", "staged", "panel", k),
            f"auto on the exact cell: {route}, expected staged x panel at "
            f"K = {k}")
    res, counts = run(p)
    s, ld = res.sign.item(), res.logabsdet.item()
    rel = abs(ld - ld_ref) / abs(ld_ref)
    want = expected_launches(p.diagnostics.padded_n, k, "panel", False)
    say("auto", cell="exact", n=n, rtol=1e-6, route=list(route), sign=s,
        logabsdet=ld, ref_logabsdet=ld_ref, rel_err=rel,
        wall_s=res.diagnostics.wall_time_s,
        model_s=exact_cost(n, 1, cal, update="panel", panel_k=k, itemsize=4),
        phase4_walls_s={r: walls[r] for r in ("staged|panel",
                                              "staged|rank1")},
        launches=counts, expected_launches=want)
    require(s == s_ref, f"auto exact cell: sign {s} != {s_ref}")
    require(rel <= E2E_RTOL[None], f"auto exact cell: rel err {rel}")
    require(counts == want, f"auto exact cell: launches {counts} != {want}")
    launches["auto|exact"] = counts
    del a, p, res

    # an SPD matrix of the same side: auto against both routes, measured
    spd = dense_spd(n, gen, torch.float32)
    ref_ld = (2.0 * torch.linalg.cholesky(spd.double()).diagonal().log()
              .sum()).item()
    picked = select_method(spd)
    ex = select_route(spd, rtol=1e-6)[1]
    cols = _DEFAULT_EST_COLS + _BOUNDS_COLS
    model = {"exact": exact_cost(n, 1, cal, update=ex.update,
                                 panel_k=ex.panel_k, itemsize=4),
             "slq": estimator_cost(n, cols, 2.0 * n * n, 1, cal,
                                   itemsize=4)}
    plans = {"exact": repro_torch.plan(spd, method="exact",
                                       schedule=ex.schedule,
                                       update=ex.update, k=ex.panel_k),
             "slq": repro_torch.plan(spd, method="slq")}
    measured, values = {}, {}
    for name in ("exact", "slq", "slq", "exact"):
        res, _ = run(plans[name])
        measured.setdefault(name, []).append(res.diagnostics.wall_time_s)
        values[name] = (res.logabsdet.item(), res.sem.item())
    auto_p = repro_torch.plan(spd)
    res, counts = run(auto_p)
    faster = min(measured, key=lambda r: min(measured[r]))
    est_v, sem = values["slq"]
    tol = N_SEM * sem + EST_RTOL * abs(ref_ld)
    say("auto", cell="dense_spd", n=n, picked=auto_p.method,
        selector=picked, exact_route=[ex.schedule, ex.update, ex.panel_k],
        walls_s=measured, model_s=model, faster=faster,
        auto_wall_s=res.diagnostics.wall_time_s, slq_estimate=est_v,
        slq_sem=sem, exact_logabsdet=values["exact"][0],
        ref_logabsdet=ref_ld, tol=tol, launches=counts)
    require(auto_p.method == picked == faster,
            f"auto on dense SPD N={n} picked {auto_p.method}, the card's "
            f"faster route is {faster} ({measured})")
    require(abs(est_v - ref_ld) <= tol,
            f"slq on dense SPD N={n}: {est_v} vs {ref_ld}, tolerance {tol}")
    require(abs(values["exact"][0] - ref_ld) <= E2E_RTOL[None] * abs(ref_ld),
            f"exact on dense SPD N={n}: {values['exact'][0]} vs {ref_ld}")
    launches["auto|dense_spd"] = counts
    del spd, plans, auto_p, res

    # the dense estimator cell and the lattice: the estimators
    a16 = dense_spd(EST_N, gen, torch.float32)
    ref16 = (2.0 * torch.linalg.cholesky(a16.double()).diagonal().log()
             .sum()).item()
    lattice = lattice_operator(SIDE, torch.float32)
    cells = [("dense", a16, {}, "slq", ref16),
             ("dense", a16, dict(lmin=1.9, lmax=6.5), "chebyshev", ref16),
             ("lattice", lattice, {}, "slq", lattice_logdet(SIDE))]
    for kind, x, kw, want_method, ref in cells:
        p = repro_torch.plan(x, **kw)
        require(p.method == want_method, f"auto on the {kind} cell "
                f"{kw}: {p.method}, expected {want_method}")
        res, counts = run(p)
        v, sem = res.logabsdet.item(), res.sem.item()
        tol = N_SEM * sem + EST_RTOL * abs(ref)
        route = f"{kind}|{want_method}"
        want = expected_estimator_launches(route)
        say("auto", cell=kind, method=p.method, bounds=kw, estimate=v,
            sem=sem, ref_logabsdet=ref, tol=tol,
            wall_s=res.diagnostics.wall_time_s, launches=counts,
            expected_launches=want)
        require(abs(v - ref) <= tol,
                f"auto {route}: {v} vs {ref}, tolerance {tol}")
        require(counts == want, f"auto {route}: launches {counts} != {want}")
        launches[f"auto|{route}"] = counts
    del a16, lattice

    # where the table moves dense SPD f32 input from exact to slq
    def spec(m):
        return ProblemSpec(kind="dense", n=m, batch=None, dtype="float32",
                           matvec_flops=2.0 * m * m)

    lo, hi = 2, 2
    while select_method(spec(hi)) == "exact":
        lo, hi = hi, hi * 2
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if select_method(spec(mid)) == "exact" \
            else (lo, mid)
    ex = select_route(spec(hi), rtol=1e-6)[1]
    say("auto", crossover_n=hi, exact_below=lo,
        exact_route_at_crossover=[ex.schedule, ex.update, ex.panel_k],
        model_exact_s=exact_cost(hi, 1, cal, update=ex.update,
                                 panel_k=ex.panel_k, itemsize=4))
    return launches


# --------------------------------------------------------------------------
# phase 5: the estimators, end to end
# --------------------------------------------------------------------------

def lattice_operator(side: int, dtype, device="cuda"):
    """Q = kappa^2 I + T (x) I + I (x) T, T = tridiag(-1, 2, -1): the
    precision of a Matern (SPDE, alpha = 1) field on a side x side lattice
    with Dirichlet boundary, as five bands (row-major nodes)."""
    import torch
    from repro_torch.estimators import StencilOperator
    n = side * side
    i = torch.arange(n, device=device)
    bands = torch.full((5, n), -1.0, dtype=dtype, device=device)
    bands[2] = 4.0 + KAPPA2
    bands[1] = torch.where(i % side == 0, 0.0, -1.0)
    bands[3] = torch.where(i % side == side - 1, 0.0, -1.0)
    return StencilOperator((-side, -1, 0, 1, side), bands)


def lattice_csr(op):
    """The banded operator as one CSR matrix (built once, outside any
    timing): the yardstick ``torch.sparse.mm`` runs the same product."""
    import torch
    n = op.n
    i = torch.arange(n, device=op.bands.device)
    rows, cols, vals = [], [], []
    for d, off in enumerate(op.offsets):
        keep = (i + off >= 0) & (i + off < n)
        rows.append(i[keep])
        cols.append(i[keep] + off)
        vals.append(op.bands[d][keep])
    coo = torch.sparse_coo_tensor(torch.stack([torch.cat(rows),
                                               torch.cat(cols)]),
                                  torch.cat(vals), (n, n))
    return coo.coalesce().to_sparse_csr()


def lattice_logdet(side: int) -> float:
    """log|Q| in closed form (f64, host): the sum over eigenvalue pairs
    kappa^2 + (2 - 2 cos(i pi / (side + 1))) + (2 - 2 cos(j pi / ...))."""
    import numpy as np
    ev = 2.0 - 2.0 * np.cos(np.arange(1, side + 1) * np.pi / (side + 1))
    return float(np.log(KAPPA2 + ev[:, None] + ev[None, :]).sum())


class PlainOperator:
    """The same operator with every product through the plain PyTorch
    version on the card -- the comparison route, never the main path.
    A duck-typed operator, so Chebyshev and CG run their inline chains
    (the plain versions of K6 and K7) on it."""

    def __init__(self, op):
        self.op, self.shape, self.dtype = op, op.shape, op.dtype
        self.device = op.device

    def mm(self, v):
        from repro_torch.kernels import ref
        if hasattr(self.op, "bands"):
            return ref.stencil_mv_ref(self.op.bands, v,
                                      offsets=self.op.offsets)
        return self.op.a @ v

    def diag(self):
        return self.op.diag()


def expected_estimator_launches(route: str, iters: int = 0) -> dict:
    """K6-K8 launches of one estimator route; K1-K4 launch none."""
    counts = dict.fromkeys(KERNEL_META, 0)
    power = 2 * (32 + 1)        # spectral_bounds: two power iterations
    name = {"dense|chebyshev": ("cheb_step", DEGREE - 1),
            "dense|cg": ("cg_step", iters),
            "lattice|chebyshev": ("stencil_mv", power + 1 + DEGREE - 1),
            "lattice|slq": ("stencil_mv", NUM_STEPS),
            "lattice|cg": ("stencil_mv", iters)}.get(route)
    if name is not None:
        counts[name[0]] = name[1]
    return counts


def estimator_phase(n: int, side: int, seed: int) -> dict:
    import torch
    import repro_torch
    from repro_torch import estimators as est
    from repro_torch.kernels import ops, ref

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    cheb_kw = dict(degree=DEGREE, num_probes=PROBES)
    slq_kw = dict(num_steps=NUM_STEPS, num_probes=PROBES)

    def run_routes(dense, lattice, count: bool) -> dict:
        """The six routes; with ``count`` each is checked in full."""
        launches = {}
        for kind, x in (("dense", dense), ("lattice", lattice)):
            op = est.as_operator(x)
            nn = op.shape[0]
            plain = PlainOperator(op)
            if kind == "dense":
                ref_ld = (2.0 * torch.linalg.cholesky(x.double())
                          .diagonal().log().sum()).item()
            else:
                ref_ld = lattice_logdet(int(round(nn ** 0.5)))
            v = est.make_probes(gen, nn, PROBES, dtype=op.dtype)
            for method, kw in (("chebyshev", cheb_kw), ("slq", slq_kw)):
                route = f"{kind}|{method}"
                p = repro_torch.plan(x, method=method, device=dev, **kw)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                ops.reset_launch_counts()
                res = p(probes=v)
                counts = ops.launch_counts()
                peak = torch.cuda.max_memory_allocated()
                if not count:
                    continue
                est_v, sem = res.logabsdet.item(), res.sem.item()
                tol = N_SEM * sem + EST_RTOL * abs(ref_ld)
                # the plain route: same probes, same bounds (the power
                # iteration of the plan, repeated on the plain operator
                # from the same seed)
                if method == "chebyshev":
                    lo, hi = est.spectral_bounds(
                        plain, est.chebyshev.default_generator(dev, 0))
                    pres = est.logdet_chebyshev(plain, probes=v, lmin=lo,
                                                lmax=hi, device=dev,
                                                **cheb_kw)
                else:
                    pres = est.logdet_slq(plain, probes=v, device=dev,
                                          **slq_kw)
                plain_v = pres.est.item()
                route_rel = abs(est_v - plain_v) / abs(plain_v)
                want = expected_estimator_launches(route)
                say("estimators", route=route, n=nn, estimate=est_v, sem=sem,
                    ref_logabsdet=ref_ld, abs_err=abs(est_v - ref_ld),
                    tol=tol, plain_estimate=plain_v, plain_rel=route_rel,
                    plain_rtol=ROUTE_RTOL[route],
                    plain_bitwise=bool(torch.equal(res.logabsdet, pres.est)),
                    wall_s=res.diagnostics.wall_time_s, peak_mem_bytes=peak,
                    launches=counts, expected_launches=want)
                require(abs(est_v - ref_ld) <= tol,
                        f"{route}: estimate {est_v} vs exact {ref_ld}, "
                        f"tolerance {tol}")
                require(route_rel <= ROUTE_RTOL[route],
                        f"{route}: kernel route {est_v} vs plain {plain_v}")
                require(counts == want,
                        f"{route}: launches {counts} != {want}")
                launches[route] = counts

            route = f"{kind}|cg"
            b = torch.randn(nn, PROBES, generator=gen, device=dev,
                            dtype=op.dtype)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            res = est.cg_solve(x, b, tol=CG_TOL, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = ops.launch_counts()
            peak = torch.cuda.max_memory_allocated()
            if not count:
                continue
            b64, x64 = b.double(), res.x.double()
            if kind == "dense":
                ax = x.double() @ x64
            else:
                ax = ref.stencil_mv_ref(op.bands.double(), x64,
                                        offsets=op.offsets)
            true_res = (torch.linalg.vector_norm(b64 - ax, dim=0)
                        / torch.linalg.vector_norm(b64, dim=0)).max().item()
            rec_res = (res.resnorm / torch.linalg.vector_norm(b, dim=0)) \
                .max().item()
            pres = est.cg_solve(plain, b, tol=CG_TOL, device=dev)
            x_rel = (torch.linalg.vector_norm(res.x - pres.x)
                     / torch.linalg.vector_norm(pres.x)).item()
            want = expected_estimator_launches(route, res.iters)
            say("estimators", route=route, n=nn, iters=res.iters,
                converged=bool(res.converged), recursive_rel_residual=rec_res,
                true_rel_residual_f64=true_res, plain_iters=pres.iters,
                plain_x_rel=x_rel, plain_bitwise=bool(torch.equal(res.x,
                                                                  pres.x)),
                wall_s=wall, peak_mem_bytes=peak, launches=counts,
                expected_launches=want)
            require(bool(res.converged), f"{route}: not converged")
            require(true_res <= CG_RESIDUAL,
                    f"{route}: true residual {true_res}")
            require(x_rel <= CG_X_RTOL, f"{route}: x differs from the plain "
                    f"route by {x_rel}")
            require(counts == want, f"{route}: launches {counts} != {want}")
            launches[route] = counts
        return launches

    # warm-up at a small size of the same two families (handles, cuSOLVER,
    # the allocator); its launches are not counted
    run_routes(dense_spd(512, gen, torch.float32),
               lattice_operator(32, torch.float32), count=False)
    a = dense_spd(n, gen, torch.float32)
    launches = run_routes(a, lattice_operator(side, torch.float32),
                          count=True)
    return launches


def dense_spd(n: int, gen, dtype):
    """x x^T / n + 2 I, made in f64 on the generator's card and stored in
    ``dtype``."""
    import torch
    x = torch.randn(n, n, generator=gen, device=gen.device,
                    dtype=torch.float64)
    a = x @ x.T / n
    del x
    a.diagonal().add_(2.0)
    return a.to(dtype)


# --------------------------------------------------------------------------
# phase 6: the mesh, end to end
# --------------------------------------------------------------------------

def mesh_launches(L: int, P: int, rank: int, k: int, route: str) -> dict:
    """Kernel launches of one mesh route on ``rank``, L rows per rank.

    rank1: K1 = (L - 1) P steps + the P x P tail's P - 1.  panel: R = (L -
    1) // k panels per rank, K4 = R on the owner, K2 = R P on every rank,
    K1 = rem P + P - 1 for the rem = L - 1 - R k remainder rows.  With
    lookahead the owner early-applies every step (K1 on one row) or panel
    (K2 on k rows) after the first that it owns: L - 1 or R, less one on
    rank 0.  The sharded estimators: K5 once per product, 2 (32 + 1) for
    Chebyshev's bounds plus DEGREE, NUM_STEPS for SLQ, one per CG
    iteration.
    """
    counts = dict.fromkeys(KERNEL_META, 0)
    update, _, extra = route.partition("|")
    if update in ("chebyshev", "slq", "cg"):
        counts["matvec"] = {"chebyshev": 2 * (32 + 1) + DEGREE,
                            "slq": NUM_STEPS}.get(update, int(extra or 0))
        return counts
    lookahead = extra == "lookahead"
    r = (L - 1) // k
    if update == "rank1":
        counts["rank1_update"] = (L - 1) * P + P - 1 + lookahead * (
            L - 1 - (rank == 0))
    else:
        counts["panel_factor"] = r
        counts["panel_update"] = r * P + lookahead * (r - (rank == 0))
        counts["rank1_update"] = (L - 1 - r * k) * P + P - 1
    return counts


def mesh_collectives(L: int, P: int, k: int, update: str) -> dict:
    """Collectives of one mesh route per rank: a broadcast per rank-1 step
    ((L - 1) P) or per panel (R P, R = (L - 1) // k) and per remainder
    step, then the tail's all_sum; lookahead issues the same ones."""
    steps = (L - 1) * P
    if update == "panel":
        r = (L - 1) // k
        steps = r * P + (L - 1 - r * k) * P
    return {"broadcast": steps, "all_sum": 1}


def baseline_name(method: str, nb: int) -> str:
    return f"{method}|nb{nb}" if method == "plu" else method


def baseline_launches(n: int, P: int, rank: int, method: str,
                      nb: int) -> dict:
    """Kernel launches of a Gaussian-elimination baseline on ``rank``: ge
    K1 once a step below the last; on the mesh a rank launches while it
    holds rows below the pivot row, i.e. for the steps before its last
    global row g = (n / P - 1) P + rank: pge K1 g times; plu K2 once a
    panel, floor(g / nb), and K1 once a column but the panel's last, g -
    floor(g / nb)."""
    counts = dict.fromkeys(KERNEL_META, 0)
    last = (n // P - 1) * P + rank
    if method == "ge":
        counts["rank1_update"] = n - 1
    elif method == "pge":
        counts["rank1_update"] = last
    else:
        counts["panel_update"] = last // nb
        counts["rank1_update"] = last - last // nb
    return counts


def baseline_collectives(n: int, method: str, nb: int) -> dict:
    """Collectives of a baseline per rank: a step's pivot search and pivot
    row (all_sum) and row t (broadcast); plu's panel gather (all_sum)."""
    if method == "ge":
        return {"broadcast": 0, "all_sum": 0}
    return {"broadcast": n,
            "all_sum": 2 * n + (n // nb if method == "plu" else 0)}


def baseline_routes(mesh, n: int, gen, sync) -> dict:
    """ge, pge and plu (BASELINES) on the exact cell of side n, each
    checked (sign, log|det| against the f64 slogdet, launches and
    collectives against their formulas), then each on a matrix with a
    NaN entry (sign and log|det| NaN)."""
    import torch
    import repro_torch
    from repro_torch.core import mesh as M
    from repro_torch.kernels import ops

    dev, P, me = mesh.device, mesh.size, mesh.rank
    out = {}

    def plan(x, method, nb):
        return repro_torch.plan(x, method=method, mesh=mesh,
                                **({"nb": nb} if method == "plu" else {}))

    # warm-up (handles, solve_triangular) at a small size
    small = torch.randn(64 * P, 64 * P, generator=gen, device=dev,
                        dtype=torch.float64) + 16.0 * P * torch.eye(
        64 * P, device=dev, dtype=torch.float64)
    for method, nb in BASELINES:
        plan(small, method, nb)()
    a, s_ref, ld_ref = exact_cell(n, gen)
    for method, nb in BASELINES:
        name = baseline_name(method, nb)
        p = plan(a, method, nb)
        sync()
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        M.reset_collective_counts()
        t0 = time.perf_counter()
        res = p()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        counts, colls = ops.launch_counts(), M.collective_counts()
        s, ld = res.sign.item(), res.logabsdet.item()
        rel = abs(ld - ld_ref) / abs(ld_ref)
        want = baseline_launches(n, P, me, method, nb)
        want_c = baseline_collectives(n, method, nb)
        out[name] = dict(
            n=n, sign=s, logabsdet=ld, ref_logabsdet=ld_ref, rel_err=rel,
            wall_s=wall, peak_mem_bytes=torch.cuda.max_memory_allocated(dev),
            launches=counts, collectives=colls,
            device_count=p.diagnostics.device_count)
        require(s == s_ref, f"rank {me} {name}: sign {s} != {s_ref}")
        require(rel <= E2E_RTOL[None], f"rank {me} {name}: rel err {rel}")
        require(counts == want,
                f"rank {me} {name}: launches {counts} != {want}")
        require(colls == want_c,
                f"rank {me} {name}: collectives {colls} != {want_c}")
    del a
    b = torch.randn(BASELINE_NAN_N, BASELINE_NAN_N, generator=gen,
                    device=dev, dtype=torch.float32)
    b[5, 7] = float("nan")
    for method, nb in BASELINES:
        name = "nan|" + baseline_name(method, nb)
        res = plan(b, method, nb)()
        s, ld = res.sign.item(), res.logabsdet.item()
        out[name] = dict(n=BASELINE_NAN_N, sign_is_nan=s != s,
                         logabsdet_is_nan=ld != ld)
        require(s != s and ld != ld,
                f"rank {me} {name}: ({s}, {ld}), expected NaN")
    return out


class PlainShardedOperator:
    """A `ShardedOperator` whose local product is the plain version
    (`torch.matmul`) -- the comparison route, never the main path."""

    def __init__(self, op):
        self.op, self.shape, self.dtype = op, op.shape, op.dtype
        self.device = op.device

    def mm(self, v):
        import torch
        from repro_torch.core import mesh as M
        from repro_torch.kernels import ref
        out = torch.empty((self.shape[0], v.shape[1]), dtype=self.dtype,
                          device=self.device)
        return M.gather_rows(self.op.mesh, ref.matvec_ref(self.op.local, v),
                             out)

    def diag(self):
        return self.op.diag()


def mesh_rank(mesh, n: int, k: int, seed: int) -> dict:
    """One rank of phase 6 (a spawned process): the four exact mesh routes
    on the exact cell's N = n matrix, then sharded Chebyshev, SLQ and CG
    on the dense estimator cell's EST_N matrix, every check of the phase
    made here; returns the numbers to print, in plain Python."""
    import torch
    import repro_torch
    from repro_torch import estimators as est
    from repro_torch.core import mesh as M
    from repro_torch.kernels import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    dev, P, me = mesh.device, mesh.size, mesh.rank
    out = {"device": str(dev), "exact": {}, "estimators": {},
           "baselines": {}, "grad": {}, "audit": {}}

    def same_on_every_rank(a, what):
        """The ranks built ``a`` from one seed: an all_reduce of each
        rank's checksums, compared with rank 0's."""
        a64 = a.double()
        rows = torch.arange(a.shape[0], device=dev, dtype=torch.float64)
        sums = torch.zeros((P, 2), dtype=torch.float64, device=dev)
        sums[me, 0] = a64.sum()
        sums[me, 1] = (a64.sum(1) * rows).sum()
        M.all_sum(mesh, sums)
        require(bool((sums == sums[0]).all()),
                f"rank {me}: the ranks' {what} matrices differ: "
                f"{sums.tolist()}")

    def sync():
        M.all_sum(mesh, torch.zeros(1, device=dev))
        torch.cuda.synchronize(dev)

    def run(fn):
        sync()
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        M.reset_collective_counts()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize(dev)
        return (res, time.perf_counter() - t0, ops.launch_counts(),
                torch.cuda.max_memory_allocated(dev))

    routes = [(u, la) for u in ("rank1", "panel") for la in (False, True)]
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    # warm-up of every route at a small size (handles, allocator)
    small = torch.randn(64 * P, 64 * P, generator=gen, device=dev,
                        dtype=torch.float64)
    small = small + 16.0 * P * torch.eye(64 * P, device=dev,
                                         dtype=torch.float64)
    for update, la in routes:
        repro_torch.plan(small, method="exact", update=update, k=k,
                         lookahead=la, mesh=mesh)()

    x = torch.randn(n, n, generator=gen, device=dev, dtype=torch.float64)
    a64 = x @ x.T / n + 2.0 * torch.eye(n, device=dev, dtype=torch.float64)
    a64[3] = -a64[3]
    a = a64.to(torch.float32)
    del x, a64
    same_on_every_rank(a, "exact")
    s_ref, ld_ref = (v.item() for v in torch.linalg.slogdet(a.double()))
    require(s_ref == -1.0, f"reference sign {s_ref}, expected -1")
    results = {}
    for update, la in routes:
        name = update + ("|lookahead" if la else "")
        plan = repro_torch.plan(a, method="exact", update=update, k=k,
                                lookahead=la, mesh=mesh)
        res, wall, counts, peak = run(plan)
        colls = M.collective_counts()
        s, ld = res.sign.item(), res.logabsdet.item()
        rel = abs(ld - ld_ref) / abs(ld_ref)
        want = mesh_launches(n // P, P, me, k, name)
        want_c = mesh_collectives(n // P, P, k, update)
        out["exact"][name] = dict(
            sign=s, logabsdet=ld, ref_logabsdet=ld_ref, rel_err=rel,
            wall_s=wall, peak_mem_bytes=peak, launches=counts,
            collectives=colls, device_count=plan.diagnostics.device_count)
        require(colls == want_c,
                f"rank {me} mesh {name}: collectives {colls} != {want_c}")
        require(s == s_ref, f"rank {me} mesh {name}: sign {s} != {s_ref}")
        require(rel <= E2E_RTOL[None], f"rank {me} mesh {name}: rel {rel}")
        require(counts == want,
                f"rank {me} mesh {name}: launches {counts} != {want}")
        results[name] = (s, ld)
    for update in ("rank1", "panel"):
        require(results[update] == results[f"{update}|lookahead"],
                f"rank {me} mesh {update}: lookahead "
                f"{results[update + '|lookahead']} != plain "
                f"{results[update]}")
    # phase 7 here: mesh x panel's gradient, plain and lookahead, against
    # the single-device plan's; every rank inverts the full matrix, so the
    # backward adds no launch and no collective to the forward's
    single = repro_torch.plan(a, method="exact", update="panel", k=k,
                              device=dev).value_and_grad()[1]
    for la in (False, True):
        name = "panel" + ("|lookahead" if la else "")
        plan = repro_torch.plan(a, method="exact", update="panel", k=k,
                                lookahead=la, mesh=mesh)
        (res, g), wall, counts, peak = run(plan.value_and_grad)
        colls = M.collective_counts()
        want = mesh_launches(n // P, P, me, k, name)
        want_c = mesh_collectives(n // P, P, k, "panel")
        same = bool(torch.equal(g, single))
        out["grad"][f"grad|{name}"] = dict(
            logabsdet=res.logabsdet.item(), grad_sha256=sha256(g),
            equals_single_device=same, wall_s=wall, peak_mem_bytes=peak,
            launches=counts, collectives=colls)
        require(res.logabsdet.item() == results[name][1],
                f"rank {me} grad mesh {name}: value {res.logabsdet.item()} "
                f"!= {results[name][1]}")
        require(same, f"rank {me} grad mesh {name}: gradient differs from "
                "the single-device plan's")
        require(counts == want and colls == want_c,
                f"rank {me} grad mesh {name}: launches {counts}, "
                f"collectives {colls} != {want}, {want_c}")
        del g
    del a, single
    torch.cuda.empty_cache()

    # the paper's baselines: at the exact cell's side on one rank, at
    # BASELINE_SHARED_N on the ranks sharing the card
    out["baselines"] = baseline_routes(
        mesh, n if P == 1 else BASELINE_SHARED_N, gen, sync)
    torch.cuda.empty_cache()
    # phase 12 here: the legacy mesh strings, a planted broadcast and the
    # grid audit on these ranks
    out["audit"] = legacy_mesh(mesh, BASELINE_SHARED_N, k, gen, run)
    out["audit"]["grid"] = grid_on_ranks(mesh)
    torch.cuda.empty_cache()

    # the sharded estimators on the dense estimator cell
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    a = dense_spd(EST_N, gen, torch.float32)
    same_on_every_rank(a, "estimator")
    ref_ld = (2.0 * torch.linalg.cholesky(a.double()).diagonal().log()
              .sum()).item()
    v = est.make_probes(gen, EST_N, PROBES, dtype=a.dtype, device=dev)
    b = torch.randn(EST_N, PROBES, generator=gen, device=dev,
                    dtype=torch.float64).to(a.dtype)
    op = est.ShardedOperator(a, mesh)
    plain = PlainShardedOperator(op)
    for method, kw in (("chebyshev", dict(degree=DEGREE, num_probes=PROBES)),
                       ("slq", dict(num_steps=NUM_STEPS,
                                    num_probes=PROBES))):
        plan = repro_torch.plan(a, method=method, mesh=mesh, **kw)
        res, wall, counts, peak = run(lambda: plan(probes=v))
        if method == "chebyshev":
            lo, hi = est.spectral_bounds(
                plain, est.chebyshev.default_generator(dev, 0))
            pres = est.logdet_chebyshev(plain, probes=v, lmin=lo, lmax=hi,
                                        device=dev, **kw)
        else:
            pres = est.logdet_slq(plain, probes=v, device=dev, **kw)
        est_v, sem, plain_v = (res.logabsdet.item(), res.sem.item(),
                               pres.est.item())
        tol = N_SEM * sem + EST_RTOL * abs(ref_ld)
        route_rel = abs(est_v - plain_v) / abs(plain_v)
        want = mesh_launches(EST_N // P, P, me, k, method)
        out["estimators"][method] = dict(
            estimate=est_v, sem=sem, ref_logabsdet=ref_ld,
            abs_err=abs(est_v - ref_ld), tol=tol, plain_estimate=plain_v,
            plain_rel=route_rel, wall_s=wall, peak_mem_bytes=peak,
            launches=counts, device_count=plan.diagnostics.device_count)
        require(abs(est_v - ref_ld) <= tol, f"rank {me} sharded {method}: "
                f"{est_v} vs exact {ref_ld}, tolerance {tol}")
        require(route_rel <= EST_RTOL, f"rank {me} sharded {method}: "
                f"{est_v} vs plain {plain_v}")
        require(counts == want, f"rank {me} sharded {method}: launches "
                f"{counts} != {want}")
    res, wall, counts, peak = run(lambda: est.cg_solve(op, b, tol=CG_TOL,
                                                       device=dev))
    b64, x64 = b.double(), res.x.double()
    true_res = (torch.linalg.vector_norm(b64 - a.double() @ x64, dim=0)
                / torch.linalg.vector_norm(b64, dim=0)).max().item()
    pres = est.cg_solve(plain, b, tol=CG_TOL, device=dev)
    x_rel = (torch.linalg.vector_norm(res.x - pres.x)
             / torch.linalg.vector_norm(pres.x)).item()
    want = mesh_launches(EST_N // P, P, me, k, f"cg|{res.iters}")
    out["estimators"]["cg"] = dict(
        iters=res.iters, converged=bool(res.converged),
        true_rel_residual_f64=true_res, plain_iters=pres.iters,
        plain_x_rel=x_rel, wall_s=wall, peak_mem_bytes=peak, launches=counts)
    require(bool(res.converged), f"rank {me} sharded cg: not converged")
    require(true_res <= CG_RESIDUAL,
            f"rank {me} sharded cg: true residual {true_res}")
    require(x_rel <= CG_X_RTOL, f"rank {me} sharded cg: x differs from the "
            f"plain route by {x_rel}")
    require(counts == want,
            f"rank {me} sharded cg: launches {counts} != {want}")

    # phase 7 here: sharded Chebyshev's gradient against dense
    # Chebyshev's, the same probes (one seed on this rank's card) and
    # bounds; K5 once per forward product (DEGREE, the bounds given), the
    # backward's transposed products through rmm
    from repro_torch.estimators.chebyshev import default_generator
    kw = dict(method="chebyshev", degree=DEGREE, num_probes=PROBES,
              lmin=CHEB_BOUNDS[0], lmax=CHEB_BOUNDS[1],
              grad_cg_tol=MESH_GRAD_CG_TOL)
    plan = repro_torch.plan(a, mesh=mesh, **kw)
    (res, g), wall, counts, peak = run(lambda: plan.value_and_grad(
        generator=default_generator(dev, seed)))
    dres, dg = repro_torch.plan(a, device=dev, **kw).value_and_grad(
        generator=default_generator(dev, seed))
    rel = (torch.linalg.matrix_norm(g - dg)
           / torch.linalg.matrix_norm(dg)).item()
    want = dict(dict.fromkeys(KERNEL_META, 0), matvec=DEGREE)
    out["grad"]["grad|chebyshev"] = dict(
        estimate=res.logabsdet.item(), grad_sha256=sha256(g),
        cg_iters=res.diagnostics.cg_iters,
        dense_cg_iters=dres.diagnostics.cg_iters, dense_rel=rel,
        rtol=ROUTE_RTOL["dense|chebyshev"], wall_s=wall,
        peak_mem_bytes=peak, launches=counts)
    require(rel <= ROUTE_RTOL["dense|chebyshev"],
            f"rank {me} grad sharded chebyshev: {rel} from dense")
    require(counts == want, f"rank {me} grad sharded chebyshev: launches "
            f"{counts} != {want}")
    return out


def legacy_mesh(mesh, n: int, k: int, gen, run) -> dict:
    """Phase 12 in phase 6's ranks: ``pmc`` and ``pmc_blocked`` on an
    exact-cell matrix of side n (the shared-card size) bitwise their
    ``method="exact"`` mesh plans, with the same launches, under a
    DeprecationWarning; then a broadcast of 2 N P floats recorded on this
    rank's card must break collective-payload-budget."""
    import warnings
    import torch
    import repro_torch
    from repro_torch.analysis import AuditContext, record, run_passes
    from repro_torch.core import mesh as M

    dev, P, me = mesh.device, mesh.size, mesh.rank
    x = torch.randn(n, n, generator=gen, device=dev, dtype=torch.float64)
    a = (x @ x.T / n + 2.0 * torch.eye(n, device=dev,
                                       dtype=torch.float64)).float()
    del x
    out = {}
    for method, update in (("pmc", "rank1"), ("pmc_blocked", "panel")):
        want, _, want_counts, _ = run(repro_torch.plan(
            a, method="exact", update=update, k=k, mesh=mesh))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            plan = repro_torch.plan(a, method=method, k=k, mesh=mesh)
        warned = any(issubclass(w.category, DeprecationWarning)
                     for w in caught)
        got, wall, counts, _ = run(plan)
        same = bool(torch.equal(got.sign, want.sign)
                    and torch.equal(got.logabsdet, want.logabsdet))
        out[method] = dict(n=n, sign=got.sign.item(),
                           logabsdet=got.logabsdet.item(), bitwise=same,
                           warned=warned, wall_s=wall, launches=counts)
        require(same, f"rank {me} legacy {method}: differs from exact")
        require(warned, f"rank {me} legacy {method}: no DeprecationWarning")
        require(counts == want_counts, f"rank {me} legacy {method}: "
                f"launches {counts} != {want_counts}")
    ctx = AuditContext(method="exact", schedule="mesh", update="rank1", n=n,
                       devices=P, itemsize=4, dtype="float32")
    leak = torch.zeros(2 * n * P, dtype=torch.float32, device=dev)
    rep = run_passes(record(M.broadcast, mesh, leak, 0), ctx,
                     ("collective-payload-budget",))
    out["planted_broadcast"] = dict(errors=len(rep.errors),
                                    message=rep.errors[0].message
                                    if rep.errors else None)
    require(not rep.ok, f"rank {me}: the planted broadcast passed the "
            "payload budget")
    return out


def grid_on_ranks(mesh) -> dict:
    """Phase 12(a) in phase 6's ranks: ``audit_grid(n=32, mesh=mesh)``,
    the JAX default grid with its mesh entries on these ranks, clean and
    with the JAX ``passes_run``."""
    from repro_torch.analysis import DEFAULT_PASS_IDS, audit_grid
    t0 = time.perf_counter()
    grid = audit_grid(n=32, mesh=mesh)
    out = dict(ok=grid.ok, findings=len(grid.findings),
               passes_run=grid.passes_run, contexts=len(grid.contexts),
               seconds=time.perf_counter() - t0)
    require(grid.ok and not grid.findings,
            f"rank {mesh.rank}: audit grid not clean:\n{grid.summary()}")
    require(grid.passes_run == list(DEFAULT_PASS_IDS),
            f"rank {mesh.rank}: audit grid passes {grid.passes_run}")
    return out


def mesh_phase(n: int, k: int, seed: int) -> dict:
    """Phase 6: `mesh_rank` on one rank under NCCL, then on MESH_RANKS
    ranks sharing the card under gloo (collectives staged through host
    memory); every rank must return the same results.  Prints each
    rank's routes; returns rank 0's launch counts by route and, for
    phase 12, every rank's grid audit by mesh size."""
    from repro_torch.core.mesh import run_ranks

    launches, grids = {}, {}
    for size, backend in ((1, "nccl"), (MESH_RANKS, "gloo")):
        t0 = time.perf_counter()
        results = run_ranks(mesh_rank, size, backend=backend, device="cuda",
                            timeout=MESH_TIMEOUT, args=(n, k, seed))
        seconds = time.perf_counter() - t0
        for rank, res in enumerate(results):
            for part in PARTS:
                for route, fields in res[part].items():
                    say("mesh", ranks=size, backend=backend, rank=rank,
                        device=res["device"], route=route, **fields)
        first = results[0]
        for rank, res in enumerate(results[1:], 1):
            for part in PARTS:
                for route, fields in res[part].items():
                    for key in ("sign", "logabsdet", "estimate", "sem",
                                "iters", "sign_is_nan",
                                "logabsdet_is_nan", "grad_sha256",
                                "cg_iters"):
                        require(fields.get(key) == first[part][route]
                                .get(key), f"mesh P={size} {route}: rank "
                                f"{rank} {key} differs from rank 0's")
        say("mesh", ranks=size, backend=backend, seconds=seconds,
            ranks_agree=True,
            note=("several ranks share one card; their collectives pass "
                  "through host memory: not a scaling figure")
            if size > 1 else "one rank, NCCL")
        if size == 1:
            # the paper's Table 3 on one card: PMC against GE and LU
            say("table3", n=first["baselines"]["ge"]["n"],
                walls_s={r: first[part][r]["wall_s"] for part, r in (
                    ("exact", "rank1"), ("exact", "panel"),
                    *(("baselines", baseline_name(m, nb))
                      for m, nb in BASELINES))})
        for part in PARTS:
            for route, fields in first[part].items():
                if "launches" in fields:
                    launches[f"mesh{size}|{route}"] = fields["launches"]
        grids[f"{backend}|{size}"] = [r["audit"]["grid"] for r in results]
    return launches, grids


PARTS = ("exact", "estimators", "baselines", "grad", "audit")


# --------------------------------------------------------------------------
# phase 7: gradients
# --------------------------------------------------------------------------

def sha256(t) -> str:
    """Digest of a tensor's bytes: two ranks' gradients compare bitwise."""
    return hashlib.sha256(t.contiguous().cpu().numpy().data).hexdigest()


def timed(fn):
    """``(fn(), seconds)``, the card synchronized before and after."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def counted(fn):
    """``(fn(), seconds, launches)``: the launch counts of ``fn`` alone."""
    from repro_torch.kernels import ops
    import torch
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    out, seconds = timed(fn)
    return out, seconds, ops.launch_counts()


def grad_exact(a, phase4: dict, k: int, gen) -> dict:
    """Phase 7 on the exact cell ``a`` (phase 4's matrix; ``phase4`` its
    staged routes' ``(sign, logabsdet)``): value_and_grad and autograd on
    staged x panel, staged x rank1 and ge."""
    import torch
    import repro_torch

    n = a.shape[0]
    a64 = a.double()
    s_ref, ld_ref = (v.item() for v in torch.linalg.slogdet(a64))
    routes = [("staged|panel", dict(method="exact", update="panel", k=k)),
              ("staged|rank1", dict(method="exact", update="rank1", k=k)),
              ("ge", dict(method="ge"))]
    launches, grads = {}, {}
    for name, kw in routes:
        want = (baseline_launches(n, 1, 0, "ge", 1) if name == "ge"
                else expected_launches(n, k, kw["update"], False))
        p = repro_torch.plan(a, **kw)
        (res, g), _, vag_counts = counted(p.value_and_grad)
        x = a.clone().requires_grad_()
        ld, fwd_s, fwd_counts = counted(lambda: p.logdet(x))
        _, bwd_s, bwd_counts = counted(ld.backward)
        s, ld_v = res.sign.item(), res.logabsdet.item()
        say("grad", route=name, n=n, sign=s, logabsdet=ld_v,
            ref_logabsdet=ld_ref,
            value_and_grad_wall_s=res.diagnostics.wall_time_s,
            forward_wall_s=fwd_s, backward_wall_s=bwd_s,
            launches=vag_counts, forward_launches=fwd_counts,
            backward_launches=bwd_counts, expected_launches=want)
        if name in phase4:
            s4, ld4 = phase4[name]
            require(torch.equal(res.sign, s4)
                    and torch.equal(res.logabsdet, ld4),
                    f"grad {name}: ({s}, {ld_v}) != phase 4's "
                    f"({s4.item()}, {ld4.item()})")
        else:
            require(s == s_ref and abs(ld_v - ld_ref)
                    <= E2E_RTOL[None] * abs(ld_ref),
                    f"grad {name}: ({s}, {ld_v}) vs slogdet ({s_ref}, "
                    f"{ld_ref})")
        require(torch.equal(ld.detach(), res.logabsdet),
                f"grad {name}: autograd forward {ld.item()} != {ld_v}")
        require(vag_counts == want and fwd_counts == want,
                f"grad {name}: launches {vag_counts} / {fwd_counts} != "
                f"{want}")
        require(not any(bwd_counts.values()),
                f"grad {name}: the backward launched {bwd_counts}")
        require(torch.equal(x.grad, g), f"grad {name}: autograd's gradient "
                "differs from value_and_grad's")
        grads[name] = g
        launches[f"grad|{name}|forward"] = fwd_counts
        launches[f"grad|{name}|backward"] = bwd_counts
        del x, ld
    g = grads["staged|panel"]
    for name, other in grads.items():
        require(torch.equal(other, g),
                f"grad {name}: gradient differs from staged|panel's")
    inv_ms = time_ms(lambda: torch.linalg.inv(a), warmup=1, iters=3)
    g64 = g.double()
    eye = torch.eye(n, device=a.device, dtype=torch.float64)
    resid = (torch.linalg.matrix_norm(a64 @ g64.T - eye) / n ** 0.5).item()
    del eye
    e = torch.randn(n, n, generator=gen, device=a.device,
                    dtype=torch.float64) / n ** 0.5
    dd = (g64 * e).sum().item()
    fd = ((torch.linalg.slogdet(a64 + FD_STEP * e)[1]
           - torch.linalg.slogdet(a64 - FD_STEP * e)[1]).item()
          / (2 * FD_STEP))
    # <G, E> has standard deviation ||G||_F / sqrt(N) over E
    scale = abs(fd) + torch.linalg.matrix_norm(g64).item() / n ** 0.5
    say("grad", route="exact", n=n, grads_bitwise_equal=True,
        inverse_ms=inv_ms, residual=resid, residual_bound=INV_RESIDUAL,
        directional=dd, central_difference=fd, fd_step=FD_STEP,
        fd_abs_err=abs(dd - fd), fd_tol=FD_RTOL * scale)
    require(resid <= INV_RESIDUAL, f"grad exact: ||A G^T - I|| / sqrt(N) = "
            f"{resid}")
    require(abs(dd - fd) <= FD_RTOL * scale,
            f"grad exact: <G, E> {dd} vs central difference {fd}")
    return launches


def grad_dense(seed: int) -> dict:
    """Phase 7 on the dense estimator cell: slq, and chebyshev with
    bounds."""
    import torch
    import repro_torch
    from repro_torch import estimators as est
    from repro_torch.estimators.chebyshev import default_generator

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    a = dense_spd(EST_N, gen, torch.float32)
    n, k = EST_N, PROBES
    a64 = a.double()
    inv_t = torch.linalg.inv(a64).T
    op = est.DenseOperator(a)
    launches = {}
    for method, kw in (("slq", dict(num_steps=NUM_STEPS)),
                       ("chebyshev", dict(degree=DEGREE,
                                          lmin=CHEB_BOUNDS[0],
                                          lmax=CHEB_BOUNDS[1]))):
        route = f"dense|{method}"
        p = repro_torch.plan(a, method=method, num_probes=k,
                             grad_cg_tol=GRAD_CG_TOL, **kw)
        call = p(generator=default_generator(dev, seed))
        (res, g), _, vag_counts = counted(
            lambda: p.value_and_grad(generator=default_generator(dev, seed)))
        x = a.clone().requires_grad_()
        ld, fwd_s, fwd_counts = counted(
            lambda: p.logdet(x, generator=default_generator(dev, seed)))
        _, bwd_s, bwd_counts = counted(ld.backward)
        # the backward's two parts on the same probes: the transposed CG,
        # then (g / k) W Z^T
        z = est.shared_probes(method, op, default_generator(dev, seed),
                              {"num_probes": k})
        cg, cg_s = timed(lambda: est.cg_solve(op, z, transpose=True,
                                              tol=GRAD_CG_TOL, device=dev))
        bar, cg2 = est.hutchinson_pullback(op, a, z, 1.0,
                                           cg_tol=GRAD_CG_TOL)
        w, z64 = cg.x.double(), z.double()
        true_res = (torch.linalg.vector_norm(z64 - a64.T @ w, dim=0)
                    / torch.linalg.vector_norm(z64, dim=0)).max().item()
        g64 = g.double()
        err = torch.linalg.matrix_norm(g64 - inv_t).item()
        # per entry: the sample variance of w[i, c] z[j, c] over the probes,
        # z^2 = 1: (sum_c w[i, c]^2 - k G[i, j]^2) / (k - 1)
        sem2 = ((n * (w * w).sum() - k * (g64 * g64).sum())
                / (k * (k - 1))).item()
        bound = 3.0 * sem2 ** 0.5
        want = expected_estimator_launches(route)
        say("grad", route=route, n=n, estimate=res.logabsdet.item(),
            call_estimate=call.logabsdet.item(),
            cg_iters=res.diagnostics.cg_iters, cg_tol=GRAD_CG_TOL,
            true_rel_residual_f64=true_res, grad_err_fro=err,
            three_sem_fro=bound,
            value_and_grad_wall_s=res.diagnostics.wall_time_s,
            forward_wall_s=fwd_s, backward_wall_s=bwd_s, cg_wall_s=cg_s,
            cg_share_of_backward=cg_s / bwd_s, launches=vag_counts,
            forward_launches=fwd_counts, backward_launches=bwd_counts,
            expected_launches=want)
        require(torch.equal(res.logabsdet, call.logabsdet)
                and torch.equal(res.sem, call.sem),
                f"grad {route}: value {res.logabsdet.item()} != __call__'s "
                f"{call.logabsdet.item()}")
        require(vag_counts == want and fwd_counts == want,
                f"grad {route}: launches {vag_counts} / {fwd_counts} != "
                f"{want}")
        require(not any(bwd_counts.values()),
                f"grad {route}: the backward launched {bwd_counts}")
        require(torch.equal(x.grad, g),
                f"grad {route}: autograd's gradient differs")
        require(torch.equal(bar, g) and cg2.iters == res.diagnostics.cg_iters,
                f"grad {route}: hutchinson_pullback differs from "
                "value_and_grad's")
        require(true_res <= GRAD_CG_TOL,
                f"grad {route}: true residual {true_res}")
        require(err <= bound, f"grad {route}: ||G - inv(A)^T|| = {err} > "
                f"3 sem {bound}")
        launches[f"grad|{route}|forward"] = fwd_counts
        launches[f"grad|{route}|backward"] = bwd_counts
        del x, ld, g, bar, g64, w
        torch.cuda.empty_cache()
    return launches


def band_of(dense, offsets):
    """``out[d, i] = dense[i, i + offsets[d]]``, zero outside [0, n)."""
    import torch
    n = dense.shape[0]
    i = torch.arange(n, device=dense.device)
    out = torch.zeros((len(offsets), n), dtype=dense.dtype,
                      device=dense.device)
    for d, off in enumerate(offsets):
        keep = (i + off >= 0) & (i + off < n)
        out[d, keep] = dense[i[keep], i[keep] + off]
    return out


def in_band(op):
    """(nb, n) mask of the band entries whose column lies in [0, n)."""
    import torch
    i = torch.arange(op.n, device=op.bands.device)
    return torch.stack([(i + off >= 0) & (i + off < op.n)
                        for off in op.offsets])


def grad_lattice(seed: int) -> dict:
    """Phase 7 on the lattice (slq), and on a SMALL_SIDE^2 lattice against
    a dense f64 inverse."""
    import torch
    import repro_torch
    from repro_torch import estimators as est
    from repro_torch.estimators.chebyshev import default_generator
    from repro_torch.kernels import ref

    dev = "cuda"
    kw = dict(method="slq", num_steps=NUM_STEPS, num_probes=PROBES,
              grad_cg_tol=GRAD_CG_TOL)
    op = lattice_operator(SIDE, torch.float32)
    n, route = op.n, "lattice|slq"
    p = repro_torch.plan(op, **kw)
    call = p(generator=default_generator(dev, seed))
    (res, g), _, vag_counts = counted(
        lambda: p.value_and_grad(generator=default_generator(dev, seed)))
    iters = res.diagnostics.cg_iters
    b = op.bands.clone().requires_grad_()
    pg = repro_torch.plan(est.StencilOperator(op.offsets, b), **kw)
    ld, fwd_s, fwd_counts = counted(
        lambda: pg.logdet(generator=default_generator(dev, seed)))
    _, bwd_s, bwd_counts = counted(ld.backward)
    want_fwd = expected_estimator_launches(route)
    want_bwd = dict(dict.fromkeys(KERNEL_META, 0), stencil_mv=iters + 1)
    want = dict(want_fwd, stencil_mv=NUM_STEPS + iters + 1)
    # the same pullback with the bilinear apply through the plain
    # ref.stencil_mv_ref on the card (check only): the same CG, then
    # autograd's band cotangent; the two sum k products in their own
    # orders, within 2 k eps sum_c |w2[i, c] z[i + off, c]| (z = +-1)
    z = est.shared_probes("slq", op, default_generator(dev, seed),
                          {"num_probes": PROBES})
    plain = est.OperatorGradInfo(
        params=lambda o: o.bands,
        rebuild=lambda o, bb: est.StencilOperator(o.offsets, bb),
        apply=lambda o, bb, zz: ref.stencil_mv_ref(bb, zz,
                                                   offsets=o.offsets))
    bar, cg = est.hutchinson_pullback(op, op.bands, z, 1.0, info=plain,
                                      cg_tol=GRAD_CG_TOL)
    eps = torch.finfo(torch.float32).eps
    tol = (2 * PROBES * eps * (cg.x.abs() / PROBES).sum(1))[None, :]         * in_band(op)
    excess = ((g - bar).abs() - tol).max().item()
    say("grad", route=route, n=n, estimate=res.logabsdet.item(),
        call_estimate=call.logabsdet.item(), cg_iters=iters,
        grad_shape=list(g.shape), plain_bitwise=bool(torch.equal(g, bar)),
        plain_max_abs_diff=(g - bar).abs().max().item(),
        value_and_grad_wall_s=res.diagnostics.wall_time_s,
        forward_wall_s=fwd_s, backward_wall_s=bwd_s, launches=vag_counts,
        forward_launches=fwd_counts, backward_launches=bwd_counts,
        expected_backward_launches=want_bwd)
    require(torch.equal(res.logabsdet, call.logabsdet),
            f"grad {route}: value {res.logabsdet.item()} != __call__'s")
    require(tuple(g.shape) == (5, n) and bool(torch.isfinite(g).all()),
            f"grad {route}: band gradient {tuple(g.shape)} or not finite")
    require(vag_counts == want and fwd_counts == want_fwd
            and bwd_counts == want_bwd,
            f"grad {route}: launches {vag_counts}, {fwd_counts}, "
            f"{bwd_counts} != {want}, {want_fwd}, {want_bwd}")
    require(torch.equal(b.grad, g),
            f"grad {route}: autograd's gradient differs")
    require(cg.iters == iters and excess <= 0.0,
            f"grad {route}: the plain pullback differs beyond its bound "
            f"({excess} over)")
    launches = {f"grad|{route}|forward": fwd_counts,
                f"grad|{route}|backward": bwd_counts}
    del op, b, ld, g, bar, z, cg, pg, p
    torch.cuda.empty_cache()

    small = lattice_operator(SMALL_SIDE, torch.float32)
    res, g = repro_torch.plan(small, **kw).value_and_grad(
        generator=default_generator(dev, seed))
    want_g = band_of(torch.linalg.inv(small.to_dense().double()).T,
                     small.offsets)
    z = est.shared_probes("slq", small, default_generator(dev, seed),
                          {"num_probes": PROBES})
    _, cg = est.hutchinson_pullback(small, small.bands, z, 1.0,
                                    cg_tol=GRAD_CG_TOL)
    w2 = (cg.x.double() ** 2).sum(1)[None, :]
    g64 = g.double()
    var = (w2 - PROBES * g64 * g64) / (PROBES - 1) * in_band(small)
    bound = 3.0 * (var.sum() / PROBES).item() ** 0.5
    err = torch.linalg.vector_norm(g64 - want_g).item()
    say("grad", route=f"lattice{SMALL_SIDE}|slq", n=small.n,
        cg_iters=res.diagnostics.cg_iters, grad_err_fro=err,
        three_sem_fro=bound)
    require(err <= bound, f"grad lattice{SMALL_SIDE}: ||G - band(inv(A)^T)|| "
            f"= {err} > 3 sem {bound}")
    return launches


def grad_phase(cell, k: int, seed: int, gen) -> dict:
    """Phase 7 on one card; returns its launch counts by route."""
    a, phase4 = cell
    launches = grad_exact(a, phase4, k, gen)
    launches.update(grad_dense(seed))
    launches.update(grad_lattice(seed))
    return launches


# --------------------------------------------------------------------------
# phase 8: stacks, end to end
# --------------------------------------------------------------------------

def stack_cell(b: int, n: int, gen, negate: bool = True):
    """B matrices x x^T / n + 2 I made in f64 on the card, matrix 1's row 3
    negated (sign -1) if ``negate``; stored in f32, with the f64 slogdet
    of each matrix."""
    import torch
    x = torch.randn(b, n, n, generator=gen, device="cuda",
                    dtype=torch.float64)
    a = x @ x.mT / n
    del x
    a.diagonal(dim1=-2, dim2=-1).add_(2.0)
    if negate:
        a[1, 3] = -a[1, 3]
    s, ld = torch.linalg.slogdet(a)
    return a.to(torch.float32).contiguous(), s, ld


def stack_routes(k: int) -> dict:
    """Phase 8's exact routes on a stack: route name -> plan keywords."""
    return {"staged|rank1": dict(method="exact"),
            "serial|rank1": dict(method="exact", schedule="serial",
                                 update="rank1"),
            "serial|panel": dict(method="exact", schedule="serial",
                                 update="panel", k=k),
            "staged|rank1|fused": dict(method="exact", fused=True),
            "staged|panel|bf16": dict(method="exact", update="panel", k=k,
                                      precision="bf16"),
            "staged|panel": dict(method="exact", update="panel", k=k),
            "ge": dict(method="ge")}


def stack_expected_launches(route: str, n: int, k: int) -> dict:
    """K1-K4 launches of a route on a stack of side n: one matrix's
    formula, whatever the stack's size (panel routes pad n to a multiple
    of k)."""
    if route == "ge":
        return baseline_launches(n, 1, 0, "ge", 1)
    update = "panel" if "panel" in route else "rank1"
    fused = "fused" in route
    n_p = -(-n // k) * k if update == "panel" else n
    if route.startswith("staged"):
        return expected_launches(n_p, k, update, fused)
    panels = (n_p - 1) // k if update == "panel" and n_p > k else 0
    rank1 = n_p - 1 - panels * k
    counts = dict.fromkeys(KERNEL_META, 0)
    counts.update(rank1_update=0 if fused else rank1,
                  fused_step=rank1 if fused else 0, panel_update=panels,
                  panel_factor=panels)
    return counts


def stack_route(cell: str, route: str, kw: dict, a, s_ref, ld_ref,
                k: int) -> dict:
    """One exact route on a stack: sign exact and log|det| within E2E_RTOL
    of each matrix's f64 slogdet, the launches of one matrix's formula,
    matrix b against the single-matrix plan on it at `stack_samples`
    (bitwise; panel routes within STACK_PANEL_RTOL, bitwise or not
    reported), and the wall beside B times the fastest single wall.
    Returns the phase's fields (``launches``, ``result``)."""
    import torch
    import repro_torch
    from repro_torch.kernels import ops

    b, n = a.shape[0], a.shape[-1]
    p = repro_torch.plan(a, **kw)
    p()                                           # warm-up
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    res = p()
    counts = ops.launch_counts()
    prec = kw.get("precision")
    want = stack_expected_launches(route, n, k)
    rel = ((res.logabsdet.double() - ld_ref).abs() / ld_ref.abs()).max()
    rel = rel.item()
    bitwise, walls, worst = True, [], 0.0
    for i in stack_samples(cell):
        one = repro_torch.plan(a[i], **kw)()
        walls.append(one.diagnostics.wall_time_s)
        same = (torch.equal(res.sign[i], one.sign)
                and torch.equal(res.logabsdet[i], one.logabsdet))
        bitwise = bitwise and same
        worst = max(worst, abs(res.logabsdet[i].item()
                               - one.logabsdet.item())
                    / abs(one.logabsdet.item()))
    say("stacks", cell=cell, route=route, shape=[b, n, n],
        wall_s=res.diagnostics.wall_time_s, single_wall_s=min(walls),
        b_times_single_s=b * min(walls), max_rel_err=rel,
        rtol=E2E_RTOL[prec], samples=stack_samples(cell),
        samples_bitwise=bitwise, samples_max_rel_diff=worst,
        launches=counts, expected_launches=want)
    require(torch.equal(res.sign, s_ref.to(res.sign.dtype)),
            f"stack {cell} {route}: a sign differs from the f64 slogdet's")
    require(rel <= E2E_RTOL[prec], f"stack {cell} {route}: rel err {rel}")
    require(counts == want, f"stack {cell} {route}: launches {counts} != "
            f"{want}")
    if "panel" in route:
        require(worst <= STACK_PANEL_RTOL,
                f"stack {cell} {route}: matrix b {worst} from its single "
                "plan")
    else:
        require(bitwise, f"stack {cell} {route}: matrix b differs from "
                "its single plan")
    return dict(launches=counts, result=res, wall=res.diagnostics.wall_time_s)


def stack_estimators(a, seed: int) -> dict:
    """The large SPD stack through `BatchedOperator`: slq, and chebyshev
    with bounds, each matrix within N_SEM sem + EST_RTOL of its f64
    Cholesky log|det|; cg_solve with a (B, n, PROBES) right-hand side
    under CG_RESIDUAL; no kernel launched (K6/K7 take one matrix)."""
    import torch
    import repro_torch
    from repro_torch import estimators as est
    from repro_torch.estimators.chebyshev import default_generator

    b, n = a.shape[0], a.shape[-1]
    ref = 2.0 * torch.linalg.cholesky(a.double()).diagonal(
        dim1=-2, dim2=-1).log().sum(-1)
    launches = {}
    for method, kw in (("slq", dict(num_steps=NUM_STEPS)),
                       ("chebyshev", dict(degree=DEGREE,
                                          lmin=CHEB_BOUNDS[0],
                                          lmax=CHEB_BOUNDS[1]))):
        p = repro_torch.plan(a, method=method, num_probes=PROBES, **kw)
        res, secs, counts = counted(
            lambda: p(generator=default_generator("cuda", seed)))
        err = (res.logabsdet.double() - ref).abs()
        tol = N_SEM * res.sem.double() + EST_RTOL * ref.abs()
        say("stacks", cell="large", route=f"batched|{method}",
            shape=[b, n, n], wall_s=secs, max_err=err.max().item(),
            max_err_over_tol=(err / tol).max().item(),
            sem=res.sem.tolist(), launches=counts)
        require(bool((err <= tol).all()),
                f"stack large batched|{method}: outside N_SEM sem + EST_RTOL")
        require(not any(counts.values()),
                f"stack large batched|{method}: launched {counts}")
        launches[f"stack|large|batched|{method}"] = counts
    rhs = torch.randn(b, n, PROBES, generator=default_generator("cuda",
                                                                seed + 1),
                      device="cuda", dtype=torch.float32)
    cg, secs, counts = counted(lambda: est.cg_solve(a, rhs, tol=CG_TOL))
    a64, x64, r64 = a.double(), cg.x.double(), rhs.double()
    true_res = (torch.linalg.vector_norm(r64 - a64 @ x64, dim=-2)
                / torch.linalg.vector_norm(r64, dim=-2)).max().item()
    say("stacks", cell="large", route="batched|cg", rhs=[b, n, PROBES],
        iters=cg.iters, wall_s=secs, true_rel_residual_f64=true_res,
        launches=counts)
    require(true_res <= CG_RESIDUAL, f"stack large cg: residual {true_res}")
    require(not any(counts.values()), f"stack large cg: launched {counts}")
    launches["stack|large|batched|cg"] = counts
    return launches


def stack_nan(a, k: int) -> None:
    """A NaN entry in matrix 5 of an 8-matrix stack: that matrix's sign
    and log|det| NaN, every other one its single-matrix result (panel:
    within STACK_PANEL_RTOL)."""
    import torch
    import repro_torch
    st = a[:8].clone()
    st[5, 7, 11] = float("nan")
    for route in ("staged|rank1", "serial|panel", "ge"):
        kw = stack_routes(k)[route]
        res = repro_torch.plan(st, **kw)()
        worst = 0.0
        for i in range(8):
            if i == 5:
                continue
            one = repro_torch.plan(st[i], **kw)()
            require(torch.equal(res.sign[i], one.sign),
                    f"stack nan {route}: matrix {i}'s sign changed")
            diff = abs(res.logabsdet[i].item() - one.logabsdet.item())
            worst = max(worst, diff / abs(one.logabsdet.item()))
            require(diff == 0 or ("panel" in route and worst
                                  <= STACK_PANEL_RTOL),
                    f"stack nan {route}: matrix {i} changed by {diff}")
        s5, l5 = res.sign[5].item(), res.logabsdet[5].item()
        say("stacks", cell="nan", route=route, shape=list(st.shape),
            nan_matrix=[s5, l5], others_max_rel_diff=worst)
        require(s5 != s5 and l5 != l5,
                f"stack nan {route}: matrix 5 gave ({s5}, {l5})")


def stack_grads(ubm, ubm_results: dict, spd, k: int, seed: int) -> dict:
    """value_and_grad on stacks: exact serial x panel and ge on the UBM
    stack (values bitwise the forward's, G bitwise across the routes,
    ||A_b G_b^T - I||_F / sqrt(n) under INV_RESIDUAL, no launch in the
    backward); slq on the large SPD stack, each G_b within 3 sqrt(sum
    sem^2) of inv(A_b)^T, K7 never launched."""
    import torch
    import repro_torch
    from repro_torch import estimators as est
    from repro_torch.estimators.chebyshev import default_generator

    launches, grads = {}, {}
    n = ubm.shape[-1]
    eye = torch.eye(n, device="cuda", dtype=torch.float64)
    for route in ("serial|panel", "ge"):
        kw = stack_routes(k)[route]
        p = repro_torch.plan(ubm, **kw)
        (res, g), secs, counts = counted(p.value_and_grad)
        fwd = ubm_results[route]
        resid = (torch.linalg.matrix_norm(ubm.double() @ g.double().mT - eye)
                 / n ** 0.5).max().item()
        want = stack_expected_launches(route, n, k)
        say("stacks", cell="ubm", route=f"grad|{route}", wall_s=secs,
            max_inv_residual=resid, launches=counts, expected_launches=want)
        require(torch.equal(res.logabsdet, fwd.logabsdet)
                and torch.equal(res.sign, fwd.sign),
                f"stack grad {route}: value differs from the forward's")
        require(resid <= INV_RESIDUAL, f"stack grad {route}: {resid}")
        require(counts == want, f"stack grad {route}: launches {counts}")
        grads[route] = g
        launches[f"stack|ubm|grad|{route}"] = counts
    require(torch.equal(grads["serial|panel"], grads["ge"]),
            "stack grad: the routes' gradients differ")

    b, n = spd.shape[0], spd.shape[-1]
    kk = PROBES
    p = repro_torch.plan(spd, method="slq", num_steps=NUM_STEPS,
                         num_probes=kk, grad_cg_tol=GRAD_CG_TOL)
    (res, g), secs, counts = counted(
        lambda: p.value_and_grad(generator=default_generator("cuda", seed)))
    op = est.BatchedOperator(spd)
    z = est.shared_probes("slq", op, default_generator("cuda", seed),
                          {"num_probes": kk})
    w = est.cg_solve(op, z, transpose=True, tol=GRAD_CG_TOL).x.double()
    g64 = g.double()
    err = torch.linalg.matrix_norm(g64 - torch.linalg.inv(
        spd.double()).mT)
    sem2 = ((n * (w * w).sum((-2, -1)) - kk * (g64 * g64).sum((-2, -1)))
            / (kk * (kk - 1)))
    bound = 3.0 * sem2.sqrt()
    say("stacks", cell="large", route="grad|batched|slq", wall_s=secs,
        cg_iters=res.diagnostics.cg_iters, grad_err_fro=err.tolist(),
        three_sem_fro=bound.tolist(), launches=counts)
    require(bool((err <= bound).all()),
            "stack grad slq: ||G - inv(A)^T|| above 3 sem")
    require(not any(counts.values()), f"stack grad slq: launched {counts}")
    launches["stack|large|grad|batched|slq"] = counts
    return launches


def stack_twin() -> None:
    """examples/gmm_fit_torch.py: 5 SGD steps on the card at dim 60, 64
    components, 4096 samples, exact and slq: every nll finite and the
    last below the first."""
    import math
    sys.path.insert(0, str(ROOT / "examples"))
    import gmm_fit_torch
    for method in ("exact", "slq"):
        h = gmm_fit_torch.train(dim=60, components=64, samples=4096,
                                steps=5, method=method, device="cuda",
                                log_every=0)
        nll = h["nll"].tolist()
        say("stacks", cell="gmm_fit_torch", method=method, dim=60,
            components=64, samples=4096, nll=nll,
            ld_gap=h["ld_gap"].tolist(), step_s=h["step_s"].tolist())
        require(all(math.isfinite(v) for v in nll) and nll[-1] < nll[0],
                f"gmm_fit_torch {method}: nll {nll}")


def stacks_phase(seed: int) -> dict:
    """Phase 8; returns its launch counts by route."""
    import torch
    import repro_torch
    from repro_torch.core.calibration import exact_cost, load_calibration
    from repro_torch.kernels import ops
    from repro_torch.kernels.autotune import resolved_panel_k

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed + 8)
    launches = {}
    b, n = STACKS["ubm"]
    k = resolved_panel_k(n, itemsize=4)
    ubm, s_ref, ld_ref = stack_cell(b, n, gen)
    results = {}
    for route, kw in stack_routes(k).items():
        if route == "staged|panel":     # at n = 60, serial x panel's run
            continue
        out = stack_route("ubm", route, kw, ubm, s_ref, ld_ref, k)
        launches[f"stack|ubm|{route}"] = out["launches"]
        results[route] = out["result"]
        results[route + "|wall"] = out["wall"]
    # method="auto" on the stack, beside the two serial routes it prices
    cal = load_calibration()
    p = repro_torch.plan(ubm)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    res = p()
    counts = ops.launch_counts()
    walls = {r: results[r + "|wall"] for r in ("serial|rank1",
                                               "serial|panel")}
    model = {r: exact_cost(n, 1, cal, update=r.split("|")[1], panel_k=k,
                           itemsize=4, batch=b) for r in walls}
    picked = (p.method, p.config.schedule, p.config.update, p.config.k) \
        if p.method == "exact" else (p.method,)
    say("stacks", cell="ubm", route="auto", picked=list(picked),
        walls_s=walls, model_s=model, faster=min(walls, key=walls.get),
        auto_wall_s=res.diagnostics.wall_time_s, launches=counts)
    require(p.method == "exact" and p.config.schedule == "serial",
            f"auto on the UBM stack: {picked}")
    require(torch.equal(res.sign, s_ref.to(res.sign.dtype)),
            "auto on the UBM stack: a sign differs")
    launches["stack|ubm|auto"] = counts
    stack_nan(ubm, k)
    k_ubm, t_ubm = k, time.perf_counter() - t0

    b, n = STACKS["large"]
    k = resolved_panel_k(n, itemsize=4)
    spd, _, _ = stack_cell(b, n, gen, negate=False)
    a = spd.clone()
    a[1, 3] = -a[1, 3]
    s64, ld64 = torch.linalg.slogdet(a.double())
    for route in ("staged|rank1", "staged|panel"):
        out = stack_route("large", route, stack_routes(k)[route], a, s64,
                          ld64, k)
        launches[f"stack|large|{route}"] = out["launches"]
    del a, s64, ld64
    launches.update(stack_estimators(spd, seed))
    launches.update(stack_grads(ubm, results, spd, k_ubm, seed))
    del spd, ubm, results
    torch.cuda.empty_cache()
    stack_twin()
    say("stacks", seconds=time.perf_counter() - t0, ubm_seconds=t_ubm)
    return launches


# --------------------------------------------------------------------------
# phase 9: structured operators at full size
# --------------------------------------------------------------------------

# Kronecker A (x) B of two KRON_SIDE-sided factors x x^T / (2 side) + 2 I,
# x (side, 2 side) from the seed (benchmarks/estimators_bench.py:
# make_operator's family); the AR(1) Toeplitz c_k = AR_RHO^k of side
# TOEPLITZ_N (spectrum in [1/3, 3] at rho = 0.5)
KRON_SIDE, TOEPLITZ_N, AR_RHO = 1024, 1 << 20, 0.5
# the gmm_loglik.py twin: one EM run each way at this dimension
TWIN_DIM, TWIN_ITERS = 512, 5


def kron_factor(side: int, gen):
    """x x^T / (2 side) + 2 I in f64, x (side, 2 side) from ``gen``."""
    import torch
    x = torch.randn(side, 2 * side, generator=gen, device=gen.device,
                    dtype=torch.float64)
    a = x @ x.T / (2 * side)
    a.diagonal().add_(2.0)
    return a


def structured_cells(gen):
    """name -> (f32 operator on the card, f64 operator, exact log|det|,
    closed-form gradient of log|det| in the operator's parameters, the
    spectrum's bounds in closed form: the products of the factors'
    extreme eigenvalues, and the AR(1) symbol's range [(1 - rho) / (1 +
    rho), (1 + rho) / (1 - rho)])."""
    import math
    import torch
    from repro_torch import estimators as est
    a64, b64 = kron_factor(KRON_SIDE, gen), kron_factor(KRON_SIDE, gen)
    na = nb = KRON_SIDE
    ld = (nb * 2.0 * torch.log(torch.linalg.cholesky(a64).diagonal()).sum()
          + na * 2.0 * torch.log(torch.linalg.cholesky(b64).diagonal()).sum())
    kron_grad = (nb * torch.linalg.inv(a64).T, na * torch.linalg.inv(b64).T)
    ea, eb = torch.linalg.eigvalsh(a64), torch.linalg.eigvalsh(b64)
    kron_bounds = ((ea[0] * eb[0]).item(), (ea[-1] * eb[-1]).item())
    n, rho = TOEPLITZ_N, AR_RHO
    c64 = rho ** torch.arange(n, device="cuda", dtype=torch.float64)
    # T^{-1} of AR(1) is tridiagonal: d/dc_0 = tr(T^{-1}), d/dc_1 = the sum
    # over both first off-diagonals, 0 beyond
    g = torch.zeros(n, device="cuda", dtype=torch.float64)
    g[0] = (2 + (n - 2) * (1 + rho ** 2)) / (1 - rho ** 2)
    g[1] = -2 * rho * (n - 1) / (1 - rho ** 2)
    return {
        "kron": (est.KroneckerOperator(a64.float(), b64.float()),
                 est.KroneckerOperator(a64, b64), ld.item(), kron_grad,
                 kron_bounds),
        "toeplitz": (est.ToeplitzOperator(c64.float()),
                     est.ToeplitzOperator(c64),
                     (n - 1) * math.log(1 - rho ** 2), (g,),
                     ((1 - rho) / (1 + rho), (1 + rho) / (1 - rho))),
    }


def probe_samples(name: str, op64, w, z):
    """Per-probe samples of the Hutchinson pullback (f64), flattened: the
    Kronecker factors' ``W_c B Z_c^T`` and ``W_c^T A Z_c``, the symmetric
    Toeplitz column's cross-correlation ``sum_i w[i] z[i + k] + w[i + k]
    z[i]`` (k >= 1; k = 0 once)."""
    import torch
    k = z.shape[1]
    if name == "kron":
        na, nb = op64.na, op64.nb
        wc = w.T.reshape(k, na, nb)
        zc = z.T.reshape(k, na, nb)
        s_a = wc @ op64.b @ zc.mT
        s_b = wc.mT @ op64.a @ zc
        return torch.cat([s_a.reshape(k, -1), s_b.reshape(k, -1)], dim=1)
    n = w.shape[0]
    wf = torch.fft.rfft(w, n=2 * n, dim=0)
    zf = torch.fft.rfft(z, n=2 * n, dim=0)
    fwd = torch.fft.irfft(wf.conj() * zf, n=2 * n, dim=0)[:n]   # w[i] z[i+k]
    bwd = torch.fft.irfft(zf.conj() * wf, n=2 * n, dim=0)[:n]   # z[i] w[i+k]
    s = fwd + bwd
    s[0] = fwd[0]
    return s.T


def structured_grad(name, op, op64, grad_ref, seed: int) -> dict:
    """value_and_grad of slq on ``op`` against the closed form, within 3
    sqrt(sum sem^2) of the probe noise (phase 7's bound: the per-entry
    sample variance of the pullback over the probes, summed)."""
    import torch
    import repro_torch
    from repro_torch import estimators as est
    from repro_torch.estimators.chebyshev import default_generator
    p = repro_torch.plan(op, method="slq", num_steps=NUM_STEPS,
                         num_probes=PROBES, grad_cg_tol=GRAD_CG_TOL)
    (res, bar), seconds, counts = counted(
        lambda: p.value_and_grad(generator=default_generator("cuda", seed)))
    if name == "toeplitz":
        # one column serves as c and r: both halves of the cotangent
        bar = (bar[0] + bar[1],)
    z = est.shared_probes("slq", op, default_generator("cuda", seed),
                          {"num_probes": PROBES})
    cg = est.cg_solve(op, z, transpose=True, tol=GRAD_CG_TOL)
    s = probe_samples(name, op64, cg.x.double(), z.double())
    k = s.shape[0]
    mean = s.mean(0)
    sem2 = ((s * s).sum() - k * (mean * mean).sum()).item() / (k * (k - 1))
    err = torch.sqrt(sum(((b.double() - r) ** 2).sum()
                         for b, r in zip(bar, grad_ref))).item()
    bound = 3.0 * sem2 ** 0.5
    fields = dict(cg_iters=res.diagnostics.cg_iters, grad_err=err,
                  three_sem=bound, seconds=seconds, launches=counts)
    entries = []
    if name == "toeplitz":
        # the two nonzero entries, each within N_SEM of its own sem
        sem_k = ((s[:, :2] ** 2).sum(0) - k * mean[:2] ** 2) / (k * (k - 1))
        for j in (0, 1):
            got, want = bar[0][j].item(), grad_ref[0][j].item()
            tol = N_SEM * sem_k[j].sqrt().item()
            fields.update({f"dc{j}": got, f"dc{j}_ref": want,
                           f"dc{j}_tol": tol})
            entries.append((j, got, want, tol))
    say("structured", operator=name, route="grad|slq", **fields)
    for j, got, want, tol in entries:
        require(abs(got - want) <= tol,
                f"toeplitz grad: d/dc{j} {got} vs {want} (tol {tol})")
    require(all(torch.isfinite(b).all() for b in bar),
            f"{name} grad: not finite")
    require(err <= bound, f"{name} grad: error {err} > 3 sem {bound}")
    require(not any(counts.values()), f"{name} grad launched {counts}")
    return counts


def structured_operator(name: str, cell, seed: int) -> dict:
    """Estimators, CG and the gradient on one structured operator.

    Chebyshev takes the spectrum's closed-form bounds: the power-iteration
    bracket (the JAX package's, followed by the port) lands above the
    Kronecker cell's lmin, where the f32 recurrence amplifies rounding; it
    runs once more on that bracket, printed and not gated
    (``chebyshev|bracket``)."""
    import torch
    import repro_torch
    from repro_torch import estimators as est
    from repro_torch.estimators.chebyshev import default_generator
    op, op64, ref, grad_ref, (lmin, lmax) = cell
    n = op.n
    launches = {}
    for route, method, kw in (
            ("chebyshev", "chebyshev",
             dict(degree=DEGREE, lmin=lmin, lmax=lmax)),
            ("slq", "slq", dict(num_steps=NUM_STEPS)),
            ("auto", "auto", {}),
            ("chebyshev|bracket", "chebyshev", dict(degree=DEGREE))):
        p = repro_torch.plan(op, method=method, num_probes=PROBES, **kw)
        res, seconds, counts = counted(
            lambda: p(generator=default_generator("cuda", seed)))
        estimate, sem = res.logabsdet.item(), res.sem.item()
        tol = N_SEM * sem + EST_RTOL * abs(ref)
        gated = route != "chebyshev|bracket"
        say("structured", operator=name, n=n, route=route,
            method_used=p.method, estimate=estimate, sem=sem, ref=ref,
            abs_err=abs(estimate - ref), tol=tol, gated=gated,
            wall_s=seconds, launches=counts)
        require(not gated or abs(estimate - ref) <= tol,
                f"{name} {route}: {estimate} vs {ref} (tol {tol})")
        require(not any(counts.values()), f"{name} {route} launched {counts}")
        launches[f"structured|{name}|{route}"] = counts
    gen = torch.Generator(device="cuda").manual_seed(seed + 9)
    b = torch.randn(n, PROBES, generator=gen, device="cuda")
    cg, seconds, counts = counted(lambda: est.cg_solve(op, b, tol=CG_TOL))
    b64 = b.double()
    true_res = (torch.linalg.vector_norm(b64 - op64.mm(cg.x.double()), dim=0)
                / torch.linalg.vector_norm(b64, dim=0)).max().item()
    say("structured", operator=name, route="cg", rhs=PROBES, tol=CG_TOL,
        iters=cg.iters, true_rel_residual_f64=true_res, wall_s=seconds,
        launches=counts)
    require(true_res <= CG_RESIDUAL, f"{name} cg: true residual {true_res}")
    require(not any(counts.values()), f"{name} cg launched {counts}")
    launches[f"structured|{name}|cg"] = counts
    launches[f"structured|{name}|grad"] = structured_grad(
        name, op, op64, grad_ref, seed)
    return launches


def loglik_twin() -> None:
    """examples/gmm_loglik_torch.py on the card: one EM run with slq and
    CG, one exact with direct solves; every log-likelihood finite, each
    slq logdet within N_SEM sem of the exact one, and the two
    log-likelihoods within N_SEM sem of their difference (a mean over the
    components of -ld/2)."""
    import math
    sys.path.insert(0, str(ROOT / "examples"))
    import gmm_loglik_torch
    runs = {}
    for logdet, solver in (("slq", "cg"), ("exact", "direct")):
        (h, seconds) = timed(lambda: gmm_loglik_torch.run(
            dim=TWIN_DIM, iters=TWIN_ITERS, logdet=logdet, solver=solver,
            device="cuda", log=False))
        say("structured", cell="gmm_loglik_torch", logdet=h["logdet"],
            solver=solver, dim=TWIN_DIM, ll=h["ll"], cg_iters=h["cg_iters"],
            seconds=seconds)
        require(all(math.isfinite(v) for v in h["ll"]),
                f"gmm_loglik_torch {logdet}/{solver}: ll {h['ll']}")
        runs[solver] = h
    a, b = runs["cg"], runs["direct"]
    worst = 0.0
    for ll_a, ll_b, ld_a, ld_b, sem in zip(a["ll"], b["ll"], a["ld"],
                                           b["ld"], a["sem"]):
        for x, y, s in zip(ld_a, ld_b, sem):
            # an absolute floor where the exact logdet is 0 (the first
            # iteration's identity covariances)
            require(abs(x - y) <= N_SEM * s + EST_RTOL * max(abs(y), 1.0),
                    f"gmm_loglik_torch: logdet {x} vs exact {y} (sem {s})")
        sem_ll = 0.5 * math.sqrt(sum(v * v for v in sem)) / len(sem)
        tol = N_SEM * sem_ll + EST_RTOL * max(abs(ll_b), 1.0)
        worst = max(worst, abs(ll_a - ll_b) / tol)
        require(abs(ll_a - ll_b) <= tol,
                f"gmm_loglik_torch: ll {ll_a} vs exact {ll_b} (tol {tol})")
    say("structured", cell="gmm_loglik_torch", worst_ll_gap_over_tol=worst)


def structured_phase(seed: int) -> dict:
    """Phase 9; returns its launch counts by route (all zero)."""
    import torch
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed + 10)
    launches = {}
    cells = structured_cells(gen)
    for name in list(cells):
        launches.update(structured_operator(name, cells.pop(name), seed))
        torch.cuda.empty_cache()
    loglik_twin()
    say("structured", seconds=time.perf_counter() - t0)
    return launches


# --------------------------------------------------------------------------
# phase 10: the first trace of the exact routes
# --------------------------------------------------------------------------

# the routes traced at phase 4's N and panel width, each under obs off,
# metrics and trace
TRACE_ROUTES = ("staged|panel", "staged|rank1")
OBS_DIR = ROOT / "obs_out"
# the port's CUDA kernels by the prefix of their function names
CUDA_KERNEL_OF = (("rank1_update_kernel", "rank1_update"),
                  ("panel_update_kernel", "panel_update"),
                  ("fused_step_kernel", "fused_step"),
                  ("panel_factor_kernel", "panel_factor"),
                  ("matvec_", "matvec"), ("split_sum_kernel", "matvec"),
                  ("cheb_", "cheb_step"), ("cg_", "cg_step"),
                  ("stencil_mv_kernel", "stencil_mv"))


def kernel_of(cuda_name: str):
    """The port's kernel a CUDA function name belongs to, else None."""
    import re
    for prefix, name in CUDA_KERNEL_OF:
        if re.search(r"(^|[^A-Za-z0-9_])" + prefix, cuda_name):
            return name
    return None


def profiled(fn, cuda: bool):
    """``(fn(), events)``: the raw profiler events (``kineto_results``,
    read without building the profiler's Python event tree, which takes
    about 70 us an event) of ``fn`` on the host, and on the card with
    ``cuda``, and the profile itself."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        out = fn()
    return out, prof.profiler.kineto_results.events(), prof


def device_breakdown(events, wall_s: float) -> dict:
    """The card's time per kernel (the port's by kernel name, the rest by
    CUDA name, top 8), its busy time (the union of its events' spans) and
    its idle share of the call's wall ``wall_s``, from the events of one
    traced plan call.  The card-side copies of the host's ranges (user
    annotations) are not device work; host events are skipped on their
    device type alone (reading each one's name would cost seconds on
    staged x rank1's million events)."""
    from torch.autograd import DeviceType
    cuda = DeviceType.CUDA
    spans = []
    per = {}
    for e in events:
        if e.device_type() != cuda or e.is_user_annotation():
            continue
        t0, t1 = e.start_ns(), e.end_ns()
        spans.append((t0, t1))
        key = kernel_of(e.name()) or e.name()
        per[key] = per.get(key, 0) + (t1 - t0)
    busy, end = 0, None
    for t0, t1 in sorted(spans):
        if end is not None:
            t0 = max(t0, end)
        if t1 > t0:
            busy += t1 - t0
            end = t1
    ported = set(dict(CUDA_KERNEL_OF).values())
    ports = {k: v / 1e6 for k, v in per.items() if k in ported}
    others = sorted(((v / 1e6, k) for k, v in per.items()
                     if k not in ported), reverse=True)
    return {"device_events": len(spans), "kernel_ms": ports,
            "other_ms": {k[:60]: v for v, k in others[:8]},
            "other_total_ms": sum(v for v, _ in others),
            "busy_ms": busy / 1e6, "wall_ms": wall_s * 1e3,
            "idle_share": 1.0 - busy / 1e9 / wall_s}


def host_breakdown(events) -> dict:
    """Host ms summed per stage name (nested stages counted in each), and
    the share of ``plan.execute`` outside every top-level stage."""
    per, count = {}, {}
    execute = [e for e in events if e["name"] == "plan.execute"]
    for e in events:
        per[e["name"]] = per.get(e["name"], 0.0) + e["dur"] / 1e3
        count[e["name"]] = count.get(e["name"], 0) + 1
    top = sum(e["dur"] for e in events
              if e["depth"] == execute[0]["depth"] + 1) / 1e3
    total = execute[0]["dur"] / 1e3
    return {"ms": per, "count": count, "execute_ms": total,
            "outside_stages_ms": total - top}


def trace_route(route: str, a, k: int) -> dict:
    """One route under obs off, metrics and trace: the same bits in each,
    nothing recorded under off (and, on staged x panel, whose remainder
    rows run every rank-1 stage too, no engine or kernel range in a
    profile of the off call: profiling staged x rank1's 8191 rows twice
    would double the phase), the launches of phase 4's formula; the
    traced call's host and card breakdown, and each mode's seconds with
    the profiler's stop and read."""
    import torch
    import repro_torch
    from repro_torch import obs
    from repro_torch.kernels import ops
    update = route.split("|")[1]
    n = a.shape[0]
    p = repro_torch.plan(a, method="exact", update=update, k=k)
    want = expected_launches(p.diagnostics.padded_n, k, update, False)
    out, walls, seconds = {}, {}, {}
    for mode in ("off", "metrics", "trace"):
        obs.configure(mode)
        before = len(obs.events())
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        if mode == "trace" or (mode == "off" and update == "panel"):
            res, events, prof = profiled(p, cuda=mode == "trace")
        else:
            res, events, prof = p(), None, None
        seconds[mode] = time.perf_counter() - t0
        counts = ops.launch_counts()
        obs.configure("off")
        require(counts == want, f"trace {route} {mode}: launches {counts} "
                f"!= {want}")
        out[mode] = (res.sign, res.logabsdet)
        walls[mode] = res.diagnostics.wall_time_s
        if mode == "off":
            staged = {e.name() for e in events or ()
                      if e.name().startswith(("engine.", "kernel."))}
            require(not staged and len(obs.events()) == before,
                    f"trace {route}: obs off recorded {sorted(staged)}")
        if mode == "trace":
            card = device_breakdown(events, res.diagnostics.wall_time_s)
            if update == "panel":
                prof.export_chrome_trace(
                    str(OBS_DIR / "torch_profile_staged_panel.json"))
            host = host_breakdown(obs.events()[before:])
            seconds["trace_read"] = time.perf_counter() - t0 \
                - seconds[mode]
        del events, prof
    for mode in ("metrics", "trace"):
        require(torch.equal(out[mode][0], out["off"][0])
                and torch.equal(out[mode][1], out["off"][1]),
                f"trace {route}: {mode} gives {out[mode][1].item()!r}, off "
                f"{out['off'][1].item()!r}")
    say("trace", route=route, n=n, k=k, walls_s=walls,
        seconds_with_profiler=seconds, bitwise_across_modes=True,
        launches=counts,
        host_ms_per_stage=host["ms"], host_stage_counts=host["count"],
        host_execute_ms=host["execute_ms"],
        host_outside_stages_ms=host["outside_stages_ms"],
        host_ms_per_row=host["execute_ms"] / n, card=card)
    return counts


def trace_phase(a, k: int) -> dict:
    """Phase 10 on phase 4's matrix; returns the traced runs' launches."""
    import os
    from repro_torch import obs
    t0 = time.perf_counter()
    OBS_DIR.mkdir(exist_ok=True)
    obs.reset()
    launches = {}
    for route in TRACE_ROUTES:
        launches[f"trace|{route}"] = trace_route(route, a, k)
    path = obs.export_chrome_trace(str(OBS_DIR / obs.ARTIFACTS["trace"]))
    obs.reset()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    check = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs", "validate", path,
         "--require", "engine.pivot", "--require", "engine.panel_apply",
         "--require", "kernel.panel_factor_vmem", "--require-prefix",
         "kernel."], env=env, capture_output=True, text=True, timeout=120)
    say("trace", validate=check.stdout.strip() or check.stderr.strip(),
        trace=path, seconds=time.perf_counter() - t0)
    require(check.returncode == 0, f"trace: {path} failed validation")
    return launches


# --------------------------------------------------------------------------
# phase 11: serving
# --------------------------------------------------------------------------

# benchmarks/serve_bench.py's traffic and service settings (its defaults):
# SERVE_REQUESTS matrices randn(n, n) + 2 sqrt(n) I made with numpy from the
# seed, n uniform in SERVE_N, f64, method "exact", submitted open-loop, on
# the ladder SERVE_BUCKETS with max_batch SERVE_MAX_BATCH and
# max_wait_ms SERVE_WAIT_MS; log|det| within SERVE_RTOL of numpy's
SERVE_REQUESTS, SERVE_N = 128, (64, 512)
SERVE_BUCKETS = (64, 128, 192, 256, 384, 512)
SERVE_MAX_BATCH, SERVE_WAIT_MS, SERVE_RTOL = 8, 2.0, 1e-9
# estimator requests: SPD x x^T / n + 2 I, n uniform in SERVE_EST_N, slq,
# each within N_SEM sem + EST_RTOL of the f64 Cholesky log|det|
SERVE_EST_REQUESTS, SERVE_EST_N = 16, (600, 1024)
# the exported service in a process of its own: requests over HTTP (sides
# at most SERVE_HTTP_MAX_N, from the workload) and its time limit (s)
SERVE_HTTP_REQUESTS, SERVE_HTTP_MAX_N, SERVE_PROC_TIMEOUT = 3, 128, 300
# K1 in f64 timed at these (B, b) stacks of the service's exact batches
# (every shape the drains gave it is checked)
SERVE_K1_TIMED = ((8, 512), (8, 64), (1, 512))


def serve_workload(seed: int):
    """benchmarks/serve_bench.py:make_workload: (matrices, numpy's signs,
    numpy's log|det|)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    sizes = rng.integers(SERVE_N[0], SERVE_N[1] + 1, SERVE_REQUESTS)
    mats = [rng.standard_normal((n, n)) + np.eye(n) * (2.0 * np.sqrt(n))
            for n in sizes]
    signs, lds = zip(*(np.linalg.slogdet(a) for a in mats))
    return mats, np.asarray(signs), np.asarray(lds)


def serve_record(mode: str, out, lat, seconds: float, signs, lds,
                 warmup_s: float, counts: dict, **extra) -> dict:
    """One mode's line; requires every sign exact and every log|det|
    within SERVE_RTOL of numpy's (each request against its own matrix:
    the results are unpermuted)."""
    import numpy as np
    got_s = np.array([s for s, _ in out])
    got_ld = np.array([ld for _, ld in out])
    rel = np.abs(got_ld - lds) / np.maximum(np.abs(lds), 1.0)
    rec = dict(mode=mode, requests=len(out), seconds=seconds,
               throughput_rps=len(out) / seconds,
               p50_ms=float(np.quantile(lat, 0.5) * 1e3),
               p99_ms=float(np.quantile(lat, 0.99) * 1e3),
               warmup_s=warmup_s, rel_err_max=float(rel.max()),
               k1_launches=counts["rank1_update"], **extra)
    say("serve", **rec)
    require(np.array_equal(got_s, signs), f"serve {mode}: a sign differs "
            "from numpy's")
    require(rel.max() <= SERVE_RTOL, f"serve {mode}: rel err {rel.max()}")
    return rec


def serve_naive(mats, signs, lds) -> tuple:
    """A plan per request, one at a time, as a user without the service
    runs them."""
    import repro_torch
    from repro_torch.core.plan import clear_plan_cache
    from repro_torch.kernels import ops

    clear_plan_cache()
    out, lat = [], []
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for a in mats:
        t1 = time.perf_counter()
        r = repro_torch.plan(a.shape, method="exact", precision="float64",
                             validate=False)(a)
        out.append((r.sign.item(), r.logabsdet.item()))
        lat.append(time.perf_counter() - t1)
    seconds = time.perf_counter() - t0
    counts = ops.launch_counts()
    want = dict.fromkeys(KERNEL_META, 0)
    for a in mats:
        for name, c in expected_launches(a.shape[0], 32, "rank1",
                                         False).items():
            want[name] += c
    rec = serve_record("naive", out, lat, seconds, signs, lds, 0.0, counts,
                       expected_launches=want)
    require(counts == want, f"serve naive: launches {counts} != {want}")
    return rec, counts


def serve_service(mode: str, max_batch: int, mats, signs, lds) -> tuple:
    """The workload through a `LogdetService` on the card (warmed up
    before the timed drain, submitted open-loop).  After warmup the drain
    builds no plan, and launches K1 once per step of each batch: sum over
    batches of (bucket - 1), whatever the batch's size.  Returns (record,
    launches, results, the shapes K1 was given in the drain)."""
    from repro_torch import obs
    from repro_torch.kernels import condense_step, ops
    from repro_torch.serve import LogdetService, ServeConfig

    cfg = ServeConfig(buckets=SERVE_BUCKETS, max_batch=max_batch,
                      max_wait_ms=SERVE_WAIT_MS, cache_capacity=128,
                      default_method="exact")
    require(cfg.device.type == "cuda", f"serve {mode}: the service's "
            f"default device is {cfg.device}")
    shapes, k1 = set(), condense_step.rank1_update

    def recorded_k1(a, pc, pr):
        shapes.add(tuple(a.shape))
        return k1(a, pc, pr)

    try:
        with LogdetService(cfg) as svc:
            warmup_s = svc.warmup()
            condense_step.rank1_update = recorded_k1
            misses = obs.counter_value("serve.plan_cache.misses")
            batches = {b: obs.counter_value("serve.batches", method="exact",
                                            bucket=b)
                       for b in SERVE_BUCKETS}
            plain = obs.counter_value("kernel.dispatch", op="rank1_update",
                                      backend="torch")
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            futs = [svc.submit(a) for a in mats]
            done = [(f.result(timeout=600), time.perf_counter())
                    for f in futs]
            seconds = time.perf_counter() - t0
            counts = ops.launch_counts()
            batches = {b: obs.counter_value("serve.batches", method="exact",
                                            bucket=b) - c
                       for b, c in batches.items()}
            new_misses = obs.counter_value("serve.plan_cache.misses") - misses
            plain = obs.counter_value("kernel.dispatch", op="rank1_update",
                                      backend="torch") - plain
    finally:
        condense_step.rank1_update = k1
    want = dict.fromkeys(KERNEL_META, 0)
    for b, count in batches.items():
        for name, c in expected_launches(b, 32, "rank1", False).items():
            want[name] += int(count) * c
    results = [(r.sign, r.logabsdet) for r, _ in done]
    rec = serve_record(
        mode, results, [t - t0 for _, t in done], seconds, signs, lds,
        warmup_s, counts, batches={str(b): int(c) for b, c in
                                   batches.items() if c},
        expected_launches=want, plan_cache_misses_after_warmup=new_misses,
        plain_k1_calls=plain, k1_shapes=len(shapes))
    require(sum(batches.values()) > 0, f"serve {mode}: no batch counted")
    require(new_misses == 0, f"serve {mode}: {new_misses} plans built "
            "after warmup")
    require(plain == 0, f"serve {mode}: {plain} plain K1 calls")
    require(want["rank1_update"] == sum(int(c) * (b - 1)
                                        for b, c in batches.items()),
            f"serve {mode}: the schedule's K1 steps are not bucket - 1")
    require(counts == want, f"serve {mode}: launches {counts} != {want}")
    return rec, counts, results, shapes


def serve_kernel(shapes, gen) -> dict:
    """K1 in f64 at every shape a service drain gave it (``shapes``: the
    batched drain's (B, m, m) stacks and the bucketed one's (m, m)
    matrices) and at SERVE_K1_TIMED: bitwise equal to the plain version
    on the same inputs, each matrix of a stack bitwise its single launch;
    then the SERVE_K1_TIMED stacks timed beside the plain version, their
    bound and `torch.baddbmm`.  Returns ``{shape tag: fields}`` for the
    kernels line."""
    import torch
    from repro_torch.kernels import condense_step, ref

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda",
                           dtype=torch.float64)

    timed = {(b, n, n) for b, n in SERVE_K1_TIMED}
    checked = sorted(set(shapes) | timed, key=lambda s: (len(s), s))
    out = {}
    for shape in checked:
        *lead, m, n = shape
        a, pc, pr = randn(*shape), randn(*lead, m), randn(*lead, n)
        got = condense_step.rank1_update(a, pc, pr)
        tag = "x".join(map(str, shape))
        require(torch.equal(got, ref.rank1_update_ref(a, pc, pr)),
                f"K1 f64 {tag} (serving): not bitwise")
        for i in range(lead[0] if lead else 0):
            require(torch.equal(got[i], condense_step.rank1_update(
                a[i], pc[i], pr[i])), f"K1 f64 {tag} (serving): matrix {i} "
                "differs from its single launch")
        if shape in timed:
            b = lead[0]
            t = dict(max_abs_err=0.0,
                     ms=time_ms(lambda: condense_step.rank1_update(a, pc, pr),
                                queued=True),
                     plain_ms=time_ms(lambda: ref.rank1_update_ref(a, pc, pr),
                                      warmup=1, iters=3),
                     library_ms=time_ms(lambda: torch.baddbmm(
                         a, pc[..., None], pr[..., None, :], alpha=-1),
                         queued=True), batch=b)
            t["bound_ms"], t["bound_by"] = bound_ms(
                b * (2 * m * n + m + n) * 8, b * 2 * m * n, "float64")
            out[f"serve f64 {tag}"] = t
            say("timing", kernel="rank1_update", variant="float64",
                stack=tag, **t)
    say("kernels", serve_k1_f64_shapes=checked, rank1_update_bitwise=True,
        matrices_bitwise_single=True)
    return out


def serve_estimators(seed: int) -> dict:
    """SERVE_EST_REQUESTS slq requests through a service with the default
    ladder (rungs 768 and 1024, warmed on identity stacks): each within
    N_SEM sem + EST_RTOL of the f64 Cholesky log|det|, no kernel
    launched.  An identity request gives log|det| 0."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.serve import LogdetService, ServeConfig

    rng = np.random.default_rng(seed + 11)
    sizes = rng.integers(SERVE_EST_N[0], SERVE_EST_N[1] + 1,
                         SERVE_EST_REQUESTS)
    mats, refs = [], []
    for n in sizes:
        x = rng.standard_normal((n, n))
        a = x @ x.T / n + 2.0 * np.eye(n)
        mats.append(a)
        refs.append(2.0 * np.log(np.diag(np.linalg.cholesky(a))).sum())
    cfg = ServeConfig(max_batch=SERVE_MAX_BATCH, max_wait_ms=SERVE_WAIT_MS)
    with LogdetService(cfg) as svc:
        warmup_s = svc.warmup(methods=["slq"], buckets=(768, 1024))
        eye = svc.logdet(np.eye(700), method="slq", timeout=600)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        futs = [svc.submit(a, method="slq") for a in mats]
        res = [f.result(timeout=600) for f in futs]
        seconds = time.perf_counter() - t0
        counts = ops.launch_counts()
    err_sem = [float(abs(r.logabsdet - ref) / r.sem)
               for r, ref in zip(res, refs)]
    ok = [abs(r.logabsdet - ref) <= N_SEM * r.sem + EST_RTOL * abs(ref)
          for r, ref in zip(res, refs)]
    say("serve", mode="slq", requests=len(mats), sizes=sizes.tolist(),
        seconds=seconds, warmup_s=warmup_s, err_in_sem=err_sem,
        identity=[float(eye.sign), float(eye.logabsdet), float(eye.sem)],
        launches=counts)
    require(all(ok), f"serve slq: errors in sem {err_sem}")
    require(all(np.isfinite([r.sem for r in res])), "serve slq: sem")
    require(float(eye.sign) == 1.0 and abs(float(eye.logabsdet)) <= 1e-9
            and np.isfinite(float(eye.sem)),
            f"serve slq on the identity: {eye}")
    require(not any(counts.values()), f"serve slq: launches {counts}")
    return counts


def serve_process(mats, results) -> None:
    """``python -m repro_torch.serve export`` of the ladder, then a fresh
    ``python -m repro_torch.serve --plan-dir`` process: its HTTP answers
    to SERVE_HTTP_REQUESTS workload matrices bitwise equal to the
    in-process service's ``results``; its plans and the kernels'
    libraries all loaded at warmup (its /stats before the first request
    shows every plan-cache miss and ``kernel_loads`` 1, and the same after
    the requests); the artifacts' fingerprint names this card, capability
    (9, 0) and this kernel build."""
    import os
    import re
    import shutil
    import tempfile
    import threading
    import urllib.request
    import torch
    from repro_torch.kernels import _build
    from repro_torch.serve.aot import read_header

    t0 = time.perf_counter()
    plan_dir = tempfile.mkdtemp(prefix="serve_plans.",
                                dir=ROOT / "build")
    obs_dir = tempfile.mkdtemp(prefix="serve_obs.", dir=ROOT / "build")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_OBS="metrics", REPRO_OBS_DIR=obs_dir)
    ladder = ["--buckets", ",".join(map(str, SERVE_BUCKETS)),
              "--max-batch", str(SERVE_MAX_BATCH), "--method", "exact"]
    proc, lines = None, []
    try:
        exp = subprocess.run(
            [sys.executable, "-m", "repro_torch.serve", "export", "--out",
             plan_dir, *ladder], env=env, capture_output=True, text=True,
            timeout=SERVE_PROC_TIMEOUT)
        require(exp.returncode == 0, f"serve export failed: {exp.stderr}")
        files = sorted(os.listdir(plan_dir))
        fp = read_header(os.path.join(plan_dir, files[0]))["fingerprint"]
        build = Path(_build.build()["dir"]).name
        require(len(files) == len(SERVE_BUCKETS) * 4,
                f"serve export wrote {files}")
        require(fp["device_kind"] == torch.cuda.get_device_name(0)
                and fp["capability"] == [9, 0]
                and fp["kernel_build"] == build,
                f"serve export: fingerprint {fp}")
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.serve", "--plan-dir",
             plan_dir, "--port", "0", *ladder], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        watchdog = threading.Timer(SERVE_PROC_TIMEOUT, proc.kill)
        watchdog.start()
        port = None
        for line in proc.stdout:
            lines.append(line.rstrip())
            m = re.search(r"serving on http://[\d.]+:(\d+)", line)
            if m:
                port = int(m.group(1))
                break
        require(port is not None, "serve process never became ready: "
                + "\n".join(lines[-20:]))
        base = f"http://127.0.0.1:{port}"

        def get(path):
            with urllib.request.urlopen(base + path, timeout=60) as resp:
                return resp.read().decode()

        warm_stats = json.loads(get("/stats"))
        warm = warm_stats["counters"]
        picks = [i for i, a in enumerate(mats)
                 if a.shape[0] <= SERVE_HTTP_MAX_N][:SERVE_HTTP_REQUESTS]
        req = urllib.request.Request(
            base + "/v1/logdet", data=json.dumps(
                {"matrices": [mats[i].tolist() for i in picks],
                 "method": "exact"}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            answers = json.load(resp)["results"]
        health = json.loads(get("/healthz"))
        stats = json.loads(get("/stats"))
        metrics = get("/metrics")
        watchdog.cancel()
    finally:
        if proc is not None:
            proc.terminate()
            try:
                lines += proc.communicate(timeout=30)[0].splitlines()
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.communicate()
        shutil.rmtree(plan_dir, ignore_errors=True)
        shutil.rmtree(obs_dir, ignore_errors=True)
    got = [(a["sign"], a["logabsdet"]) for a in answers]
    want = [tuple(float(v) for v in results[i]) for i in picks]
    say("serve", mode="process", sides=[mats[i].shape[0] for i in picks],
        answers=got, in_process=want, fingerprint=fp, artifacts=len(files),
        health=health["status"], counters=stats["counters"],
        metrics_lines=len(metrics.splitlines()),
        kernel_loads=[warm_stats["kernel_loads"], stats["kernel_loads"]],
        seconds=time.perf_counter() - t0)
    require(len(picks) == SERVE_HTTP_REQUESTS and got == want,
            "serve process: HTTP answers differ from the in-process "
            "service's")
    loads = stats["counters"].get("serve.aot.loads{method=exact}")
    require(loads == len(files), f"serve process: {loads} plans loaded")
    require(stats["counters"].get("serve.plan_cache.misses")
            == warm.get("serve.plan_cache.misses") == len(files),
            f"serve process: plan-cache misses {warm} -> "
            f"{stats['counters']}")
    require(warm_stats["kernel_loads"] == stats["kernel_loads"] == 1,
            "serve process: the kernels' libraries were loaded "
            f"{warm_stats['kernel_loads']} times by warmup, "
            f"{stats['kernel_loads']} after the requests")
    require(health["status"] == "ok" and stats["device"] == "cuda:0"
            and "repro_torch_serve_responses_total" in metrics,
            "serve process: /healthz, /stats or /metrics")


def serve_phase(seed: int, gen) -> tuple:
    """Phase 11; returns its launch counts by mode and K1's f64 timings
    at the service's shapes (`serve_kernel`)."""
    import numpy as np
    from repro_torch import obs
    from repro_torch.core.plan import select_method
    from repro_torch.serve import DEFAULT_BUCKETS

    t0 = time.perf_counter()
    obs.configure("metrics")
    obs.reset()
    mats, signs, lds = serve_workload(seed)
    launches, records = {}, {}
    records["naive"], launches["serve|naive"] = serve_naive(mats, signs, lds)
    records["bucketed"], launches["serve|bucketed"], bucketed, shapes = \
        serve_service("bucketed", 1, mats, signs, lds)
    records["batched"], launches["serve|batched"], batched, stacks = \
        serve_service("batched", SERVE_MAX_BATCH, mats, signs, lds)
    same = all(np.array_equal(np.float64(x), np.float64(y))
               for p, q in zip(batched, bucketed) for x, y in zip(p, q))
    say("serve", batched_over_naive=records["batched"]["throughput_rps"]
        / records["naive"]["throughput_rps"],
        batched_over_bucketed=records["batched"]["throughput_rps"]
        / records["bucketed"]["throughput_rps"],
        batched_equals_bucketed_bitwise=same,
        auto_resolution={b: select_method((b, b)) for b in DEFAULT_BUCKETS})
    require(same, "serve: a batched result differs from the same request's "
            "bucketed one")
    launches["serve|slq"] = serve_estimators(seed)
    serve_process(mats, batched)
    obs.reset()
    obs.configure("off")
    k1_times = serve_kernel(shapes | stacks, gen)
    say("serve", seconds=time.perf_counter() - t0)
    return launches, k1_times


# --------------------------------------------------------------------------
# phase 12: static analysis and the deprecated string API
# --------------------------------------------------------------------------

def audit_counts(stats: dict) -> dict:
    """KERNEL_META-keyed launch counts of one audit recording."""
    return {name: stats["launches"].get(name, 0) for name in KERNEL_META}


def audit_line(label: str, report, n: int, seconds: float, bits) -> dict:
    """One ``[audit]`` line per full-width plan; every recording clean,
    its kernel records equal to the launch counters over the same call,
    and its result bitwise the unrecorded call's ``bits``."""
    recs = report.meta["recordings"]
    for r in recs:
        if r["obs"] == "trace":
            # the scope recording of stage-coverage: scopes alone
            say("audit", plan=label, recording=r["label"], obs="trace",
                scopes=r["scopes"], launches=r["launches"],
                record_seconds=r["seconds"])
        else:
            say("audit", plan=label, recording=r["label"], obs=r["obs"],
                ops=r["ops"], ops_per_row=r["ops"] / max(n - 1, 1),
                host_reads=r["host_reads"],
                host_read_sites=r["host_read_sites"],
                kernel_records=r["kernels"], launches=r["launches"],
                collectives=r["collectives"],
                findings=len(report.findings), record_seconds=r["seconds"])
            require(r["kernels"] == r["launches"],
                    f"audit {label} ({r['label']}): kernel records "
                    f"{r['kernels']} != launches {r['launches']}")
        if r["kind"] == "forward":
            require(r["result"] == bits, f"audit {label} ({r['obs']}): "
                    f"recorded result {r['result']} != unrecorded {bits}")
    require(report.ok and not report.findings,
            f"audit {label}: not clean:\n{report.summary()}")
    say("audit", plan=label, passes_run=report.passes_run, seconds=seconds)
    return audit_counts(recs[0])


def audit_planted(gen) -> dict:
    """Phase 12(c): each registered pass fails on a fault built from CUDA
    tensors (the over-budget broadcast runs in phase 6's ranks)."""
    import torch
    import repro_torch
    from repro_torch.analysis import AuditContext, record, run_passes
    from repro_torch.analysis.audit import context_for
    from repro_torch.kernels import ops
    from repro_torch import obs

    n, k = 256, 32
    a = dense_spd(n, gen, torch.float32)
    caught = {}

    def fails(name, mod, ctx, pid):
        rep = run_passes(mod, ctx, (pid,))
        caught[name] = [f.message[:80] for f in rep.errors]
        require(not rep.ok, f"audit planted {name}: {pid} did not fail")

    # a .item() inside the exact engine's step loop, obs off
    p = repro_torch.plan(a, method="exact", update="rank1")
    orig = ops.pivot_operands

    def leaky(buf, t):
        out = orig(buf, t)
        out[1].item()
        return out

    ops.pivot_operands = leaky
    try:
        rep = p.audit(passes=["no-host-callback"])
    finally:
        ops.pivot_operands = orig
    caught["host_read"] = [f.message[:80] for f in rep.errors]
    require(not rep.ok and rep.meta["recordings"][0]["host_reads"] == n - 1,
            f"audit planted host read: {rep.summary()}")
    require(p.audit(passes=["no-host-callback"]).ok,
            "audit: the unplanted plan reads the host")
    f32 = AuditContext(dtype="float32", n=n)
    fails("f32_to_f64", record(lambda: a.to(torch.float64)), f32,
          "dtype-discipline")
    fails("cholesky", record(torch.linalg.cholesky, a),
          AuditContext(method="slq", matrix_free=True, n=n),
          "no-dense-factorization")
    bf16 = context_for(repro_torch.plan(a, method="exact", update="panel",
                                        k=k, precision="bf16"))
    fails("bf16_inert", record(ops.panel_update, a, a[:, :k].contiguous(),
                               a[:k].contiguous()), bf16, "dtype-discipline")
    ctx = context_for(p)
    fails("missing_stage", record(p, a), ctx, "stage-coverage")
    obs.configure("trace")
    try:
        traced = record(p, a)
    finally:
        obs.configure("off")
        obs.reset()
    require(run_passes(traced, ctx, ("stage-coverage",)).ok,
            "audit: the traced staged x rank1 call misses a stage")
    fails("phantom_stage", traced, dataclasses.replace(ctx, fused=True),
          "stage-coverage")
    say("audit", planted=caught)
    return caught


def legacy_phase(n: int) -> dict:
    """Phase 12(d): the string shim ``slogdet(a, method="mc_blocked")`` at
    N = n bitwise ``method="exact", schedule="serial", update="panel"``,
    the same launches, and a DeprecationWarning."""
    import warnings
    import torch
    import repro_torch
    from repro_torch.core.api import slogdet
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(12)
    a, s_ref, ld_ref = exact_cell(n, gen)
    p = repro_torch.plan(a, method="exact", schedule="serial", update="panel")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    want = p.slogdet(a)
    torch.cuda.synchronize()
    want_counts = ops.launch_counts()
    ops.reset_launch_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = slogdet(a, method="mc_blocked")
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    deprecations = [str(w.message) for w in caught
                    if issubclass(w.category, DeprecationWarning)]
    same = bool(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))
    say("audit", legacy="mc_blocked", n=n, sign=got[0].item(),
        logabsdet=got[1].item(), ref_logabsdet=ld_ref, bitwise=same,
        launches=counts, exact_launches=want_counts,
        deprecations=[m[:90] for m in deprecations])
    require(same, "legacy mc_blocked differs from serial x panel")
    require(counts == want_counts, f"legacy mc_blocked launches {counts} != "
            f"{want_counts}")
    require(len(deprecations) == 2
            and "slogdet() is deprecated" in deprecations[0]
            and "'mc_blocked' is deprecated" in deprecations[1],
            f"legacy mc_blocked warned {deprecations}")
    require(got[0].item() == s_ref, "legacy mc_blocked: wrong sign")
    return counts


def audit_phase(n: int, gen, grids: dict) -> dict:
    """Phase 12: the grid audits phase 6's ranks made (``grids``), three
    full-width audits, planted faults, the legacy string shim.  Returns
    launches by route."""
    import torch
    import repro_torch
    from repro_torch.analysis import DEFAULT_PASS_IDS

    t0 = time.perf_counter()
    launches = {}
    # (a) the grid, audited on each rank of phase 6's meshes
    for mesh_name, per_rank in grids.items():
        say("audit", grid=mesh_name, ranks=[
            {f: g[f] for f in ("ok", "findings", "contexts", "seconds")}
            for g in per_rank], passes_run=per_rank[0]["passes_run"])
        require(all(g["ok"] and not g["findings"]
                    and g["passes_run"] == list(DEFAULT_PASS_IDS)
                    for g in per_rank), f"audit grid {mesh_name}: not clean")

    # (b) full width: auto's exact route, staged x rank1, slq with grad
    a, _, _ = exact_cell(n, gen)
    spd = dense_spd(n, gen, torch.float32)
    plans = (("auto", repro_torch.plan(a, rtol=1e-6), False),
             ("staged|rank1", repro_torch.plan(a, method="exact",
                                               update="rank1"), False),
             ("slq", repro_torch.plan(spd, method="slq"), True))
    del a, spd
    from repro_torch.analysis.audit import audit_input
    for name, p, grad in plans:
        t1 = time.perf_counter()
        x = audit_input(p)
        res = p(x)
        bits = [res.sign.tolist(), res.logabsdet.tolist(), res.sem.tolist()]
        del x, res
        report = p.audit(include_grad=grad)
        launches[f"audit|{name}"] = audit_line(
            name, report, n, time.perf_counter() - t1, bits)
        if name == "auto":
            want = expected_launches(p.diagnostics.padded_n, p.config.k,
                                     "panel", False)
            require(launches["audit|auto"] == want, f"audit auto launches "
                    f"{launches['audit|auto']} != {want}")
        if name == "staged|rank1":
            require(launches[f"audit|{name}"]["rank1_update"] == n - 1,
                    "audit staged|rank1: K1 records")
        del p, report
        torch.cuda.empty_cache()

    # (c) planted faults, (d) the string API
    audit_planted(gen)
    launches["legacy|mc_blocked"] = legacy_phase(n)
    say("audit", seconds=time.perf_counter() - t0)
    return launches

# --------------------------------------------------------------------------
# phase 13: the models, configs and data (repro_torch.models / .configs /
# .data).  No kernel of their own: plain tensor ops, as the JAX modules'
# einsums are; (c) is where they meet K1, K2 and K4.
# --------------------------------------------------------------------------

# (a) every arch at its smoke config in f32: card against CPU forward, and
# prefill + decode against forward (the JAX twin test's shapes and 2e-4)
SMOKE_BATCH, SMOKE_PREFILL, SMOKE_DECODE, SMOKE_MAX_LEN = 2, 6, 4, 16
SMOKE_RTOL = SMOKE_ATOL = 1e-4
DECODE_TOL = 2e-4
# (b) gemma3-1b at full width: 6 layers (five local, one global) in f32 on
# the card against the CPU in f64 at T = 640 > the 512-token window; then
# full depth with bf16 activations: a prompt of GEMMA_PROMPT tokens into a
# GEMMA_MAX_LEN cache and GEMMA_DECODE greedy steps
GEMMA_REF_LAYERS, GEMMA_REF_T, GEMMA_REF_TOL = 6, 640, 1e-4
GEMMA_PROMPT, GEMMA_MAX_LEN, GEMMA_DECODE = (2, 512), 1024, 32
# the bf16 tolerance is measured in the run: the same forward in f32
# activations bounds what bf16 rounding alone does (e); decode and
# forward each round that way, so they may differ by up to 2e, and the
# gate takes 3e (a margin over that triangle bound), at most BF16_TOL_MAX
BF16_TOL_FACTOR, BF16_TOL_MAX = 3.0, 5e-2
# (c) data.random_matrix through the exact path
RANDOM_MATRIX_N, RANDOM_MATRIX_KINDS = 2048, ("normal", "spd", "corr_scaled",
                                              "pivot_adversarial")
RANDOM_MATRIX_RTOL = 1e-9
# (d) synth_batch: steps compared bit for bit, card against CPU
SYNTH_STEPS = 3


def rel_to_max(got, want) -> float:
    """max |got - want| / max |want| (both moved to f64 on the CPU)."""
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / want.abs().max())


def close_ratio(got, want, rtol: float, atol: float) -> float:
    """Largest |got - want| / (atol + rtol |want|): <= 1 is within."""
    got, want = got.double().cpu(), want.double().cpu()
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def moe_gates(model, batch) -> list:
    """The router gates of every MoE layer of one forward (f32, CPU)."""
    import torch
    from repro_torch.models import forward
    from repro_torch.models.moe import MoE
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: seen.append(mod.route(
            args[0].reshape(-1, args[0].shape[-1]))[0].cpu()))
        for m in model.modules() if isinstance(m, MoE)]
    try:
        with torch.no_grad():
            forward(model, batch)
    finally:
        for h in hooks:
            h.remove()
    return seen


def routing_margin(cfg, cpu_model, cpu_batch, model, batch) -> float:
    """Fails unless, at every MoE layer and token, the CPU gates' top-k
    margin exceeds the card's gate difference (a near-tie could route a
    token otherwise on the card); returns the smallest margin over
    difference ratio."""
    import torch
    ratios = []
    for layer, (gc, gk) in enumerate(zip(moe_gates(cpu_model, cpu_batch),
                                         moe_gates(model, batch))):
        diff = float((gc - gk).abs().max())
        top = torch.sort(gc, dim=-1, descending=True).values
        k = cfg.top_k
        margin = float((top[:, k - 1] - top[:, k]).min()) \
            if k < cfg.n_experts else float("inf")
        require(margin > diff, f"{cfg.name} MoE layer {layer}: routing "
                f"near-tie on the card (margin {margin} <= gate difference "
                f"{diff})")
        ratios.append(margin / max(diff, 1e-30))
    return min(ratios)


def cache_sig(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: cache_sig(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(cache_sig(v) for v in tree)
    return (tuple(tree.shape), str(tree.dtype))


def cache_devices(tree) -> set:
    if tree is None:
        return set()
    if isinstance(tree, dict):
        return set().union(*(cache_devices(v) for v in tree.values()))
    if isinstance(tree, tuple):
        return set().union(*(cache_devices(v) for v in tree))
    return {tree.device.type}


def smoke_arch(arch: str, seed: int) -> dict:
    """(a) one arch: card forward against CPU forward on the same seeded
    parameters and batch, prefill + decode against forward, the caches
    against cache_specs, aux finite."""
    import copy
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, synth_batch
    from repro_torch.models import (cache_specs, decode_step, forward,
                                    init_model, prefill)
    from repro_torch.models.model import _encode

    cfg = get_config(arch, smoke=True).replace(dtype=torch.float32,
                                               remat=False)
    if cfg.n_experts:
        # dropless, as the JAX twin test: capacity dropping depends on
        # the call's token set (forward against prefill + decode)
        cfg = cfg.replace(capacity_factor=float(cfg.n_experts))
    cpu_model = init_model(cfg, device="cpu", generator=torch.Generator()
                           .manual_seed(seed))
    model = copy.deepcopy(cpu_model).to("cuda")
    t_total = SMOKE_PREFILL + SMOKE_DECODE
    cpu_batch = synth_batch(cfg, DataConfig(seed=seed, batch=SMOKE_BATCH,
                                            seq=t_total), 0, device="cpu")
    batch = {k: v.to("cuda") for k, v in cpu_batch.items()}
    out = {"arch": arch}
    if cfg.n_experts:
        out["routing_margin_over_diff"] = routing_margin(
            cfg, cpu_model, cpu_batch, model, batch)
    with torch.no_grad():
        cpu_logits, cpu_aux = forward(cpu_model, cpu_batch)
        logits, aux = forward(model, batch)
        require(logits.device.type == "cuda", f"{arch}: logits not on card")
        out["forward_vs_cpu"] = close_ratio(logits, cpu_logits, SMOKE_RTOL,
                                            SMOKE_ATOL)
        require(out["forward_vs_cpu"] <= 1.0, f"{arch}: card forward off "
                f"the CPU's by {out['forward_vs_cpu']} x the tolerance")
        out["aux"] = {k: float(v) for k, v in aux.items()}
        out["aux_cpu"] = {k: float(v) for k, v in cpu_aux.items()}
        require(all(v == v and abs(v) != float("inf")
                    for v in out["aux"].values()), f"{arch}: aux not finite")
        pre = dict(batch, tokens=batch["tokens"][:, :SMOKE_PREFILL])
        lp, caches = prefill(model, pre, SMOKE_MAX_LEN)
        specs = cache_specs(cfg, SMOKE_BATCH, SMOKE_MAX_LEN)
        require(cache_sig(caches) == cache_sig(specs),
                f"{arch}: caches {cache_sig(caches)} != cache_specs "
                f"{cache_sig(specs)}")
        require(cache_devices(caches) == {"cuda"}, f"{arch}: caches off card")
        ratios = [close_ratio(lp[:, 0], logits[:, SMOKE_PREFILL - 1],
                              DECODE_TOL, DECODE_TOL)]
        extras = None
        if cfg.family == "encdec":
            extras = {"memory": _encode(model, batch)}
        elif cfg.family == "vlm":
            extras = {"img_embeds": batch["img_embeds"]}
        for pos in range(SMOKE_PREFILL, t_total):
            ld, caches = decode_step(model, batch["tokens"][:, pos:pos + 1],
                                     caches, pos, batch_extras=extras)
            ratios.append(close_ratio(ld[:, 0], logits[:, pos], DECODE_TOL,
                                      DECODE_TOL))
        out["decode_vs_forward"] = max(ratios)
        require(out["decode_vs_forward"] <= 1.0, f"{arch}: prefill + "
                f"decode off forward by {ratios} x the tolerance")
        require(cache_sig(caches) == cache_sig(specs), f"{arch}: decode "
                "changed the caches' layout")
    return out


def gemma_reference(seed: int) -> dict:
    """(b) gemma3-1b at full width, GEMMA_REF_LAYERS layers, f32 on the
    card against the same parameters' forward on the CPU in f64."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, synth_batch
    from repro_torch.models import Model, forward, init_model, layer_windows
    from repro_torch.models.common import empty_init

    cfg = get_config("gemma3-1b").replace(n_layers=GEMMA_REF_LAYERS,
                                          dtype=torch.float32, remat=False)
    model = init_model(cfg, generator=torch.Generator(device="cuda")
                       .manual_seed(seed), device="cuda")
    batch = synth_batch(cfg, DataConfig(seed=seed, batch=1, seq=GEMMA_REF_T),
                        0, device="cuda")
    with torch.no_grad():
        logits, _ = forward(model, batch)
        cfg64 = cfg.replace(dtype=torch.float64, param_dtype=torch.float64)
        ref = Model(cfg64, empty_init("cpu"))
        ref.load_state_dict({k: v.double().cpu()
                             for k, v in model.state_dict().items()})
        del model
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        want, _ = forward(ref, {k: v.cpu() for k, v in batch.items()})
        cpu_s = time.perf_counter() - t0
    err = rel_to_max(logits, want)
    out = {"layers": GEMMA_REF_LAYERS, "t": GEMMA_REF_T,
           "windows": [int(w) for w in layer_windows(cfg)],
           "rel_err_to_max_logit": err, "tol": GEMMA_REF_TOL,
           "cpu_f64_forward_s": cpu_s}
    require(bool(torch.isfinite(logits).all()), "gemma ref: logits not finite")
    require(err <= GEMMA_REF_TOL, f"gemma3-1b {GEMMA_REF_LAYERS} layers: "
            f"card f32 off the CPU f64 forward by {err} of max |logit|")
    return out


def gemma_full(seed: int, smi: str) -> dict:
    """(b) gemma3-1b at full depth with bf16 activations: prefill, greedy
    decode, both against forward over the same tokens, and their rates."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, synth_batch
    from repro_torch.models import (Model, count_params, decode_step,
                                    forward, init_model, prefill)
    from repro_torch.models.common import empty_init

    cfg = get_config("gemma3-1b")
    b, t = GEMMA_PROMPT
    model = init_model(cfg, generator=torch.Generator(device="cuda")
                       .manual_seed(seed + 1), device="cuda")
    prompt = synth_batch(cfg, DataConfig(seed=seed, batch=b, seq=t), 1,
                         device="cuda")["tokens"]
    with torch.no_grad():
        prefill(model, {"tokens": prompt[:, :16]}, GEMMA_MAX_LEN)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        (lp, caches), prefill_s = timed(
            lambda: prefill(model, {"tokens": prompt}, GEMMA_MAX_LEN))
        tok = lp[:, -1].argmax(-1, keepdim=True).to(prompt.dtype)
        generated, steps = [tok], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for j in range(GEMMA_DECODE):
            ld, caches = decode_step(model, tok, caches, t + j)
            steps.append(ld[:, 0])
            tok = ld[:, -1].argmax(-1, keepdim=True).to(prompt.dtype)
            generated.append(tok)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        del caches
        seq = torch.cat([prompt] + generated[:GEMMA_DECODE], dim=1)
        fwd, _ = forward(model, {"tokens": seq})
        # the same forward with f32 activations: bf16 rounding's own size
        f32 = Model(cfg.replace(dtype=torch.float32), empty_init("cuda"))
        f32.load_state_dict(model.state_dict())
        del model
        fwd32, _ = forward(f32, {"tokens": seq})
        del f32
    pos = list(range(t - 1, t + GEMMA_DECODE))
    got = torch.stack([lp[:, 0]] + steps, dim=1)            # (b, 33, V)
    want, want32 = fwd[:, pos], fwd32[:, pos]
    del fwd, fwd32
    bf16_err = rel_to_max(want, want32)
    tol = BF16_TOL_FACTOR * bf16_err
    err = rel_to_max(got, want)
    finite = bool(torch.isfinite(got).all() and torch.isfinite(want).all())
    # argmax: equal, or a near-tie of the forward within the tolerance
    scale = float(want.abs().max())
    am = got.argmax(-1)
    differs = am != want.argmax(-1)
    gap = want.max(-1).values - want.gather(-1, am[..., None])[..., 0]
    near_ties = int(differs.sum())
    argmax_ok = bool((gap[differs] <= tol * scale).all())
    out = {
        "params": count_params(cfg), "prompt": [b, t],
        "max_len": GEMMA_MAX_LEN, "decode_steps": GEMMA_DECODE,
        "prefill_s": prefill_s, "prefill_tokens_per_s": b * t / prefill_s,
        "decode_ms_per_step": decode_s / GEMMA_DECODE * 1e3,
        "decode_tokens_per_s": b * GEMMA_DECODE / decode_s,
        "peak_mem_bytes": peak, "bf16_vs_f32_forward": bf16_err,
        "tol": tol, "tol_reason": "3 x the bf16-vs-f32 forward error: "
        "decode and forward each round in bf16 (triangle bound 2x)",
        "decode_vs_forward": err, "argmax_differs": near_ties,
        "logits_finite": finite, "card": smi}
    require(finite, "gemma3-1b full: logits not finite")
    require(tol <= BF16_TOL_MAX, f"gemma3-1b full: bf16 tolerance {tol} "
            f"above {BF16_TOL_MAX}")
    require(err <= tol, f"gemma3-1b full: decode off forward by {err} of "
            f"max |logit| (tolerance {tol})")
    require(argmax_ok, "gemma3-1b full: a decode argmax differs from "
            "forward's by more than the tolerance")
    return out


def random_matrix_routes(k: int) -> dict:
    """(c) data.random_matrix's kinds at RANDOM_MATRIX_N f64 through the
    exact plan on the card, rank1 and panel: sign equal to numpy's
    slogdet, log|det| within RANDOM_MATRIX_RTOL x max(1, |ref|), K1/K2/K4
    launches of phase 4's formula.  Returns launches by route."""
    import numpy as np
    import torch
    import repro_torch
    from repro_torch.data import random_matrix
    from repro_torch.kernels import ops

    n = RANDOM_MATRIX_N
    launches = {}
    for kind in RANDOM_MATRIX_KINDS:
        a_np = random_matrix(n, kind=kind, seed=0)
        s_ref, ld_ref = np.linalg.slogdet(a_np)
        a = torch.from_numpy(a_np).to("cuda")
        for update in ("rank1", "panel"):
            p = repro_torch.plan(a, method="exact", update=update, k=k)
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            res = p()
            counts = ops.launch_counts()
            s, ld = res.sign.item(), res.logabsdet.item()
            rel = abs(ld - ld_ref) / max(1.0, abs(ld_ref))
            want = expected_launches(n, k, update, False)
            say("models", part="random_matrix", kind=kind, n=n,
                route=f"staged|{update}", sign=s, ref_sign=float(s_ref),
                logabsdet=ld, ref_logabsdet=float(ld_ref), rel_err=rel,
                rtol=RANDOM_MATRIX_RTOL, launches=counts,
                expected_launches=want)
            require(s == s_ref, f"random_matrix {kind} {update}: sign {s} "
                    f"!= {s_ref}")
            require(rel <= RANDOM_MATRIX_RTOL, f"random_matrix {kind} "
                    f"{update}: rel err {rel}")
            require(counts == want, f"random_matrix {kind} {update}: "
                    f"launches {counts} != {want}")
            launches[f"models|{kind}|{update}"] = counts
    return launches


def synth_on_card(seed: int) -> None:
    """(d) synth_batch on the card equals the CPU batch bit for bit."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, synth_batch
    for arch in ("whisper-tiny", "llama-3.2-vision-11b"):
        cfg = get_config(arch, smoke=True)
        for kind in ("lm", "markov"):
            data = DataConfig(seed=seed, batch=4, seq=64, kind=kind)
            for step in range(SYNTH_STEPS):
                card = synth_batch(cfg, data, step)
                cpu = synth_batch(cfg, data, step, device="cpu")
                require(list(card) == list(cpu) and all(
                    card[k].device.type == "cuda"
                    and torch.equal(card[k].cpu(), cpu[k]) for k in cpu),
                    f"synth_batch {arch} {kind} step {step}: card != cpu")
    say("models", part="synth_batch", archs=["whisper-tiny",
                                              "llama-3.2-vision-11b"],
        kinds=["lm", "markov"], steps=SYNTH_STEPS, bitwise=True)


def models_phase(seed: int, k: int, smi: str) -> dict:
    """Phase 13: (a) the ten archs at their smoke configs, (b) gemma3-1b
    at full width, (c) random_matrix through the exact path, (d)
    synth_batch.  Returns launches by route (only (c) launches)."""
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    require(not torch.backends.cuda.matmul.allow_tf32,
            "TF32 is on: the f32 comparisons would measure TF32")
    say("models", allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    # (a) and (b) run no kernel of K1-K8: plain tensor ops, as in JAX
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for arch in ARCHS:
        say("models", part="smoke", **smoke_arch(arch, seed))
        torch.cuda.empty_cache()
    say("models", part="gemma3-1b reference", **gemma_reference(seed))
    torch.cuda.empty_cache()
    say("models", part="gemma3-1b full", **gemma_full(seed, smi))
    torch.cuda.empty_cache()
    counts = ops.launch_counts()
    say("models", part="launches of (a) and (b)", launches=counts)
    require(not any(counts.values()), f"the models launched {counts}")
    launches = random_matrix_routes(k)
    synth_on_card(seed)
    say("models", seconds=time.perf_counter() - t0)
    return launches


# --------------------------------------------------------------------------
# phase 14: training (repro_torch.optim / .train / .checkpoint / .ft).  No
# kernel of their own; the logdet aux (train/loss.py) is the paper's
# condensation: K1 d_model - 1 times per microbatch, through the exact VJP.
# --------------------------------------------------------------------------

# (a) every arch at its smoke config, f32: one adamw step (weight decay
# 0.01, TRAIN_MICRO microbatches of TRAIN_SHAPE / TRAIN_MICRO, logdet_reg
# TRAIN_LOGDET) on the card against the same step on the CPU from the same
# seeded state; bf16 gradient compression on TRAIN_COMPRESSION_ARCH; sgd
# and adafactor (one microbatch) on TRAIN_OPT_ARCHS (zamba2: a depth-2 stack)
TRAIN_SHAPE, TRAIN_MICRO, TRAIN_LOGDET = (4, 16), 2, 0.05
TRAIN_COMPRESSION_ARCH = "qwen2.5-3b"
TRAIN_OPT_ARCHS = ("qwen2.5-3b", "zamba2-7b")
# card against CPU, f32 (TF32 off): the clipped gradients within
# TRAIN_GRAD_TOL of the largest gradient element, by family (the SSD
# scan's chunked exp(cumsum) products: mamba2 and zamba2 measured 1.0e-5
# and 3.7e-5 on the H100, and the CPU twins' JAX-against-port grad norm
# of zamba2 differs by 2.8e-5; the models' gradient twins hold every
# family to 1e-4) (plus, where a gradient
# is rounded to bf16 -- compression, llama4's bf16 parameters --
# TRAIN_COMPRESSION_ULP of each microbatch's |g|: a bf16 rounding apart);
# the card's optimizer applied to the CPU's gradient against the CPU's
# step within TRAIN_OPT_RTOL of each delta plus two spacings of the
# parameter; the metrics within TRAIN_METRIC_RTOL (grad_norm: a sum of
# 1e5-1e9 squares, TRAIN_NORM_RTOL)
TRAIN_GRAD_TOL = {"ssm": 1e-4, "hybrid": 1e-4, "default": 1e-5}
TRAIN_COMPRESSION_ULP = 2.0 ** -7
TRAIN_OPT_RTOL, TRAIN_METRIC_RTOL, TRAIN_NORM_RTOL = 1e-5, 1e-5, 1e-4
# (b) gemma3-1b at full width, GEMMA_TRAIN_LAYERS layers, f32: one adamw
# step with the aux at GEMMA_TRAIN_SHAPE tokens, card against CPU; the aux
# alone on the pooled embeddings: its gradient is inv(Cov + eps I)^T, an
# f32 inverse off the exact one by about sqrt(d) cond u (u = 2^-24)
# relative to its largest element, so card and CPU within LOGDET_KU x that
GEMMA_TRAIN_LAYERS, GEMMA_TRAIN_SHAPE, LOGDET_KU = 6, (2, 64), 2.0
# (c) gemma3-1b at full depth with bf16 activations: adamw + the aux,
# GEMMA_STEP_MICRO microbatches of GEMMA_STEP_SHAPE / GEMMA_STEP_MICRO,
# one warm-up step and GEMMA_TIMED_STEPS timed ones
GEMMA_STEP_SHAPE, GEMMA_STEP_MICRO, GEMMA_TIMED_STEPS = (4, 512), 2, 3
# (d) run_training at qwen2.5-3b's smoke config: DRIVER_STEPS steps,
# async checkpoints every DRIVER_CKPT, a node failure at DRIVER_FAULT and
# a DRIVER_SLEEP s sleep at DRIVER_SLOW
DRIVER_STEPS, DRIVER_CKPT, DRIVER_FAULT, DRIVER_SLOW, DRIVER_SLEEP = \
    10, 2, 5, 7, 1.0


def state_on(state, device):
    """A copy of a train state on ``device`` (a new Model, the optimizer
    tree and the step copied)."""
    from repro_torch.models import Model
    from repro_torch.models.common import empty_init
    m = state["params"]
    model = Model(m.cfg, empty_init(device))
    model.load_state_dict({k: v.to(device) for k, v in m.state_dict().items()})

    def tree(t):
        if isinstance(t, dict):
            return {k: tree(v) for k, v in t.items()}
        return t.to(device, copy=True)
    return {"params": model, "opt": tree(state["opt"]),
            "step": state["step"].to(device, copy=True)}


def captured_step(cfg, tcfg, state, batch):
    """One `make_train_step` step -> (state, metrics, the clipped gradient
    the step applied: `train.step.clip_by_global_norm`'s output)."""
    from repro_torch.train import make_train_step
    from repro_torch.train import step as TS
    seen, clip = [], TS.clip_by_global_norm

    def capture(grads, max_norm):
        out = clip(grads, max_norm)
        seen.append(out[0])
        return out
    TS.clip_by_global_norm = capture
    try:
        state, metrics = make_train_step(cfg, tcfg)(state, batch)
    finally:
        TS.clip_by_global_norm = clip
    return state, metrics, seen[0]


def rounding_bound(cfg, tcfg, state, batch):
    """Where a gradient is rounded to bf16 (every gradient with
    compression, a bf16 parameter's always): TRAIN_COMPRESSION_ULP x the
    mean over the microbatches of |g_k| (f32, before the rounding), per
    parameter, zero elsewhere; None when nothing is rounded."""
    import torch
    from repro_torch.train import make_grad_fn
    bf16 = {k for k, p in state["params"].named_parameters()
            if p.dtype == torch.bfloat16}
    if not tcfg.grad_compression and not bf16:
        return None
    mb = tcfg.microbatches
    one = make_grad_fn(cfg, dataclasses.replace(
        tcfg, microbatches=1, grad_compression=False))
    acc = None
    for i in range(mb):
        part = {k: x.reshape(mb, x.shape[0] // mb, *x.shape[1:])[i]
                for k, x in batch.items()}
        g, _ = one(state["params"], part)
        acc = {k: v.abs().float() if acc is None else acc[k] + v.abs()
               for k, v in g.items()}
    return {k: TRAIN_COMPRESSION_ULP * v / mb
            if tcfg.grad_compression or k in bf16 else torch.zeros_like(v)
            for k, v in acc.items()}


def train_compare(cfg, tcfg, state, batch, label: str) -> dict:
    """One train step on the card against the same step on the CPU from
    the CPU ``state`` (moved along).  Gates the metrics, the gradients,
    the card's optimizer applied to the CPU's gradient against the CPU's
    step, and K1's launches (microbatches x (d_model - 1) with the aux,
    none of K2-K8); the comparisons run on the card.  Returns the errors,
    the launch counts and the card's state."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.optim import get_optimizer, jax_leaves
    card = state_on(state, "cuda")
    cross = state_on(state, "cuda")
    cbatch = {k: v.to("cuda") for k, v in batch.items()}
    old = {k: p.detach().clone() for k, p in card["params"].named_parameters()}
    comp = rounding_bound(cfg, tcfg, state, batch)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    card, mk, gk = captured_step(cfg, tcfg, card, cbatch)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    cpu, mc, gc = captured_step(cfg, tcfg, state, batch)
    # the card's optimizer on the CPU's gradient (outside the counted step)
    gc = {k: v.to("cuda") for k, v in gc.items()}
    get_optimizer(tcfg.opt)[1](gc, cross["opt"], cross["params"])
    out = {"case": label, "card_step_s": card_s, "launches": counts}
    # metrics
    m_err = {}
    for k in mc:
        a, b = float(mk[k]), float(mc[k])
        m_err[k] = abs(a - b) / max(abs(b), 1e-30)
        rtol = TRAIN_NORM_RTOL if k == "grad_norm" else TRAIN_METRIC_RTOL
        require(a == a and b == b and m_err[k] <= rtol,
                f"train {label}: metric {k} card {a} cpu {b}")
    require(set(mk) == set(mc), f"train {label}: metric keys differ")
    out["metrics"] = {k: float(v) for k, v in mc.items()}
    out["metric_rel_err"] = max(m_err.values())
    # gradients: global, and per JAX leaf group (relative to its max)
    gmax = max(float(v.abs().max()) for v in gc.values())
    grad_tol = TRAIN_GRAD_TOL.get(cfg.family, TRAIN_GRAD_TOL["default"])
    worst = 0.0
    for k, v in gc.items():
        err = (gk[k].double() - v.double()).abs()
        tol = grad_tol * gmax + (0.0 if comp is None
                                 else comp[k].to("cuda").double())
        worst = max(worst, float((err / tol).max()))
    out["grad_err_over_tol"] = worst
    require(worst <= 1.0, f"train {label}: card gradient off the CPU's by "
            f"{worst} x the tolerance")
    groups = {}
    for leaf in jax_leaves(state["params"]):
        num = max(float((gk[n].double() - gc[n].double()).abs().max())
                  for n in leaf.names)
        den = max(float(gc[n].abs().max()) for n in leaf.names)
        groups[".".join(leaf.path)] = num / den if den else num
    out["grad_rel_to_max_by_group_max"] = max(groups.values())
    # deltas: the card's optimizer against the CPU's on the same gradient,
    # and card against CPU (reported)
    new_k = dict(card["params"].named_parameters())
    new_x = dict(cross["params"].named_parameters())
    opt_worst, delta_rel = 0.0, 0.0
    for k, p in cpu["params"].named_parameters():
        new_c = p.detach().to("cuda")
        p0 = old[k].double()
        dk = new_k[k].detach().double() - p0
        dx = new_x[k].detach().double() - p0
        dc = new_c.double() - p0
        # two spacings of the parameter's dtype at its new value
        ulp = 4 * torch.finfo(p.dtype).eps * new_c.double().abs()
        tol = TRAIN_OPT_RTOL * dc.abs() + ulp + 1e-300
        opt_worst = max(opt_worst, float(((dx - dc).abs() / tol).max()))
        if float(dc.abs().max()) > 0:
            delta_rel = max(delta_rel, float((dk - dc).abs().max()
                                             / dc.abs().max()))
    out["card_opt_err_over_tol"] = opt_worst
    out["delta_rel_to_max_card_vs_cpu"] = delta_rel
    require(opt_worst <= 1.0, f"train {label}: the card's optimizer off the "
            f"CPU's on the same gradient by {opt_worst} x the tolerance")
    require(int(card["step"]) == int(cpu["step"]) == int(state["step"]),
            f"train {label}: step counters differ")
    want = {"rank1_update": (tcfg.microbatches * (cfg.d_model - 1)
                             if tcfg.logdet_reg else 0)}
    require(counts.get("rank1_update", 0) == want["rank1_update"]
            and not any(v for n, v in counts.items() if n != "rank1_update"),
            f"train {label}: launches {counts}, want K1 "
            f"{want['rank1_update']} and nothing else")
    out["state"] = card
    return out


def smoke_train_cases():
    """(label, arch, optimizer, microbatches, compression) of (a)."""
    from repro_torch.configs import ARCHS
    cases = [(f"{a}|adamw", a, "adamw", TRAIN_MICRO, False) for a in ARCHS]
    cases.append((f"{TRAIN_COMPRESSION_ARCH}|adamw|compressed",
                  TRAIN_COMPRESSION_ARCH, "adamw", TRAIN_MICRO, True))
    for name in ("adafactor", "sgd"):
        cases += [(f"{a}|{name}", a, name, 1, False) for a in TRAIN_OPT_ARCHS]
    return cases


def smoke_train(seed: int) -> dict:
    """(a): every case of `smoke_train_cases`; returns launches by route."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, synth_batch
    from repro_torch.optim import OptConfig
    from repro_torch.train import TrainConfig, init_train_state
    launches = {}
    for label, arch, name, mb, compressed in smoke_train_cases():
        cfg = get_config(arch, smoke=True).replace(dtype=torch.float32)
        tcfg = TrainConfig(opt=OptConfig(name=name, weight_decay=0.01),
                           microbatches=mb, logdet_reg=TRAIN_LOGDET,
                           grad_compression=compressed)
        state = init_train_state(cfg, tcfg, generator=torch.Generator()
                                 .manual_seed(seed), device="cpu")
        b, t = TRAIN_SHAPE
        batch = synth_batch(cfg, DataConfig(seed=seed, batch=b, seq=t), 0,
                            device="cpu")
        r = train_compare(cfg, tcfg, state, batch, label)
        r.pop("state")
        say("train", part="smoke", **r)
        launches[f"train|{label}"] = r["launches"]
        torch.cuda.empty_cache()
    return launches


def gemma_train_reference(seed: int, smi: str) -> tuple:
    """(b): gemma3-1b at full width, GEMMA_TRAIN_LAYERS layers, f32: one
    adamw step with the aux, card against CPU; then the aux alone on the
    card's pooled embeddings against the CPU's.  Returns (the result,
    the card's state after the step, launches)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, synth_batch
    from repro_torch.models.common import embed_lookup
    from repro_torch.optim import OptConfig
    from repro_torch.train import TrainConfig, init_train_state
    from repro_torch.train.loss import logdet_decorrelation
    cfg = get_config("gemma3-1b").replace(n_layers=GEMMA_TRAIN_LAYERS,
                                          dtype=torch.float32)
    tcfg = TrainConfig(opt=OptConfig(name="adamw"), logdet_reg=TRAIN_LOGDET)
    card0 = init_train_state(cfg, tcfg, generator=torch.Generator(
        device="cuda").manual_seed(seed), device="cuda")
    state = state_on(card0, "cpu")
    del card0
    b, t = GEMMA_TRAIN_SHAPE
    batch = synth_batch(cfg, DataConfig(seed=seed, batch=b, seq=t), 0,
                        device="cpu")
    t0 = time.perf_counter()
    r = train_compare(cfg, tcfg, state, batch, "gemma3-1b|6 layers|adamw")
    r["compare_s"] = time.perf_counter() - t0
    card = r.pop("state")
    # the aux alone: the card's pooled f32 embeddings, card against CPU
    with torch.no_grad():
        pooled = embed_lookup(card["params"].embed, batch["tokens"].to("cuda"),
                              cfg.dtype).mean(dim=1)
    out = {}
    for dev in ("cuda", "cpu"):
        h = pooled.to(dev).clone().requires_grad_()
        v = logdet_decorrelation(h)
        v.backward()
        out[dev] = (float(v.detach()), h.grad.double().cpu())
    h64 = pooled.double().cpu()
    xc = h64 - h64.mean(0)
    cov = xc.T @ xc / h64.shape[0] + 1e-3 * torch.eye(cfg.d_model,
                                                      dtype=torch.float64)
    ku = cfg.d_model ** 0.5 * float(torch.linalg.cond(cov)) * 2.0 ** -24
    g_err = float((out["cuda"][1] - out["cpu"][1]).abs().max()
                  / out["cpu"][1].abs().max())
    r.update(aux_value_card=out["cuda"][0], aux_value_cpu=out["cpu"][0],
             aux_grad_rel_to_max=g_err,
             aux_cond=ku / 2.0 ** -24 / cfg.d_model ** 0.5,
             aux_tol=LOGDET_KU * ku, aux_dtype="float32 in both packages",
             card=smi)
    require(g_err <= LOGDET_KU * ku, f"gemma train: the aux's gradient on "
            f"the card off the CPU's by {g_err} (tolerance {LOGDET_KU * ku})")
    require(abs(out["cuda"][0] - out["cpu"][0]) <= TRAIN_METRIC_RTOL
            * abs(out["cpu"][0]), "gemma train: the aux's value differs")
    return r, card


def gemma_train_full(seed: int, smi: str) -> dict:
    """(c): gemma3-1b at full depth, bf16 activations: adamw with the aux,
    GEMMA_STEP_MICRO microbatches; one warm-up step, GEMMA_TIMED_STEPS
    timed; the aux alone (forward + backward) on one microbatch's pooled
    (2, d_model) embeddings, timed."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, synth_batch
    from repro_torch.kernels import ops
    from repro_torch.models import count_params
    from repro_torch.models.common import embed_lookup
    from repro_torch.optim import OptConfig
    from repro_torch.train import (TrainConfig, init_train_state,
                                   make_train_step)
    from repro_torch.train.loss import logdet_decorrelation
    cfg = get_config("gemma3-1b")
    tcfg = TrainConfig(opt=OptConfig(name="adamw"), logdet_reg=TRAIN_LOGDET,
                       microbatches=GEMMA_STEP_MICRO)
    state = init_train_state(cfg, tcfg, generator=torch.Generator(
        device="cuda").manual_seed(seed + 2), device="cuda")
    b, t = GEMMA_STEP_SHAPE
    data = DataConfig(seed=seed, batch=b, seq=t)
    step = make_train_step(cfg, tcfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (state, m0), warm_s = timed(lambda: step(state, synth_batch(cfg, data, 0)))
    times, counts, metrics = [], [], []
    for i in range(1, GEMMA_TIMED_STEPS + 1):
        batch = synth_batch(cfg, data, i)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        (state, m), s = timed(lambda: step(state, batch))
        times.append(s)
        counts.append(ops.launch_counts())
        metrics.append({k: float(v) for k, v in m.items()})
    peak = torch.cuda.max_memory_allocated()
    # the aux alone on one microbatch's pooled embeddings
    tokens = synth_batch(cfg, data, 1)["tokens"][:b // GEMMA_STEP_MICRO]
    with torch.no_grad():
        pooled = embed_lookup(state["params"].embed, tokens,
                              cfg.dtype).mean(dim=1)

    def aux():
        h = pooled.detach().requires_grad_()
        logdet_decorrelation(h).backward()
        return h.grad
    aux()
    aux_s = min(timed(aux)[1] for _ in range(3))
    step_s = sorted(times)[len(times) // 2]
    want_k1 = GEMMA_STEP_MICRO * (cfg.d_model - 1)
    out = {"params": count_params(cfg), "shape": [b, t],
           "microbatches": GEMMA_STEP_MICRO, "warmup_step_s": warm_s,
           "step_s": times, "step_ms_median": step_s * 1e3,
           "tokens_per_s": b * t / step_s, "peak_mem_bytes": peak,
           "k1_launches_per_step": [c.get("rank1_update", 0) for c in counts],
           "expected_k1": want_k1, "metrics": metrics[-1],
           "aux_fwd_bwd_ms": aux_s * 1e3,
           "aux_share_of_step": GEMMA_STEP_MICRO * aux_s / step_s,
           "card": smi}
    require(all(c.get("rank1_update", 0) == want_k1 and not any(
        v for n, v in c.items() if n != "rank1_update") for c in counts),
        f"gemma full train: launches {counts}, want K1 {want_k1} a step")
    require(all(v == v and abs(v) != float("inf")
                for m in metrics + [{k: float(v) for k, v in m0.items()}]
                for v in m.values()), f"gemma full train: metrics {metrics}")
    return out, {k: sum(c.get(k, 0) for c in counts) for k in counts[0]}


def driver_on_card(seed: int) -> dict:
    """(d): run_training on the card with async checkpoints, one node
    failure and one sleep, against an uninterrupted run of the same
    steps: restarts 1, the straggler flagged, the final states bitwise
    equal."""
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, synth_batch
    from repro_torch.ft.driver import FTConfig, run_training
    from repro_torch.kernels import ops
    from repro_torch.optim import OptConfig
    from repro_torch.train import (TrainConfig, init_train_state,
                                   make_train_step)
    cfg = get_config("qwen2.5-3b", smoke=True).replace(dtype=torch.float32)
    tcfg = TrainConfig(opt=OptConfig(name="adamw", lr=1e-2, warmup=2,
                                     decay_steps=DRIVER_STEPS),
                       logdet_reg=TRAIN_LOGDET)
    data = DataConfig(seed=seed, batch=2, seq=16)
    runs = {}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix="repro_torch_ckpt_") as tmp:
        for run in ("straight", "interrupted"):
            state = init_train_state(cfg, tcfg, generator=torch.Generator()
                                     .manual_seed(seed), device="cuda")
            armed = {"fault": run == "interrupted"}

            def injector(step, armed=armed, run=run):
                if run != "interrupted":
                    return
                if step == DRIVER_FAULT and armed["fault"]:
                    armed["fault"] = False
                    raise RuntimeError("injected node failure")
                if step == DRIVER_SLOW:
                    time.sleep(DRIVER_SLEEP)
            t0 = time.perf_counter()
            final, stats = run_training(
                state=state, train_step=make_train_step(cfg, tcfg),
                batch_fn=lambda s: synth_batch(cfg, data, s),
                n_steps=DRIVER_STEPS,
                ft=FTConfig(ckpt_dir=f"{tmp}/{run}", ckpt_every=DRIVER_CKPT),
                fault_injector=injector)
            runs[run] = (final, stats, time.perf_counter() - t0)
    counts = ops.launch_counts()
    (a, sa, ta), (b, sb, tb) = runs["straight"], runs["interrupted"]
    pa = dict(a["params"].named_parameters())
    diff = {k: float((p.detach() - pa[k].detach()).abs().max())
            for k, p in b["params"].named_parameters()}
    bitwise = all(torch.equal(p, pa[k]) for k, p in
                  b["params"].named_parameters())
    out = {"steps": DRIVER_STEPS, "ckpt_every": DRIVER_CKPT,
           "restarts": sb.restarts, "stragglers": sb.stragglers,
           "straight_s": ta, "interrupted_s": tb,
           "final_step": int(b["step"]), "bitwise": bitwise,
           "max_abs_diff": max(diff.values()), "launches": counts}
    # K1 on every step taken: the straight run's, the interrupted run's
    # steps before the fault and its replay from the checkpoint
    want = (2 * DRIVER_STEPS + DRIVER_FAULT % DRIVER_CKPT) * (cfg.d_model - 1)
    require(counts.get("rank1_update", 0) == want and not any(
        v for n, v in counts.items() if n != "rank1_update"),
        f"driver: launches {counts}, want K1 {want}")
    require(sb.restarts == 1 and sa.restarts == 0,
            f"driver: restarts {sb.restarts}")
    require(DRIVER_SLOW in sb.stragglers, f"driver: stragglers "
            f"{sb.stragglers} miss step {DRIVER_SLOW}")
    require(int(a["step"]) == int(b["step"]) == DRIVER_STEPS,
            "driver: final steps differ")
    require(bitwise, f"driver: the restarted run's parameters differ from "
            f"the uninterrupted run's by up to {out['max_abs_diff']}")
    return out


def checkpoint_on_card(card_state) -> dict:
    """(d): one synchronous save of (b)'s card state and its restore onto
    the CPU, timed, bitwise."""
    import tempfile
    import torch
    from repro_torch.checkpoint import checkpoint as ckpt
    nbytes = sum(p.numel() * p.element_size()
                 for p in card_state["params"].parameters())

    def tree_bytes(t):
        if isinstance(t, dict):
            return sum(tree_bytes(v) for v in t.values())
        return t.numel() * t.element_size()
    nbytes += tree_bytes(card_state["opt"]) + 4
    with tempfile.TemporaryDirectory(prefix="repro_torch_ckpt_") as tmp:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save(tmp, card_state, 1)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got, step = ckpt.restore(tmp, card_state, device="cpu")
        restore_s = time.perf_counter() - t0
    same = step == 1 and all(
        torch.equal(p.detach().cpu(), q.detach()) for (_, p), (_, q) in zip(
            card_state["params"].named_parameters(),
            got["params"].named_parameters()))

    def tree_same(x, y):
        if isinstance(x, dict):
            return all(tree_same(x[k], y[k]) for k in x)
        return y.device.type == "cpu" and torch.equal(x.cpu(), y)
    same = same and tree_same(card_state["opt"], got["opt"]) and \
        tree_same({"s": card_state["step"]}, {"s": got["step"]})
    out = {"bytes": nbytes, "save_s": save_s, "restore_s": restore_s,
           "save_gb_per_s": nbytes / save_s / 1e9,
           "restore_gb_per_s": nbytes / restore_s / 1e9, "bitwise": same}
    require(same, "checkpoint: the card state restored onto the CPU differs")
    return out


def train_phase(seed: int, smi: str) -> dict:
    """Phase 14: (a) the smoke archs' train steps, card against CPU; (b)
    gemma3-1b at full width, 6 layers, card against CPU, and the aux
    alone; (c) gemma3-1b at full depth, bf16, timed; (d) the driver on
    the card and a checkpoint of (b)'s state.  Returns launches by
    route."""
    import torch
    t0 = time.perf_counter()
    require(not torch.backends.cuda.matmul.allow_tf32,
            "TF32 is on: the f32 comparisons would measure TF32")
    launches = smoke_train(seed)
    ref, card_state = gemma_train_reference(seed, smi)
    launches["train|gemma3-1b 6 layers|adamw"] = ref.pop("launches")
    say("train", part="gemma3-1b 6 layers", **ref)
    say("train", part="checkpoint", card=smi, **checkpoint_on_card(card_state))
    del card_state
    torch.cuda.empty_cache()
    full, launches["train|gemma3-1b full|adamw"] = gemma_train_full(seed, smi)
    say("train", part="gemma3-1b full", **full)
    torch.cuda.empty_cache()
    drv = driver_on_card(seed)
    launches["train|driver"] = drv["launches"]
    say("train", part="driver", **drv)
    say("train", seconds=time.perf_counter() - t0)
    return launches


# --------------------------------------------------------------------------
# phase 15: launch and sharding (repro_torch.sharding / .launch).  No kernel
# of their own; the train launcher's logdet aux is K1, as in phase 14.
# --------------------------------------------------------------------------

# (a) launch.train at gemma3-1b's full width and depth: LAUNCH_STEPS steps
# of LAUNCH_SHAPE tokens in LAUNCH_MICRO microbatches, adamw, the aux at
# TRAIN_LOGDET, one rank
LAUNCH_STEPS, LAUNCH_SHAPE, LAUNCH_MICRO = 3, (4, 256), 2
# (b) the JAX launcher test's arguments (tests/test_launch_integration.py
# ::test_train_cli_multidevice) plus the aux at TRAIN_LOGDET (K1 63 times
# a step on every rank), f32 activations, on a 2x2 grid of gloo ranks
# sharing the card, against one rank in this process; the grid's
# step-LAUNCH_RESTORE_AT checkpoint restored onto a 2x2 grid (bitwise the
# 2x2 run's end), onto a 2x1 grid of two gloo ranks (the same data split,
# the model line's split products summed in one rank: on within
# LAUNCH_LOSS_RTOL of the 2x2 run) and onto one rank
LAUNCH_ARGV = ["--arch", "gemma3-1b", "--steps", "30", "--batch", "4",
               "--seq", "32", "--lr", "3e-3", "--ckpt-every", "25"]
LAUNCH_GRID, LAUNCH_RESTORE_AT, LAUNCH_TIMEOUT = (2, 2), 25, 600
# the earlier step on this grid with the aux, every parameter gathered
# whole once a step (PERF.md §6; NVIDIA H100 80GB HBM3, 700.00 W)
LAUNCH_GRID_GATHER_ALL = {"broadcasts_per_step": 174, "all_sums_per_step": 60,
                    "bytes_per_step": 1.84e6,
                    "rank_step_s_median": [0.44, 0.53]}
# the same grid's step before the model split, the parameters gathered one
# unit at a time over the whole grid (PERF.md §6; NVIDIA H100 80GB HBM3,
# 700.00 W)
LAUNCH_GRID_DATA_ONLY = {"broadcasts_per_step": 342, "all_sums_per_step": 61,
                         "bytes_per_step": 2.68e6,
                         "rank_step_s_median": [0.54, 0.94]}
# the split step against one rank (f32): the first step's reduced gradient
# within TRAIN_GRAD_TOL of its largest element, its metrics within
# TRAIN_METRIC_RTOL (grad_norm TRAIN_NORM_RTOL), each step's loss within
# LAUNCH_LOSS_RTOL: a step's loss sums 128 tokens' terms in another order
# (two ranks' partial sums), at most 128 x 2^-24 = 7.6e-6 of it, and 30
# steps' parameter drift adds to that
LAUNCH_LOSS_RTOL = 1e-5
# (b) at full width and depth: gemma3-1b at LAUNCH_WIDE_LAYERS layers (all
# 26), LAUNCH_WIDE_STEPS steps of (batch, seq) on the same grid, the aux
# at TRAIN_LOGDET (K1 1151 a step on every rank), f32 activations (bf16
# rounds each rank's partial weight gradient far above the gradient
# gate), the parameters gathered one unit at a time, held to one rank as
# the smoke grid is: the first reduced gradient (each rank's blocks,
# gathered whole after the run) within TRAIN_GRAD_TOL of its largest
# element, each step's loss within LAUNCH_LOSS_RTOL.  The earlier step
# that gathered every parameter whole once a step (at 2 layers: all it
# could run beside the one-rank reference) is printed beside the
# measurement: LAUNCH_WIDE_GATHER_ALL (PERF.md §6; NVIDIA H100 80GB HBM3,
# 700.00 W; its 26-layer peak an estimate from the code)
LAUNCH_WIDE_LAYERS, LAUNCH_WIDE_STEPS, LAUNCH_WIDE_SHAPE = 26, 2, (4, 64)
LAUNCH_WIDE_TIMEOUT = 600
LAUNCH_WIDE_GATHER_ALL = {"layers": 2, "bytes_per_step": 2.85e9,
                    "rank_peak_bytes": 6.40e9, "rank_step_s": [3.60, 4.21],
                    "rank_peak_bytes_26_layers_estimated": 16.5e9}
# the 26-layer grid before the model split (every rank of a model line
# computing its data line's whole step; PERF.md §6; NVIDIA H100 80GB
# HBM3, 700.00 W): the bytes a step gathered and reduced, its collectives,
# a rank's peak, the whole parameter bytes alive at once, its step s
LAUNCH_WIDE_DATA_ONLY = {"gathered_bytes_per_step": 6790537728,
                         "reduced_bytes_per_step": 4009877012,
                         "broadcasts_per_step": 1462,
                         "all_sums_per_step": 241,
                         "rank_peak_bytes": 6904838144,
                         "rank_whole_peak_bytes": 1.315e9,
                         "rank_step_s": [13.40, 24.40]}
# (c) launch.serve: (arch, batch, prompt length, generated tokens), f32,
# card against CPU on the same parameters; greedy tokens equal until the
# CPU's top-2 logit margin is within 2 x SMOKE_ATOL (of max(1, |logits|))
LAUNCH_SERVE = [("mamba2-370m", 2, 8, 4), ("gemma3-1b", 2, 8, 4)]
# (d) the dry run's cells at full size: (arch, shape, multi_pod, fast --
# fast skips the memory tracker's pass -- and what the JAX rules give for
# the cell: (argument bytes a device, broadcasts and their bytes, all_sums
# and their bytes: a train cell's split step gathers the parameters one
# unit at a time, a layer's twice (its forward and its backward), a leaf
# the model line splits over the 16 data ranks only (its model block),
# and all_sums each gradient (a split leaf's block), the nll, the global
# norm and the agreement over the 16 data ranks, and the model line's
# activations (a split MLP's output twice and its input's gradient a
# layer, the vocab-parallel lookup, each CE chunk's exchange twice and
# its gradient); a serving cell gathers its arguments;
# tests/test_torch_dryrun.py derives these from the JAX package).
# DRYRUN_GATHER_ALL: the earlier step's figures for the train cell, every
# parameter gathered whole once a step (its temp bytes from the CLI's
# memory pass; PERF.md §6); DRYRUN_DATA_ONLY: the step before the model
# split, every leaf gathered over the whole grid
DRYRUN_CELLS = [
    ("gemma3-1b", "train_4k", False, False,
     (101347048, 7520, 999940608, 342, 12793477708)),
    ("llama4-maverick-400b-a17b", "decode_32k", True, False,
     (3341134676, 135232, 1620049078784, 0, 0))]
DRYRUN_GATHER_ALL = {"gemma3-1b|train_4k": {"bytes_per_step": 7998501956,
                                      "temp_bytes": 58.8e9}}
DRYRUN_DATA_ONLY = {"gemma3-1b|train_4k": {
    "broadcasts": 45200, "broadcast_bytes": 6790537728, "all_sums": 239,
    "all_sum_bytes": 3999251020, "temp_bytes": 58.83e9}}


def rule_shardings(cfg, state, dims) -> tuple:
    """(a shape-only ("data", "model") grid of ``dims``, the split step's
    `Sharding` of every leaf of a whole adamw train state by the rules
    (`layout.state_shardings`), by `layout.flat` path joined with
    dots)."""
    from repro_torch.launch.mesh import GridMesh
    from repro_torch.sharding.layout import flat, state_shardings
    grid = GridMesh(("data", "model"), dims)
    sh = state_shardings(state, cfg, grid, "adamw")
    return grid, {".".join(p): s for p, s in flat(sh).items()}


def grid_rank(mesh, argv, threads, detail, layers, digest, dtype,
              ref=None) -> dict:
    """One spawned rank of (b)'s grids: `launch.train.rank_main` and the
    kernel launches the rank made.  With ``ref`` (an .npz of one rank's
    first reduced gradients by name) the rank holds its own against it
    here -- ``grad_err`` (the largest difference) and ``grad_max`` (the
    reference's largest element) -- and returns (shape, sha256) digests
    in place of its arrays."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train as T
    ops.reset_launch_counts()
    out = T.rank_main(mesh, argv, threads, detail, layers,
                      digest and ref is None, dtype)
    out["launches"] = ops.launch_counts()
    if ref is not None:
        import numpy as np
        want = np.load(ref)
        out["grad_err"] = max(float(np.abs(g - want[k]).max())
                              for k, g in out["grads"].items())
        out["grad_max"] = max(float(np.abs(want[k]).max())
                              for k in want.files)

        def digest_of(a):
            return a.shape, hashlib.sha256(np.ascontiguousarray(a).data) \
                .hexdigest()
        for key in ("grads", "blocks"):
            out[key] = {k: digest_of(a) for k, a in out[key].items()}
    return out


def _host(x) -> bytes:
    """An array's bytes, or a (shape, sha256) digest's hash, for equality
    across ranks."""
    return x[1].encode() if isinstance(x, tuple) else x.tobytes()


def hold_grid(ranks, cfg, state, what: str) -> dict:
    """(b)'s bitwise checks of a grid run against itself: every rank's
    first reduced gradient the same bits; each leaf's blocks of the rules'
    shard shapes, and the ranks that hold one block the same bits (each
    updated it from the same gradient); the last step's collectives equal
    to `layout.step_plan`, which gathers no optimizer leaf; every rank of
    a model line computing its own share of the heads, mlp columns and
    vocab rows (`sharding.tensor.recording`: a dim that divides the model
    axis split, its block at the rank's model coordinate, else whole).
    ``state`` is a whole one-rank state of the same config (its shapes).
    -> leaves split / whole, a rank's resident bytes, the shares the
    ranks of model line 0 reported."""
    import math
    from repro_torch.sharding.layout import block_slices, flat, shard_shape
    want = {".".join(p): t for p, t in flat(state).items()}
    grid, sh = rule_shardings(cfg, state, LAUNCH_GRID)
    lead = ranks[0]
    for r in ranks:
        require(set(r["grads"]) == set(lead["grads"]) and all(
            _host(g) == _host(lead["grads"][k])
            for k, g in r["grads"].items()), f"{what}: rank "
            f"{r['coords']}'s reduced gradient differs from rank 0's")
        require(set(r["blocks"]) == set(want), f"{what}: rank "
                f"{r['coords']} holds other leaves than the one-rank state")
        m, msize = r["coords"]["model"], LAUNCH_GRID[1]
        require({"heads", "mlp", "vocab"} <= set(r["shares"]) and all(
            (n, first) == ((whole // msize, m * whole // msize)
                           if whole % msize == 0 else (whole, None))
            for seen in r["shares"].values() for n, whole, first in seen),
            f"{what}: rank {r['coords']} computed the shares "
            f"{r['shares']} (a model line of {msize})")
        plan = r["plan"]
        require(r["counts"] == {"broadcast": plan["broadcast"],
                                "all_sum": plan["all_sum"]}
                and plan["broadcast"] > 0 and plan["gathered"] and all(
                    k.startswith("params.") for k in plan["gathered"]),
                f"{what}: rank {r['coords']} collectives {r['counts']}, "
                f"plan {dict(plan, gathered=len(plan['gathered']))}")
    shared = 0
    for k, v in want.items():
        held = {}
        for r in ranks:
            got = r["blocks"][k]
            shape = tuple(got[0] if isinstance(got, tuple) else got.shape)
            require(shape == shard_shape(v.shape, sh[k]), f"{what}: rank "
                    f"{r['coords']} holds {k} {shape}, the rules' shard is "
                    f"{shard_shape(v.shape, sh[k])}")
            held.setdefault(str(block_slices(v.shape, sh[k], r["coords"])),
                            set()).add(_host(got))
        require(all(len(b) == 1 for b in held.values()), f"{what}: the "
                f"ranks holding one block of {k} differ")
        shared += len(held) < len(ranks)
    split = sum(tuple(v.shape) != shard_shape(v.shape, sh[k])
                for k, v in want.items())
    return {"leaves_split": split, "leaves_whole": len(want) - split,
            "leaves_shared_bitwise": shared,
            "shares_model_line_0": {str(r["coords"]): r["shares"]
                                    for r in ranks
                                    if r["coords"]["data"] == 0},
            "resident_bytes_rank0": sum(
                math.prod(shard_shape(v.shape, sh[k])) * v.element_size()
                for k, v in want.items()),
            "whole_bytes": sum(v.numel() * v.element_size()
                               for v in want.values())}


def launch_full(smi: str) -> dict:
    """(a): `launch.train` on gemma3-1b at full width and depth, one rank
    on the card, with the aux: every loss finite, K1 exactly steps x
    microbatches x (d_model - 1) and no other kernel, no collective; the
    step times, tokens/s, peak memory and the final checkpoint's
    seconds (its host copy and its write)."""
    import tempfile
    import torch
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.core import mesh as M
    from repro_torch.kernels import ops
    from repro_torch.launch import train as T
    b, t = LAUNCH_SHAPE
    spent = {"host_copy_s": 0.0, "write_s": 0.0}

    def timing(fn, key):
        def wrapped(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[key] += time.perf_counter() - t0
        return wrapped
    host, write = ckpt._host_leaves, ckpt._write
    with tempfile.TemporaryDirectory(prefix="repro_torch_launch_") as tmp:
        argv = ["--arch", "gemma3-1b", "--full", "--steps",
                str(LAUNCH_STEPS), "--batch", str(b), "--seq", str(t),
                "--microbatches", str(LAUNCH_MICRO), "--logdet-reg",
                str(TRAIN_LOGDET), "--log-every", "1", "--ckpt-dir", tmp,
                "--ckpt-every", str(LAUNCH_STEPS)]
        args = T.parser().parse_args(argv)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        M.reset_collective_counts()
        ckpt._host_leaves = timing(host, "host_copy_s")
        ckpt._write = timing(write, "write_s")
        try:
            t0 = time.perf_counter()
            state, losses, stats = T._run(args, T._mesh("1x1", "cuda"))
            run_s = time.perf_counter() - t0
        finally:
            ckpt._host_leaves, ckpt._write = host, write
        counts = ops.launch_counts()
        collectives = M.collective_counts()
        peak = torch.cuda.max_memory_allocated()
        written = sorted(p.name for p in Path(tmp).iterdir())
    d = get_config("gemma3-1b").d_model
    want_k1 = LAUNCH_STEPS * LAUNCH_MICRO * (d - 1)
    steps = stats.times
    step_s = sorted(steps[1:])[len(steps[1:]) // 2]
    out = {"params": sum(p.numel() for p in state["params"].parameters()),
           "shape": [b, t], "microbatches": LAUNCH_MICRO,
           "step_s": steps, "step_s_median_after_first": step_s,
           "tokens_per_s": b * t / step_s, "peak_mem_bytes": peak,
           "checkpoint": spent, "run_s": run_s, "losses": losses,
           "launches": counts, "expected_k1": want_k1,
           "collectives": collectives, "written": written, "card": smi}
    require(all(v == v and abs(v) != float("inf") for v in losses)
            and len(losses) == LAUNCH_STEPS and stats.restarts == 0,
            f"launch full: losses {losses}, restarts {stats.restarts}")
    require(counts.get("rank1_update", 0) == want_k1 and not any(
        v for n, v in counts.items() if n != "rank1_update"),
        f"launch full: launches {counts}, want K1 {want_k1} and nothing else")
    require(not any(collectives.values()),
            f"launch full: one rank issued collectives {collectives}")
    require(written == [f"step_{LAUNCH_STEPS:08d}"],
            f"launch full: checkpoints {written}")
    return out


def _one_rank(args, dtype, layers=None) -> tuple:
    """One rank on the card through `launch.train`'s build and loop ->
    (final state, losses, step stats, the first step's reduced gradients
    and metrics, the peak allocation, the kernel launches)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import train as T
    first = {}

    def keep(grads, metrics):
        if not first:
            first["grads"] = {k: g.detach().cpu() for k, g in grads.items()}
            first["metrics"] = {k: float(v) for k, v in metrics.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    state, losses, stats = T._run(args, T._mesh("1x1", "cuda"), layers,
                                  dtype, on_grads=keep)
    return (state, losses, stats, first, torch.cuda.max_memory_allocated(),
            ops.launch_counts())


def _spread(xs) -> list:
    return [min(xs), max(xs)] if xs else []


def launch_grid(smi: str) -> dict:
    """(b): the JAX launcher test's run with the aux, f32, on a 2x2 grid
    of gloo ranks sharing the card (`launch.train.rank_main`) against one
    rank in this process: the split step's gates (the first reduced
    gradient, its metrics, every step's loss, the mean loss over the
    run's batches falling from the first parameters to the grid's last),
    `hold_grid`, K1 on every rank; then the grid's step-25 checkpoint
    restored onto a 2x2 grid, bitwise the saved blocks and ending on the
    2x2 run's step-30 checkpoint files bit for bit; onto a 2x1 grid,
    bitwise the saved blocks and on within the loss gate of the 2x2 run
    (its model line's split products are one rank's whole ones there);
    and onto one rank here, bitwise the saved state and on within the
    loss gate."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    import torch
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.core.mesh import run_ranks
    from repro_torch.launch import train as T
    from repro_torch.optim import global_norm
    from repro_torch.train.step import make_loss_fn
    spec = "x".join(map(str, LAUNCH_GRID))
    argv = LAUNCH_ARGV + ["--logdet-reg", str(TRAIN_LOGDET)]
    f32 = torch.float32
    with tempfile.TemporaryDirectory(prefix="repro_torch_launch_") as tmp:
        t0 = time.perf_counter()
        ranks = run_ranks(grid_rank, LAUNCH_GRID[0] * LAUNCH_GRID[1],
                          backend="gloo", device="cuda",
                          timeout=LAUNCH_TIMEOUT,
                          args=(argv + ["--mesh", spec, "--device", "cuda",
                                        "--ckpt-dir", f"{tmp}/grid"], None,
                                True, None, False, f32))
        grid_s = time.perf_counter() - t0
        args = T.parser().parse_args(argv + ["--ckpt-dir", f"{tmp}/one"])
        t0 = time.perf_counter()
        one, losses, stats, first, _, one_launches = _one_rank(args, f32)
        one_k1 = one_launches["rank1_update"]
        one_s = time.perf_counter() - t0
        cfg = one["params"].cfg

        def restore(onto, n):
            return run_ranks(
                T.rank_restore, n, backend="gloo", device="cuda",
                timeout=LAUNCH_TIMEOUT,
                args=(argv + ["--device", "cuda", "--ckpt-dir",
                              f"{tmp}/restored{n}"], onto, f"{tmp}/grid",
                      LAUNCH_RESTORE_AT, None, f32))
        # the restores onto the layout it was saved from (bitwise the 2x2
        # run's end) and, elastic, onto a 2x1 grid (the same data split),
        # both at once and beside the work below (their seconds are not
        # measured)
        with ThreadPoolExecutor(2) as pool:
            restoring = [pool.submit(restore, spec,
                                     LAUNCH_GRID[0] * LAUNCH_GRID[1]),
                         pool.submit(restore, "2x1", 2)]
            layout_out = hold_grid(ranks, cfg, one, "launch grid")
            # the grid's last parameters, from its step-30 checkpoint
            last, _ = ckpt.restore(f"{tmp}/grid", T.build(
                args.arch, smoke=True, mesh=T._mesh("1x1", "cuda"),
                tcfg=T._tcfg(args), batch=args.batch, seq=args.seq,
                dtype=f32)[1], device="cuda")
            _, first_state, _, batch_fn, _ = T.build(
                args.arch, smoke=True, mesh=T._mesh("1x1", "cuda"),
                tcfg=T._tcfg(args), batch=args.batch, seq=args.seq,
                dtype=f32)
            loss_fn = make_loss_fn(cfg, T._tcfg(args))
            with torch.no_grad():
                held = [sum(float(loss_fn(s["params"], batch_fn(i))[0])
                            for i in range(args.steps)) / args.steps
                        for s in (first_state, last)]
            del first_state, last
            # elastic, onto one rank
            one_restored = T.rank_restore(
                None, argv + ["--device", "cuda", "--ckpt-dir",
                              f"{tmp}/restored1"], "1x1", f"{tmp}/grid",
                LAUNCH_RESTORE_AT, dtype=f32)
            at1, cont = one_restored["at"], one_restored["losses"]
            restored1 = one_restored["restored_bitwise"]
            restored4, restored2 = (f.result() for f in restoring)
        end = f"step_{args.steps:08d}"
        files = sorted(p.name for p in Path(f"{tmp}/grid/{end}").iterdir())
        end_same = files == sorted(
            p.name for p in Path(f"{tmp}/restored4/{end}").iterdir()) and all(
            Path(f"{tmp}/grid/{end}/{f}").read_bytes()
            == Path(f"{tmp}/restored4/{end}/{f}").read_bytes()
            for f in files)
    # the gates against one rank
    want = first["grads"]
    gmax = max(float(g.abs().max()) for g in want.values())
    worst = 0.0
    for r in ranks:
        worst = max(worst, max(float((torch.from_numpy(g) - want[k]).abs()
                                     .max()) for k, g in r["grads"].items()))
    tol = TRAIN_GRAD_TOL["default"]
    require(worst <= tol * gmax, f"launch grid: the first reduced gradient "
            f"off one rank's by {worst}, {worst / gmax:.3g} of its largest "
            f"element (gate {tol})")
    norm = float(global_norm(want))
    metrics = dict(first["metrics"], grad_norm=norm)
    for r in ranks:
        got = dict(r["grad_metrics"], grad_norm=float(global_norm(
            {k: torch.from_numpy(g) for k, g in r["grads"].items()})))
        for k, v in metrics.items():
            rtol = TRAIN_NORM_RTOL if k == "grad_norm" else TRAIN_METRIC_RTOL
            require(abs(got[k] - v) <= rtol * abs(v), f"launch grid: rank "
                    f"{r['coords']} {k} {got[k]}, one rank's {v}")
    loss_err = max(max(abs(a - b) / abs(b) for a, b in
                       zip(r["losses"], losses)) for r in ranks)
    require(all(len(r["losses"]) == len(losses) == args.steps
                for r in ranks) and loss_err <= LAUNCH_LOSS_RTOL,
            f"launch grid: the losses off one rank's by {loss_err} relative "
            f"(gate {LAUNCH_LOSS_RTOL})")
    require(held[1] < held[0], f"launch grid: the mean loss over the "
            f"run's batches {held[0]} -> {held[1]}")
    k1 = [r["launches"].get("rank1_update", 0) for r in ranks]
    want_k1 = args.steps * (cfg.d_model - 1)
    require(k1 == [want_k1] * len(ranks) and one_k1 == args.steps * (
        cfg.d_model - 1), f"launch grid: K1 {k1} on the ranks (want "
        f"{want_k1} each), {one_k1} on one rank")
    require(all(r["at"] == LAUNCH_RESTORE_AT and r["restored_bitwise"]
                and r["losses"] == ranks[0]["losses"][LAUNCH_RESTORE_AT:]
                for r in restored4) and end_same, "launch grid: the 2x2 "
            "checkpoint restored onto 2x2 is not bitwise the saved blocks, "
            "or ends off the 2x2 run's last checkpoint")
    # the 2x1 grid splits the batch as the 2x2 one, but sums the products
    # that the 2x2 grid's model line splits in one rank: on within the
    # loss gate of the 2x2 run it continues, the same on both ranks
    end_err = max(abs(a - b) / abs(b) for a, b in
                  zip(restored2[0]["losses"], ranks[0]["losses"][
                      LAUNCH_RESTORE_AT:]))
    require(all(r["at"] == LAUNCH_RESTORE_AT and r["restored_bitwise"]
                and r["losses"] == restored2[0]["losses"]
                for r in restored2) and len(restored2[0]["losses"]) == 5
            and end_err <= LAUNCH_LOSS_RTOL, "launch grid: the 2x2 "
            "checkpoint restored onto 2x1 is not bitwise the saved blocks, "
            f"or goes on off the 2x2 run's losses by {end_err}")
    cont_err = max(abs(a - b) / abs(b) for a, b in
                   zip(cont, losses[LAUNCH_RESTORE_AT:]))
    require(at1 == LAUNCH_RESTORE_AT and restored1 and len(cont) == 5
            and cont_err <= LAUNCH_LOSS_RTOL, f"launch grid: the 2x2 "
            f"checkpoint onto one rank: restored bitwise {restored1}, its "
            f"losses off one rank's by {cont_err}")
    return {"launches": {"launch|grid one rank": one_launches,
                         "launch|grid rank 0": ranks[0]["launches"]},
            "grid": spec, "backend": "gloo", "ranks": len(ranks),
            "devices": sorted({r["device"] for r in ranks}),
            "grid_run_s": grid_s, "one_rank_run_s": one_s,
            "rank_step_s_median": [sorted(r["step_s"])[len(r["step_s"]) // 2]
                                   for r in ranks],
            "one_rank_step_s_median": sorted(stats.times)[
                len(stats.times) // 2],
            "rank_step_peak_bytes": [r["step_peak_bytes"] for r in ranks],
            "broadcasts_per_step": ranks[0]["counts"]["broadcast"],
            "all_sums_per_step": ranks[0]["counts"]["all_sum"],
            "bytes_per_step": ranks[0]["plan"]["bytes"]
            + ranks[0]["plan"]["all_sum_bytes"],
            **layout_out, "k1_per_rank": k1, "k1_one_rank": one_k1,
            "first_grad_err_of_max": worst / gmax,
            "loss_err_rel": loss_err, "loss_first_last": [losses[0],
                                                         losses[-1]],
            "held_loss_first_last_params": held,
            "restored_2x2_bitwise_and_end": end_same,
            "restored_2x1_loss_err_rel": end_err,
            "restored_1x1_loss_err_rel": cont_err,
            "model_all_sums_per_step": ranks[0]["plan"]["model_all_sum"],
            "model_all_sum_bytes_per_step": ranks[0]["plan"][
                "model_all_sum_bytes"],
            "gather_all_step": LAUNCH_GRID_GATHER_ALL,
            "data_only_step": LAUNCH_GRID_DATA_ONLY, "card": smi,
            "note": "four ranks share one card; collectives pass through "
                    "host memory: not a scaling figure"}


def launch_grid_wide(smi: str) -> dict:
    """(b) at full width and depth: gemma3-1b at LAUNCH_WIDE_LAYERS
    layers, LAUNCH_WIDE_STEPS steps with the aux, f32, one rank in this
    process, then the same run through `launch.train.rank_main` on the
    2x2 grid of gloo ranks sharing the card (its final checkpoint
    gathered and written by rank 0), the one rank's state dropped first
    (its shapes kept on meta): each rank's first reduced gradient within
    TRAIN_GRAD_TOL of one rank's largest element (held on the rank,
    against one rank's saved to a file), every step's loss within
    LAUNCH_LOSS_RTOL of one rank's, `hold_grid` (sha256 digests), K1
    steps x (d_model - 1) on every rank and on one rank; a rank's step
    s, its peak allocation and the high-water of whole parameter bytes
    alive at once in its last step, the bytes a step, a rank's resident
    bytes, beside the gather-all step's figures."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch.core.mesh import run_ranks
    from repro_torch.launch import train as T
    from repro_torch.models.model import Model
    from repro_torch.models.common import empty_init
    from repro_torch.optim import OptConfig, get_optimizer
    b, t = LAUNCH_WIDE_SHAPE
    f32 = torch.float32
    argv = ["--arch", "gemma3-1b", "--full", "--steps",
            str(LAUNCH_WIDE_STEPS), "--batch", str(b), "--seq", str(t),
            "--log-every", "1", "--logdet-reg", str(TRAIN_LOGDET)]
    spec = "x".join(map(str, LAUNCH_GRID))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="repro_torch_launch_") as tmp:
        args = T.parser().parse_args(argv + ["--ckpt-dir", f"{tmp}/one"])
        t0 = time.perf_counter()
        one, losses, stats, first, one_peak, one_launches = _one_rank(
            args, f32, LAUNCH_WIDE_LAYERS)
        one_s = time.perf_counter() - t0
        ref = f"{tmp}/one_grads.npz"
        np.savez(ref, **{k: g.numpy() for k, g in first["grads"].items()})
        cfg = one["params"].cfg
        del first, one
        torch.cuda.empty_cache()
        meta = Model(cfg, empty_init(torch.device("meta")))
        shapes = {"params": meta,
                  "opt": get_optimizer(OptConfig())[0](meta),
                  "step": torch.zeros((), dtype=torch.int32, device="meta")}
        t0 = time.perf_counter()
        ranks = run_ranks(grid_rank, LAUNCH_GRID[0] * LAUNCH_GRID[1],
                          backend="gloo", device="cuda",
                          timeout=LAUNCH_WIDE_TIMEOUT,
                          args=(argv + ["--mesh", spec, "--device", "cuda",
                                        "--ckpt-dir", f"{tmp}/grid"], None,
                                True, LAUNCH_WIDE_LAYERS, True, f32, ref))
        grid_s = time.perf_counter() - t0
        written = sorted(p.name for p in Path(f"{tmp}/grid").iterdir())
    layout_out = hold_grid(ranks, cfg, shapes, "launch grid wide")
    gmax = ranks[0]["grad_max"]
    worst = max(r["grad_err"] for r in ranks)
    tol = TRAIN_GRAD_TOL["default"]
    require(worst <= tol * gmax, f"launch grid wide: the first reduced "
            f"gradient off one rank's by {worst}, {worst / gmax:.3g} of its "
            f"largest element (gate {tol})")
    loss_err = max(max(abs(a - b) / abs(b) for a, b in
                       zip(r["losses"], losses)) for r in ranks)
    require(all(len(r["losses"]) == len(losses) == LAUNCH_WIDE_STEPS
                and all(v == v and abs(v) != float("inf")
                        for v in r["losses"]) for r in ranks)
            and loss_err <= LAUNCH_LOSS_RTOL,
            f"launch grid wide: losses {[r['losses'] for r in ranks]}, one "
            f"rank's {losses} (gate {LAUNCH_LOSS_RTOL} relative)")
    require(written == [f"step_{LAUNCH_WIDE_STEPS:08d}"],
            f"launch grid wide: checkpoints {written}")
    k1 = [r["launches"].get("rank1_update", 0) for r in ranks]
    want_k1 = LAUNCH_WIDE_STEPS * (cfg.d_model - 1)
    one_k1 = one_launches.get("rank1_update", 0)
    require(k1 == [want_k1] * len(ranks) and one_k1 == want_k1,
            f"launch grid wide: K1 {k1} on the ranks (want {want_k1} "
            f"each), {one_k1} on one rank")
    return {"launches": {"launch|grid wide one rank": one_launches,
                         "launch|grid wide rank 0": ranks[0]["launches"]},
            "arch": "gemma3-1b", "d_model": cfg.d_model,
            "layers": cfg.n_layers, "vocab": cfg.vocab, "dtype": "float32",
            "logdet_reg": TRAIN_LOGDET,
            "shape": [b, t], "steps": LAUNCH_WIDE_STEPS, "grid": spec,
            "backend": "gloo", "grid_run_s": grid_s, "one_rank_run_s": one_s,
            "rank_step_s": [r["step_s"] for r in ranks],
            "rank_step_s_after_first": _spread(
                [s for r in ranks for s in r["step_s"][1:]]),
            "one_rank_step_s": stats.times,
            "one_rank_peak_mem_bytes": one_peak,
            "rank_step_peak_bytes": [r["step_peak_bytes"] for r in ranks],
            "rank_whole_peak_bytes": [r["whole_peak_bytes"] for r in ranks],
            "rank_whole_peak_units": [r["whole_peak_units"] for r in ranks],
            "broadcasts_per_step": ranks[0]["counts"]["broadcast"],
            "all_sums_per_step": ranks[0]["counts"]["all_sum"],
            "bytes_per_step": ranks[0]["plan"]["bytes"]
            + ranks[0]["plan"]["all_sum_bytes"],
            "gathered_bytes_per_step": ranks[0]["plan"]["bytes"],
            "reduced_bytes_per_step": ranks[0]["plan"]["all_sum_bytes"]
            - ranks[0]["plan"]["model_all_sum_bytes"],
            "model_all_sums_per_step": ranks[0]["plan"]["model_all_sum"],
            "model_all_sum_bytes_per_step": ranks[0]["plan"][
                "model_all_sum_bytes"],
            **layout_out, "k1_per_rank": k1, "k1_one_rank": one_k1,
            "first_grad_err_of_max": worst / gmax,
            "losses": losses, "loss_err_rel": loss_err,
            "gather_all_step": LAUNCH_WIDE_GATHER_ALL,
            "data_only_step": LAUNCH_WIDE_DATA_ONLY, "card": smi}


def launch_serve(seed: int, smi: str) -> dict:
    """(c): `launch.serve.generate` on the card against the CPU on the
    same parameters (f32), its logits within SMOKE_ATOL of max(1,
    |logits|) and its greedy tokens equal until the CPU's top-2 margin is
    within twice that; tokens/s of a second call; the CLI's (B, P + G)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as S
    from repro_torch.models import model as M
    from repro_torch.models.common import empty_init
    out = {}
    for arch, b, p, g in LAUNCH_SERVE:
        cfg = get_config(arch, smoke=True).replace(dtype=torch.float32,
                                                   remat=False)
        cpu = M.init_model(cfg, generator=torch.Generator().manual_seed(seed),
                           device="cpu")
        card = M.Model(cfg, empty_init("cuda"))
        card.load_state_dict({k: v.to("cuda")
                              for k, v in cpu.state_dict().items()})
        prompt = torch.from_numpy(np.random.default_rng(seed).integers(
            0, cfg.vocab, (b, p)).astype(np.int32))
        runs = {}
        for dev, model in (("cpu", cpu), ("cuda", card)):
            seen = []
            prefill, decode = M.prefill, M.decode_step

            def rec(fn):
                def wrapped(*a, **k):
                    lg, c = fn(*a, **k)
                    seen.append(lg[:, -1].float().cpu())
                    return lg, c
                return wrapped
            M.prefill, M.decode_step = rec(prefill), rec(decode)
            try:
                toks = S.generate(model, prompt.to(dev), max_len=p + g,
                                  gen=g).cpu()
            finally:
                M.prefill, M.decode_step = prefill, decode
            runs[dev] = (toks, seen)
        (tc, lc), (tk, lk) = runs["cpu"], runs["cuda"]
        err, compared = 0.0, 0
        for i, (x, y) in enumerate(zip(lk, lc)):
            scale = max(1.0, float(y.abs().max()))
            err = max(err, float((x - y).abs().max()) / scale)
            top2 = torch.sort(y, dim=-1).values[:, -2:]
            if float((top2[:, 1] - top2[:, 0]).min()) <=                     2 * SMOKE_ATOL * scale:
                break
            require(torch.equal(tk[:, p + i], tc[:, p + i]),
                    f"launch serve {arch}: greedy token {i} differs")
            compared += 1
        require(err <= SMOKE_ATOL, f"launch serve {arch}: card logits off "
                f"the CPU's by {err} of max(1, |logits|)")
        _, s = timed(lambda: S.generate(card, prompt.to("cuda"),
                                        max_len=p + g, gen=g))
        cli = S.main(["--arch", arch, "--batch", str(b), "--prompt-len",
                      str(p), "--gen", str(g)])
        require(tuple(cli.shape) == (b, p + g) and cli.is_cuda,
                f"launch serve {arch}: CLI tokens {tuple(cli.shape)}")
        out[arch] = {"logit_err_rel_to_max": err, "tokens_compared":
                     compared, "of": g, "tokens_per_s": b * g / s,
                     "generate_s": s}
    out["card"] = smi
    return out


def launch_dryrun() -> dict:
    """(d): the dry run's DRYRUN_CELLS at full size; each record's
    argument bytes, broadcasts, all_sums and their bytes against the JAX
    rules' totals for the cell (DRYRUN_CELLS), the gather-all step's
    figures beside the train cell's."""
    from repro_torch.launch import dryrun as D
    out = {}
    for arch, shape, multi_pod, fast, want in DRYRUN_CELLS:
        t0 = time.perf_counter()
        rec = D.run_cell(arch, shape, multi_pod=multi_pod, fast=fast,
                         verbose=False)
        seconds = time.perf_counter() - t0
        got = (rec["memory"]["argument_bytes_per_device"],
               rec["collective_counts"]["broadcast"],
               rec["collective_bytes_by_op"]["broadcast"],
               rec["collective_counts"].get("all_sum", 0),
               rec["collective_bytes_by_op"].get("all_sum", 0))
        require(got == want, f"dryrun {arch} x {shape}: (argument bytes, "
                f"broadcasts, their bytes, all_sums, their bytes) {got}, "
                f"the JAX rules' {want}")
        require((rec["memory"]["temp_bytes_per_device"] is None) == fast,
                f"dryrun {arch} x {shape}: temp bytes "
                f"{rec['memory']['temp_bytes_per_device']} "
                f"({rec['memory'].get('temp_bytes_error')})")
        out[f"{arch}|{shape}|{rec['mesh']}"] = dict(
            rec, seconds=seconds,
            gather_all_step=DRYRUN_GATHER_ALL.get(f"{arch}|{shape}"),
            data_only_step=DRYRUN_DATA_ONLY.get(f"{arch}|{shape}"))
    return out


def launch_phase(seed: int, smi: str) -> dict:
    """Phase 15: (a) `launch.train` at full width through K1; (b) the 2x2
    grid and elastic restore, at the JAX test's settings and at full
    width; (c) `launch.serve`; (d) the dry run, which needs no card (meta
    tensors), in a process of its own beside (a)-(c).
    Returns launches by route."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    import torch
    t0 = time.perf_counter()
    with ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool:
        dryrun = pool.submit(launch_dryrun)
        full = launch_full(smi)
        launches = {"launch|train gemma3-1b full": full.pop("launches")}
        say("launch", part="train gemma3-1b full", **full)
        torch.cuda.empty_cache()
        grid = launch_grid(smi)
        launches.update(grid.pop("launches"))
        say("launch", part="grid", **grid)
        wide = launch_grid_wide(smi)
        launches.update(wide.pop("launches"))
        say("launch", part="grid gemma3-1b full width and depth", **wide)
        say("launch", part="serve", **launch_serve(seed, smi))
        cells = dryrun.result()
    for cell, rec in cells.items():
        say("launch", part="dryrun", cell=cell, **rec)
    say("launch", seconds=time.perf_counter() - t0)
    return launches



def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=8192,
                    help="matrix side of the kernel and main-path phases")
    ap.add_argument("--k", type=int, default=32, help="panel width")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        print("chip_smoke.py must sit at the root of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py measures the card and never "
              "falls back to the CPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 1: device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    say("device", kind=kind, count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    print(smi, flush=True)

    # phase 2: build
    from repro_torch.kernels import _build
    report = _build.build()
    say("build", dir=report["dir"], cached=report["cached"],
        nvcc_seconds=report["nvcc_seconds"], kernels=report["kernels"])

    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    # phase 3: kernels against their plain versions, and their times
    timings = kernel_phase(args.n, args.k, gen)
    timings["panel_update"]["shapes"].update(panel_update_auto_phase(gen))
    stack_times = stack_kernel_phase(gen)
    k4_times = panel_factor_phase(gen)
    timings["panel_factor"] = dict(
        k4_times["float32|32|8192"], float64=k4_times["float64|32|8192"],
        shapes={t: {f: v[f] for f in ("ms", "ms_per_step", "plain_ms",
                                      "library_ms", "library_default_ms",
                                      "plan")}
                | {"bound_ms": v["bound"][0]} for t, v in k4_times.items()})
    for name, by_shape in stack_times.items():
        timings[name].setdefault("shapes", {}).update(
            {f"stack {t}": v for t, v in by_shape.items()})
    est_timings = estimator_kernel_phase(EST_N, SIDE, gen)
    for name, by_dtype in est_timings.items():
        timings[name] = dict(by_dtype["float32"],
                             float64=by_dtype["float64"])
    mv = matvec_phase(EST_N, MESH_RANKS, gen)
    timings["matvec"] = dict(mv[f"float32|{EST_N}|{PROBES}"],
                             float64=mv[f"float64|{EST_N}|{PROBES}"],
                             shapes={t: {f: v[f] for f in (
                                 "ms", "library_ms", "max_rel_to_bound",
                                 "plan")}
                                 | {"bound_ms": v["bound"][0]}
                                 for t, v in mv.items()})
    # phase 4: the main path
    launches, walls, cell = main_path_phase(args.n, args.k, gen)
    # phase 4b: method="auto" on the port's measured table
    launches.update(auto_phase(args.n, gen, walls))
    # phase 5: the estimators
    launches.update(estimator_phase(EST_N, SIDE, args.seed))
    # phase 6: the mesh (the ranks are spawned: CUDA is initialized here)
    mesh_launches, grids = mesh_phase(args.n, args.k, args.seed)
    launches.update(mesh_launches)
    # phase 7: gradients (their mesh checks ran in phase 6's ranks)
    t7 = time.perf_counter()
    launches.update(grad_phase(cell, args.k, args.seed, gen))
    exact_a = cell[0]
    del cell
    say("grad", seconds=time.perf_counter() - t7)
    torch.cuda.empty_cache()
    # phase 8: stacks
    launches.update(stacks_phase(args.seed))
    # phase 9: structured operators
    launches.update(structured_phase(args.seed))
    # phase 10: the first trace of the exact routes, on phase 4's matrix
    launches.update(trace_phase(exact_a, args.k))
    del exact_a
    torch.cuda.empty_cache()
    # phase 11: the service
    serve_launches, serve_k1 = serve_phase(args.seed, gen)
    launches.update(serve_launches)
    timings["rank1_update"].setdefault("shapes", {}).update(serve_k1)
    torch.cuda.empty_cache()
    # phase 12: static analysis and the deprecated string API
    launches.update(audit_phase(args.n, gen, grids))
    torch.cuda.empty_cache()
    # phase 13: the models, configs and data
    launches.update(models_phase(args.seed, args.k, smi))
    torch.cuda.empty_cache()
    # phase 14: training, the logdet aux through K1
    launches.update(train_phase(args.seed, smi))
    torch.cuda.empty_cache()
    # phase 15: launch and sharding, the train launcher's aux through K1
    launches.update(launch_phase(args.seed, smi))

    kernels = []
    for name, (source, replaces) in KERNEL_META.items():
        t = timings[name]
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(c[name] for c in launches.values()),
            "launches_by_route": {r: c[name] for r, c in launches.items()},
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": t["library_ms"]}
        # yardsticks beside a kernel: a pure stream of its bytes (K1),
        # cuBLAS's product and K5's alone (K6, K7), other shapes
        extras = ("library_error", "copy_ms", "matmul_ms", "matvec_ms",
                  "shapes")
        entry.update({f: t[f] for f in extras if t.get(f) is not None})
        for variant in ("float64", "bf16_operands"):
            if variant in t:
                v = t[variant]
                entry[variant] = {
                    "max_abs_err": v["max_abs_err"], "ms": v["ms"],
                    "plain_ms": v["plain_ms"], "bound_ms": v["bound"][0],
                    "bound_by": v["bound"][1],
                    "library_ms": v["library_ms"]}
                entry[variant].update({f: v[f] for f in extras
                                       if v.get(f) is not None})
        kernels.append(entry)
    say("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
