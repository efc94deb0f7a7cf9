"""Dry run over the production meshes -- counterpart of
`repro.launch.dryrun`: every (arch x shape x mesh) cell's step, laid out
by the sharding rules on the 16x16 and 2x16x16 meshes, without a device.

The JAX package lowers and compiles each cell on 512 fake XLA devices
and reads the compiler's analyses.  PyTorch has no lowering, so each
record key takes a torch meaning here, on tensors that hold no storage:

- ``memory.argument_bytes_per_device``: one rank's blocks of the cell's
  arguments (the train state, or the parameters and caches, plus the
  batch) by the rules on the production mesh (`sharding.layout`);
  ``output_bytes_per_device`` likewise for the outputs (the state's or
  the caches' blocks, the logits and metrics whole);
- every cell runs rank 0's share on a shape-only mesh with rank 0's
  coordinates.  A train cell takes the split mesh step itself
  (`sharding.layout.mesh_step`): the parameters' gathers (one unit at a
  time, `sharding.fsdp`) copy rank 0's blocks into the tensors it
  computes on (a leaf the model line splits: its model block), its rows
  of every microbatch run inside a shape-only data split
  (`sharding.split`: the statistics of the whole batch and the
  gradients' reduction keep their shapes, nothing is exchanged) and a
  shape-only model split (`sharding.tensor`: rank 0's heads, mlp
  columns, experts, vocab rows and SSM heads), and the optimizer
  updates its blocks.  A serving cell runs `sharding.serving`'s
  ``mesh_prefill`` / ``mesh_decode`` the same way, forward only, on rank
  0's rows and its blocks of the caches;
- ``hlo_flops_global``: the FLOPs `torch.utils.flop_counter` counts over
  that run on the meta device, ``flops_per_device`` (rank 0's share, a
  1/``chips`` share of the work the rules split) times ``chips``, what
  the mesh executes: a module the rules leave whole on the model axis
  (gemma3-1b's 4 heads on 16, the router, an SSM block whose heads do
  not divide it) is computed alike by every rank of a model line, which
  ``useful_flops_frac`` shows;
- ``hlo_bytes_global``: the operand and result bytes of every ATen op of
  that run, recorded on meta (`analysis.ir.record`): the eager port runs
  unfused, so this is what its step moves; ``hlo_bytes_per_device``
  times ``chips``;
- ``wire_bytes_per_chip`` / ``collective_counts``: the call's
  collectives a rank, each counted by the bytes of the tensor it moves.
  A train cell's are `sharding.layout.step_plan`'s: the parameters'
  gathers by broadcasts, a layer's for its forward and again for its
  backward; the batch statistics' exchanges, the gradients' reduction,
  the model line's partial sums, the global norm and the agreement by
  all_sums.  A serving cell's are `sharding.layout.serve_plan`'s, read
  off the call: the parameters' gathers for the forward, the model
  line's partial sums and the caches' exchanges, MoE's statistics over
  the data line and the whole logits' gather, by all_sums;
- ``memory.temp_bytes_per_device``: what the step allocates at its peak
  beyond what it holds at its start, by
  `torch.distributed._tools.mem_tracker` under `FakeTensorMode`, a
  second pass (null with ``fast``, and null with the error in
  ``temp_bytes_error`` where that tool fails);
  ``held_bytes_per_device``: what a rank holds at the step's start (its
  blocks of the state, or of the parameters and caches, and the batch,
  the units' wholes being gathered inside the call, and counted there);
  the peak is the two together;
- ``model_flops``, ``useful_flops_frac`` and the roofline terms from
  `analysis.ir.roofline` with the H100's ``HW``.

The JAX package's two passes are a scanned lowering (memory) and an
unrolled one (exact costs), and ``--fast`` (or a multi-pod cell) skips
the second.  Nothing is compiled here and the layer loop is Python, so
the first pass counts every layer and microbatch exactly; the second
pass is the memory tracker's, which ``fast`` skips in the same way.
Full-attention archs skip ``long_500k``
as in the JAX package; the CLI and its ``--out`` JSON lines are the JAX
one's (``--skip-existing`` skips recorded (arch, shape, mesh) cells;
exit 1 on a failure).
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
import traceback
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis import ir
from repro_torch.configs.registry import ARCHS, batch_specs, get_config, \
    skip_shapes
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch.hlo_analysis import roofline
from repro_torch.launch.mesh import GridMesh, make_production_mesh
from repro_torch.models import model as M
from repro_torch.models.common import empty_init
from repro_torch.optim.optimizers import OptConfig, get_optimizer
from repro_torch.sharding import hints, layout, serving
from repro_torch.sharding.rules import (PartitionSpec, Sharding, batch_spec,
                                        cache_shardings, param_shardings,
                                        tree_map)
from repro_torch.train.step import TrainConfig, make_grad_fn

__all__ = ["lower_cell", "analyze", "run_cell", "main"]


def _tcfg_for(cfg) -> TrainConfig:
    # 400B MoE: AdamW's 8 bytes/param of moments cannot fit 256 chips;
    # Adafactor's factored second moment can; 16-way microbatching + bf16
    # accumulation bound the activation slab
    big = cfg.n_experts >= 64
    return TrainConfig(
        opt=OptConfig(name="adafactor" if big else "adamw"),
        microbatches=16 if big else 1,
        accum_dtype=torch.bfloat16 if big else torch.float32,
    )


def _serving_cfg(cfg):
    # serving paths always use the chunked (flash-style) attention
    return cfg.replace(attn_impl="chunked", remat=False)


def lower_cell(arch: str, shape_name: str, mesh, *, smoke: bool = False,
               device="meta"):
    """Build one cell on ``device`` (``meta``, or the CPU inside a
    `FakeTensorMode`) -> (run, args, shardings, cfg, held): ``run()``
    takes the cell's step once (rank 0's share, through `layout.mesh_step`
    or `serving.mesh_prefill` / `mesh_decode` on a shape-only mesh with
    rank 0's coordinates) and returns its outputs, ``args`` the tree of
    its arguments (rank 0's blocks of the state, or of the parameters and
    caches; `layout.whole_like` gives their whole shapes), ``shardings``
    the matching tree (a prefill cell's with its output caches'),
    ``held`` the bytes a rank holds at the step's start."""
    cfg = get_config(arch, smoke=smoke)
    shape = SHAPES[shape_name]
    dev = torch.device(device)

    def alloc(tree):
        return tree_map(lambda _, t: torch.zeros(t.shape, dtype=t.dtype,
                                                 device=dev), tree)

    def on(specs):
        return tree_map(lambda _, s: Sharding(mesh, s), specs)

    specs = alloc(batch_specs(cfg, shape.global_batch, shape.seq_len,
                              kind=shape.kind))
    bshard = on(batch_spec(cfg, mesh, kind=shape.kind,
                           batch=shape.global_batch))
    # long_500k (global batch < data axes): the KV cache is sequence-sharded
    # and decode takes the masked write (sharding/hints.py)
    data = [a for a in ("pod", "data") if a in mesh.axis_names]
    dsize = math.prod(mesh.shape[a] for a in data)
    masked = shape.kind == "decode" and shape.global_batch % dsize != 0
    hints.configure(cfg, mesh, kv_masked_write=masked)

    if shape.kind == "train":
        tcfg = _tcfg_for(cfg)
        zero = GridMesh(mesh.axis_names, tuple(mesh.shape.values()), rank=0)
        bsh = tree_map(lambda _, s: Sharding(zero, s.spec), bshard)
        model = M.Model(cfg, empty_init(dev))
        state = {"params": model, "opt": get_optimizer(tcfg.opt)[0](model),
                 "step": torch.zeros((), dtype=torch.int32, device=dev)}
        sh = layout.state_shardings(state, cfg, zero, tcfg.opt.name)
        state = layout.shard(state, sh)
        rows = layout.batch_rows(specs, bsh, tcfg.microbatches)
        step = layout.mesh_step(make_grad_fn(cfg, tcfg), tcfg.opt, sh, bsh)
        return (lambda: step(state, rows), {"state": state, "batch": specs},
                {"state": sh, "batch": bsh}, cfg,
                _bytes(state) + _bytes(rows))

    # a serving cell: rank 0's share of `serving.mesh_prefill` /
    # `mesh_decode` on the shape-only mesh, its blocks of the parameters
    # and the caches, the global batch
    scfg = _serving_cfg(cfg)
    zero = GridMesh(mesh.axis_names, tuple(mesh.shape.values()), rank=0)
    model = M.Model(scfg, empty_init(dev))
    bsh = tree_map(lambda _, s: Sharding(zero, s.spec), bshard)
    sh = {"params": param_shardings(model, scfg, zero),
          "caches": tree_map(lambda _, s: Sharding(zero, s), cache_shardings(
              M.cache_specs(scfg, shape.global_batch, shape.seq_len), scfg,
              zero))}
    model = layout.shard(model, sh["params"])
    # what a rank holds: its blocks and its rows of the global batch
    held = _bytes(model) + _bytes(layout.batch_rows(specs, bsh))
    if shape.kind == "prefill":
        args = {"params": model, "batch": specs}
        prefill = serving.mesh_prefill(sh, bsh)
        return (lambda: prefill(model, specs, shape.seq_len), args,
                {"params": sh["params"], "caches": sh["caches"],
                 "batch": bsh}, scfg, held)
    if shape.kind != "decode":
        raise ValueError(shape.kind)
    caches = layout.shard(alloc(M.cache_specs(
        scfg, shape.global_batch, shape.seq_len)), sh["caches"])
    tokens = specs.pop("tokens")
    extras = specs or None
    pos = torch.zeros((), dtype=torch.int32, device=dev)
    args = {"params": model, "tokens": tokens, "caches": caches, "pos": pos,
            "extras": extras}
    decode = serving.mesh_decode(sh, bsh)
    return (lambda: decode(model, tokens, caches, pos, extras), args,
            {"params": sh["params"], "tokens": bsh["tokens"],
             "caches": sh["caches"],
             "pos": Sharding(zero, PartitionSpec()),
             "extras": {k: bsh[k] for k in extras or {}} or None}, scfg,
            held + _bytes(caches) + _bytes(pos))


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size()
               for t in layout.flat(tree_map(lambda _, x: x, tree)).values())


def _outputs(kind, args, shardings, out) -> int:
    """One rank's bytes of the step's outputs: the state's or the caches'
    blocks, the logits and metrics whole."""
    if kind == "train":
        return (layout.resident_bytes(shardings["state"], args["state"])
                + _bytes(out[1]))
    return _bytes(out)


def _temp_bytes(arch, shape_name, mesh, smoke):
    """(peak bytes the step allocates beyond its arguments, error)."""
    try:
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.distributed._tools.mem_tracker import (MemTracker,
                                                          _MemRefType)
        with FakeTensorMode():
            run, args, _, _, _ = lower_cell(arch, shape_name, mesh,
                                            smoke=smoke, device="cpu")
            model = args["state"]["params"] if "state" in args \
                else args["params"]
            mt = MemTracker()
            mt.track_external(model)
            with mt:
                run()
            peak = mt.get_tracker_snapshot("peak")
        return sum(d["Total"] - d[_MemRefType.PARAM]
                   for d in peak.values()), None
    except Exception as e:  # noqa: BLE001 -- a tool of torch's private API
        return None, repr(e)


def analyze(arch: str, shape_name: str, mesh, *, smoke: bool = False,
            fast: bool = False):
    """One cell's record (without ``mesh`` and timing); ``fast`` skips
    the memory tracker's pass."""
    shape = SHAPES[shape_name]
    chips = mesh.size
    run, args, shardings, cfg, held = lower_cell(arch, shape_name, mesh,
                                                 smoke=smoke)
    counter = FlopCounterMode(display=False)
    with counter, ir.Recorder() as mod:
        out = run()
    # the arguments' whole shapes (rank 0 held its blocks)
    args = dict(args, **{k: layout.whole_like(args[k], shardings[k])
                         for k in ("state", "params", "caches") if k in args})
    flops = float(counter.get_total_flops())
    hbm = float(sum(i.operand_bytes + i.result_bytes
                    for i in mod.instructions))
    if shape.kind == "train":
        tcfg = _tcfg_for(cfg)
        plan = layout.step_plan(cfg, tcfg, shardings["state"],
                                shardings["batch"], args["state"]["params"],
                                rows=layout.batch_rows(
                                    args["batch"], shardings["batch"],
                                    tcfg.microbatches))
    else:
        prefill = shape.kind == "prefill"
        bsh = shardings["batch"] if prefill else dict(
            shardings["extras"] or {}, tokens=shardings["tokens"])
        glob = args["batch"] if prefill else dict(
            args["extras"] or {}, tokens=args["tokens"])
        plan = layout.serve_plan(cfg, shardings, bsh, shape.kind, glob,
                                 shape.seq_len)
    counts = {"broadcast": plan["broadcast"]}
    by_op = {"broadcast": float(plan["bytes"])}
    if plan.get("all_sum"):
        counts["all_sum"] = plan["all_sum"]
        by_op["all_sum"] = float(plan["all_sum_bytes"])
    wire = sum(by_op.values())
    n_active = M.count_params(cfg, active_only=True)
    n_tok = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                  else 1)
    model_fl = 2 * n_active * n_tok * (3 if shape.kind == "train" else 1)
    # every rank runs a share like rank 0's, its model line repeating what
    # the rules leave whole on "model"; the analytic FLOPs bound the
    # compute term from below, as in JAX
    terms = roofline(flops=max(flops * chips, float(model_fl)),
                     hbm_bytes=hbm * chips, wire_bytes_per_chip=wire,
                     chips=chips)
    arg_bytes = layout.resident_bytes(shardings, args)
    temp, err = (None, None) if fast else _temp_bytes(arch, shape_name,
                                                      mesh, smoke)
    rec = {
        "arch": cfg.name, "shape": shape.name, "kind": shape.kind,
        "chips": chips,
        "hlo_flops_global": flops * chips,
        "hlo_bytes_global": hbm * chips,
        "wire_bytes_per_chip": wire,
        "collective_counts": counts,
        "collective_bytes_by_op": by_op,
        "model_flops": model_fl,
        "useful_flops_frac": model_fl / max(flops * chips, 1.0),
        **{k: terms[k] for k in ("compute_s", "memory_s", "collective_s",
                                 "bottleneck", "step_s_lower_bound")},
        "memory": {
            "argument_bytes_per_device": arg_bytes,
            "output_bytes_per_device": _outputs(shape.kind, args, shardings,
                                                out),
            "temp_bytes_per_device": temp,
            "held_bytes_per_device": held,
            "peak_bytes_per_device": held + (temp or 0),
        },
    }
    rec["flops_per_device"], rec["hlo_bytes_per_device"] = flops, hbm
    if err is not None:
        rec["memory"]["temp_bytes_error"] = err
    hints.configure(cfg, None)
    return rec


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             smoke: bool = False, verbose: bool = True, fast: bool = False):
    """One cell on the production mesh -> its record; ``fast`` skips the
    memory tracker's pass (``temp_bytes_per_device`` null)."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    t0 = time.time()
    rec = analyze(arch, shape_name, mesh, smoke=smoke, fast=fast)
    rec["trace_s"] = round(time.time() - t0, 1)
    rec["mesh"] = "2x16x16" if multi_pod else "16x16"
    if verbose:
        m = rec["memory"]
        temp = m["temp_bytes_per_device"]
        print(f"[{rec['mesh']}] {arch} x {shape_name}: "
              f"args={m['argument_bytes_per_device'] / 2**30:.2f}GiB "
              f"temp={'n/a' if temp is None else f'{temp / 2**30:.2f}GiB'} "
              f"flops/dev={rec['hlo_flops_global'] / rec['chips']:.3e} "
              f"wire/dev={rec['wire_bytes_per_chip']:.3e}B "
              f"bottleneck={rec['bottleneck']} ({rec['trace_s']}s)",
              flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description="multi-pod dry-run")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--smoke", action="store_true",
                    help="use reduced configs (CI sanity)")
    ap.add_argument("--fast", action="store_true",
                    help="skip the memory tracker's pass (temp bytes)")
    ap.add_argument("--out", default="dryrun_results.jsonl")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = ARCHS if args.arch == "all" else [args.arch]
    shape_names = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    out_path = Path(args.out)
    done = set()
    if args.skip_existing and out_path.exists():
        for line in out_path.read_text().splitlines():
            try:
                r = json.loads(line)
                done.add((r["arch"], r["shape"], r["mesh"]))
            except (ValueError, KeyError, TypeError):
                pass

    failures = []
    with out_path.open("a") as f:
        for arch in archs:
            skips = skip_shapes(arch)
            for shape_name in shape_names:
                for multi_pod in meshes:
                    mesh_name = "2x16x16" if multi_pod else "16x16"
                    cfg_name = get_config(arch).name
                    if (cfg_name, shape_name, mesh_name) in done:
                        continue
                    if shape_name in skips:
                        rec = {"arch": cfg_name, "shape": shape_name,
                               "mesh": mesh_name, "skipped": True,
                               "reason": "full-attention arch: long_500k "
                                         "needs sub-quadratic attention"}
                        print(f"[{mesh_name}] {arch} x {shape_name}: SKIP")
                        f.write(json.dumps(rec) + "\n")
                        f.flush()
                        continue
                    try:
                        rec = run_cell(arch, shape_name, multi_pod=multi_pod,
                                       smoke=args.smoke,
                                       fast=(multi_pod or args.fast))
                        f.write(json.dumps(rec) + "\n")
                        f.flush()
                    except Exception as e:  # noqa: BLE001 -- report, go on
                        failures.append((arch, shape_name, mesh_name,
                                         repr(e)))
                        traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for fll in failures:
            print("  ", *fll[:3], fll[3][:200])
        sys.exit(1)
    print("\nALL CELLS PASSED")


if __name__ == "__main__":
    main()
