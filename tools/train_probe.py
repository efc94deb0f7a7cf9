#!/usr/bin/env python3
"""Phase 14 of ``chip_smoke.py`` alone on one card, and the host work of
a train step.

    python3 tools/train_probe.py [--repeat 2] [--seed 0] [--only-full]

Builds the kernels, runs ``chip_smoke.train_phase`` (its checks and its
``[train]`` lines; ``--only-full`` skips it), then gemma3-1b's
full-depth bf16 step (phase 14(c)) ``--repeat`` more times, since host
rates move between calls, and last records the parts of one full-depth
step with ``repro_torch.analysis.record`` (``[train_ops]``): one
microbatch's loss forward, its backward, the logdet aux alone (forward
+ backward on the pooled (2, d_model) embeddings), the clip and the
optimizer, the whole step, and the driver's copy of the metrics: ATen
ops, per layer, K1 records and the host's reads of the card (a
Python-level read or a copy to the host).  A few minutes on an H100.
Needs a CUDA device and exits 2 without one; it never falls back to the
CPU.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def count_ops(seed: int) -> dict:
    """The recorded parts of one gemma3-1b full-depth train step (bf16
    activations, adamw, the logdet aux, 2 microbatches of 2 x 512)."""
    import torch
    import chip_smoke as cs
    from repro_torch.analysis import record
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, synth_batch
    from repro_torch.ft.driver import _to_host
    from repro_torch.models.common import embed_lookup
    from repro_torch.optim import OptConfig, clip_by_global_norm, get_optimizer
    from repro_torch.train import (TrainConfig, init_train_state, make_grad_fn,
                                   make_loss_fn, make_train_step)
    from repro_torch.train.loss import logdet_decorrelation

    cfg = get_config("gemma3-1b")
    tcfg = TrainConfig(opt=OptConfig(name="adamw"),
                       logdet_reg=cs.TRAIN_LOGDET,
                       microbatches=cs.GEMMA_STEP_MICRO)
    state = init_train_state(cfg, tcfg, generator=torch.Generator(
        device="cuda").manual_seed(seed), device="cuda")
    b, t = cs.GEMMA_STEP_SHAPE
    batch = synth_batch(cfg, DataConfig(seed=seed, batch=b, seq=t), 0)
    micro = {k: v[:b // cs.GEMMA_STEP_MICRO] for k, v in batch.items()}
    model = state["params"]
    params = [p for _, p in model.named_parameters()]
    step = make_train_step(cfg, tcfg)
    step(state, batch)                                   # warm-up
    loss_fn = make_loss_fn(cfg, tcfg)
    held = {}

    def forward():
        held["loss"] = loss_fn(model, micro)[0]

    def backward():
        torch.autograd.grad(held.pop("loss"), params, allow_unused=True)

    with torch.no_grad():
        pooled = embed_lookup(model.embed, micro["tokens"],
                              cfg.dtype).mean(dim=1)

    def aux():
        h = pooled.detach().requires_grad_()
        logdet_decorrelation(h).backward()

    grads, _ = make_grad_fn(cfg, tcfg)(model, batch)
    _, opt_update = get_optimizer(tcfg.opt)

    def update():
        g, _ = clip_by_global_norm(grads, tcfg.opt.clip_norm)
        opt_update(g, state["opt"], model)

    metrics = {}

    def whole():
        metrics.update(step(state, batch)[1])

    out = {"arch": cfg.name, "layers": cfg.n_layers,
           "microbatches": cs.GEMMA_STEP_MICRO, "shape": [b, t]}
    for name, fn in (("forward", forward), ("backward", backward),
                     ("aux", aux), ("clip+optimizer", update),
                     ("step", whole), ("metrics_copy",
                                       lambda: _to_host(metrics))):
        torch.cuda.synchronize()
        mod = record(fn)
        ops = sum(i.opcode.startswith("aten.") for i in mod.instructions)
        # reads of the card by the host: Python-level reads and copies
        reads = [i.site or i.opcode for i in mod.instructions
                 if i.device == "cuda" and i.result_device == "cpu"]
        k1 = sum(i.opcode == "kernel.rank1_update" for i in mod.instructions)
        out[name] = {"aten_ops": ops, "per_layer": ops / cfg.n_layers,
                     "k1_records": k1, "host_reads": len(reads),
                     "host_read_sites": sorted(set(reads))}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeat", type=int, default=2,
                    help="extra runs of gemma3-1b's full-depth step")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only-full", action="store_true",
                    help="skip phase 14's checks: (c) and the op count")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: train_probe.py measures the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    _build.build()
    if not args.only_full:
        cs.train_phase(args.seed, smi)
    for _ in range(args.repeat):
        full, _ = cs.gemma_train_full(args.seed, smi)
        cs.say("train", part="gemma3-1b full", **full)
        torch.cuda.empty_cache()
    cs.say("train_ops", card=smi, **count_ops(args.seed))
    return 0


if __name__ == "__main__":
    sys.exit(main())
