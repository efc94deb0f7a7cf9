#!/usr/bin/env python3
"""Phase 13 of ``chip_smoke.py`` alone on one card, and the host work of
a model step.

    python3 tools/models_probe.py [--repeat 2] [--seed 0]

Builds the kernels, runs ``chip_smoke.models_phase`` (its checks and its
``[models]`` lines), then gemma3-1b's full-depth bf16 run (phase 13(b))
``--repeat`` more times, since its rates move between calls, and last
records one full-depth prefill and one decode step with
``repro_torch.analysis.record``: their ATen ops, per layer, and host
reads (``[models_ops]``).  About two minutes on an H100.  Needs a CUDA
device and exits 2 without one; it never falls back to the CPU.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def count_ops(seed: int) -> dict:
    """ATen ops and host reads of one prefill (2 x 16 tokens) and one
    decode step of gemma3-1b at full depth with bf16 activations."""
    import torch
    from repro_torch.analysis import record
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_model, prefill

    cfg = get_config("gemma3-1b")
    model = init_model(cfg, generator=torch.Generator(device="cuda")
                       .manual_seed(seed), device="cuda")
    tokens = torch.randint(0, cfg.vocab, (2, 16), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(seed))
    tokens = tokens.to("cuda")
    out = {"arch": cfg.name, "layers": cfg.n_layers}
    with torch.no_grad():
        _, caches = prefill(model, {"tokens": tokens}, 64)     # warm-up
        for name, fn in (
                ("prefill", lambda: prefill(model, {"tokens": tokens}, 64)),
                ("decode", lambda: decode_step(model, tokens[:, :1], caches,
                                               16))):
            mod = record(fn)
            ops = sum(i.opcode.startswith("aten.") for i in mod.instructions)
            reads = sum(i.opcode.startswith("host.")
                        for i in mod.instructions)
            out[name] = {"aten_ops": ops, "per_layer": ops / cfg.n_layers,
                         "host_reads": reads}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeat", type=int, default=2,
                    help="extra runs of gemma3-1b's full-depth part")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--k", type=int, default=32, help="panel width of (c)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: models_probe.py measures the card",
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
    cs.models_phase(args.seed, args.k, smi)
    for _ in range(args.repeat):
        cs.say("models", part="gemma3-1b full", **cs.gemma_full(args.seed,
                                                                  smi))
        torch.cuda.empty_cache()
    cs.say("models_ops", card=smi, **count_ops(args.seed))
    return 0


if __name__ == "__main__":
    sys.exit(main())
