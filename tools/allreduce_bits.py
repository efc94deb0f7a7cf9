"""Does one all_sum give every rank the same bits?

`repro_torch.sharding.fsdp.reduce` sums each rank's partial gradient
by one `core.mesh.all_sum` and every rank then keeps and updates its
blocks of its own copy of the sum, so the split step needs every rank
to hold bitwise the same result.  This script checks it for a backend:
each of ``--ranks`` ranks fills tensors of several sizes and dtypes with
its own random values (magnitudes spread over six decades, so that the
order of the additions shows in the last bits), all_sums them, and
reports, per tensor, whether the sha256 of the result is the same on
every rank, and whether it equals the sum taken in rank order.

    python3 tools/allreduce_bits.py                       # gloo, CPU, 4
    python3 tools/allreduce_bits.py --device cuda         # gloo, one card
    python3 tools/allreduce_bits.py --backend nccl --device cuda --ranks 4

NCCL takes one card a rank.  Prints one JSON line (with the card's name
and power limit on a card) and exits 1 if any result differs between
ranks.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.core import mesh as M  # noqa: E402

CASES = [(1, "float32"), (3, "float32"), (1000, "float32"),
         (65537, "float32"), ((1 << 22) + 5, "float32"),
         (1000, "bfloat16"), ((1 << 20) + 3, "bfloat16")]


def _values(rank: int, case: int, numel: int, dtype) -> torch.Tensor:
    rng = np.random.default_rng([rank, case])
    x = rng.standard_normal(numel) * 10.0 ** rng.uniform(-3, 3, numel)
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


def rank_fn(mesh) -> list:
    """One rank: for each case the sha256 of its all_sum, and of the sum
    of every rank's values in rank order."""
    out = []
    for i, (numel, name) in enumerate(CASES):
        dtype = getattr(torch, name)
        mine = _values(mesh.rank, i, numel, dtype)
        got = M.all_sum(mesh, mine.to(mesh.device)).cpu()
        order = _values(0, i, numel, dtype)
        for r in range(1, mesh.size):
            order = order + _values(r, i, numel, dtype)
        out.append({"numel": numel, "dtype": name,
                    "sha256": hashlib.sha256(
                        got.view(torch.uint8).numpy().data).hexdigest(),
                    "is_rank_order_sum": bool(torch.equal(got, order))})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="gloo", choices=["gloo", "nccl"])
    ap.add_argument("--device", default="cpu", choices=["cpu", "cuda"])
    ap.add_argument("--ranks", type=int, default=4)
    args = ap.parse_args(argv)
    ranks = M.run_ranks(rank_fn, args.ranks, backend=args.backend,
                        device=args.device, timeout=600)
    cases = []
    for i, (numel, name) in enumerate(CASES):
        digests = {r[i]["sha256"] for r in ranks}
        cases.append({"numel": numel, "dtype": name,
                      "same_on_every_rank": len(digests) == 1,
                      "is_rank_order_sum": [r[i]["is_rank_order_sum"]
                                            for r in ranks]})
    card = None
    if args.device == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().splitlines()
    same = all(c["same_on_every_rank"] for c in cases)
    print(json.dumps({"backend": args.backend, "device": args.device,
                      "ranks": args.ranks, "same_on_every_rank": same,
                      "cases": cases, "card": card}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
