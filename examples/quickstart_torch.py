"""Quickstart of the PyTorch / CUDA port: log-determinants on the card
through `repro_torch.plan`.

The first call gives no method: ``method="auto"`` prices the exact routes
and the estimators on the port's measured table
(``bench_out/torch_roofline_calibration.json``; refresh it on the card
with ``python3 tools/torch_calibrate.py``) and runs the cheaper one.  The
second asks for the exact engine by the accuracy it needs
(``rtol=1e-6``); the third and fourth run the paper's Gaussian-
elimination baseline and an estimator by name.

    PYTHONPATH=src python3 examples/quickstart_torch.py [--n 4096]
    PYTHONPATH=src python3 examples/quickstart_torch.py --device cpu --n 256

Plans run on the card unless ``--device cpu`` is given.
"""
import argparse

import numpy as np
import torch

import repro_torch


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--device", default=None,
                    help="None (the card) or cpu")
    args = ap.parse_args()
    n = args.n

    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, n))
    a = torch.from_numpy(x @ x.T / n + 2.0 * np.eye(n)).float()
    s_ref, ld_ref = (float(v) for v in torch.linalg.slogdet(a.double()))
    print(f"n = {n}; f64 slogdet: sign {s_ref:+.0f}, log|det| {ld_ref:.6f}")

    for label, kw in (("auto", {}),
                      ("auto, rtol=1e-6", {"rtol": 1e-6}),
                      ("exact, rtol=1e-6", {"method": "exact",
                                            "rtol": 1e-6}),
                      ("ge", {"method": "ge"}),
                      ("slq", {"method": "slq", "num_probes": 32})):
        p = repro_torch.plan(a, device=args.device, **kw)  # plan once ...
        res = p()                                          # ... execute
        ld = float(res.logabsdet)
        route = p.method
        if p.method == "exact":
            route += f" ({p.config.schedule} x {p.config.update}, " \
                     f"k = {p.config.k})"
        sem = f", sem {float(res.sem):.2g}" if p.method in (
            "chebyshev", "slq") else ""
        print(f"  {label:17s} -> {route:34s} sign {float(res.sign):+.0f}  "
              f"log|det| {ld:.6f}  rel err {abs(ld - ld_ref) / abs(ld_ref):.1e}"
              f"{sem}  {res.diagnostics.wall_time_s * 1e3:8.1f} ms")


if __name__ == "__main__":
    main()
