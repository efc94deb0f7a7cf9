"""``python -m repro_torch.serve`` -- run the logdet service, or export plans.

Counterpart of ``python -m repro.serve``, with the same subcommands and
flags plus ``--device``.  Subcommands::

    serve          start the HTTP service (default when no subcommand)
        --host/--port        bind address (port 0 picks a free port)
        --buckets 64,128,256 bucket ladder
        --max-batch/--max-wait-ms/--cache-capacity
        --method             default method ('auto' resolves per bucket)
        --device             'cpu' or a CUDA device (default: the card,
                             raising when there is none)
        --plan-dir DIR       load exported plans from DIR instead of
                             planning at warmup
        --no-warmup          skip startup warmup (first requests plan)
        --metrics-port       repro_torch.obs scrape endpoint

    export         resolve and write every plan the ladder needs
        --out DIR            artifact directory (feed back as --plan-dir)
        same ladder/batch/method/device flags as serve

On startup the serve subcommand prints exactly one ready line::

    serving on http://HOST:PORT

(after warmup, so a supervisor that waits for the line gets a service
whose plans are built and whose kernels are loaded).
"""
from __future__ import annotations

import argparse
import sys

from repro_torch import obs


def _parse_buckets(text: str):
    try:
        return tuple(int(tok) for tok in text.split(",") if tok.strip())
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"buckets must be comma-separated ints, got {text!r}")


def _add_ladder_flags(ap: argparse.ArgumentParser) -> None:
    from repro_torch.serve.bucket import DEFAULT_BUCKETS
    ap.add_argument("--buckets", type=_parse_buckets,
                    default=DEFAULT_BUCKETS, metavar="N,N,...",
                    help="bucket ladder (default "
                         + ",".join(map(str, DEFAULT_BUCKETS)) + ")")
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--method", default="auto",
                    help="default method for requests that name none")
    ap.add_argument("--dtype", default="float64",
                    choices=["float32", "float64"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="where the plans run: 'cpu', or a CUDA device "
                         "(default: the card, raising when there is none)")


def _config_from_args(args):
    from repro_torch.serve.service import ServeConfig
    return ServeConfig(
        buckets=args.buckets, max_batch=args.max_batch,
        max_wait_ms=getattr(args, "max_wait_ms", 2.0),
        cache_capacity=getattr(args, "cache_capacity", 64),
        plan_dir=getattr(args, "plan_dir", None),
        default_method=args.method, dtype=args.dtype, seed=args.seed,
        device=args.device)


def _cmd_serve(args) -> int:
    from repro_torch.serve.http import serve_http
    from repro_torch.serve.service import LogdetService

    metrics_server = obs.start_metrics_from_args(args)
    service = LogdetService(_config_from_args(args))
    if not args.no_warmup:
        dt = service.warmup()
        print(f"warmup: {len(service.plans)} plans ready in {dt:.1f}s",
              file=sys.stderr)
    server = serve_http(service, args.host, args.port)
    host, port = server.server_address[:2]
    print(f"serving on http://{host}:{port}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        service.close()
        if metrics_server is not None:
            metrics_server.shutdown()
    return 0


def _cmd_export(args) -> int:
    import os

    import repro_torch
    from repro_torch.serve.bucket import BucketLadder
    from repro_torch.serve.service import plan_filename

    cfg = _config_from_args(args)      # validates the flags, resolves device
    os.makedirs(args.out, exist_ok=True)
    ladder = BucketLadder(args.buckets)
    batches, b = [], 1
    while b < args.max_batch:
        batches.append(b)
        b *= 2
    batches.append(args.max_batch)
    for bucket in ladder.buckets:
        if args.method == "auto":
            method = repro_torch.select_method((bucket, bucket))
        else:
            method = args.method
        for batch in dict.fromkeys(batches):
            shape = ((bucket, bucket) if batch == 1
                     else (batch, bucket, bucket))
            plan = repro_torch.plan(shape, method=method,
                                    precision=args.dtype, validate=False,
                                    device=cfg.device)
            path = os.path.join(
                args.out, plan_filename(method, bucket, batch, args.dtype))
            plan.export(path)
            print(f"exported {path}")
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0].startswith("-"):
        argv = ["serve", *argv]   # bare invocation serves
    ap = argparse.ArgumentParser(prog="python -m repro_torch.serve",
                                 description=__doc__.split("\n", 1)[0])
    sub = ap.add_subparsers(dest="cmd")

    serve = sub.add_parser("serve", help="run the HTTP logdet service")
    serve.add_argument("--host", default="127.0.0.1")
    serve.add_argument("--port", type=int, default=8080,
                       help="0 picks a free port (printed on the ready line)")
    _add_ladder_flags(serve)
    serve.add_argument("--max-wait-ms", type=float, default=2.0)
    serve.add_argument("--cache-capacity", type=int, default=64)
    serve.add_argument("--plan-dir", default=None, metavar="DIR",
                       help="load exported plan artifacts from DIR")
    serve.add_argument("--no-warmup", action="store_true")
    obs.add_metrics_cli(serve)

    export = sub.add_parser(
        "export", help="export every plan the ladder needs")
    export.add_argument("--out", required=True, metavar="DIR")
    _add_ladder_flags(export)

    args = ap.parse_args(argv)
    if args.cmd == "serve":
        return _cmd_serve(args)
    return _cmd_export(args)


if __name__ == "__main__":
    sys.exit(main())
