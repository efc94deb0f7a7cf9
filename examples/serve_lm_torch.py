"""Serving on the PyTorch / CUDA port: batched prefill + token-by-token
decode with sampling -- twin of ``examples/serve_lm.py``.

    PYTHONPATH=src python3 examples/serve_lm_torch.py --arch gemma3-1b --gen 24
    PYTHONPATH=src python3 examples/serve_lm_torch.py --device cpu

Every registered arch works (smoke-sized weights, randomly initialized:
the point is the serving machinery -- prefill caches, decode steps,
batched requests, enc-dec / vision extras; `repro_torch.launch.serve`).
It runs on the card unless ``--device cpu`` is given.
"""
import argparse

from repro_torch.launch import serve as S


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default=None,
                    help="None (the card) or cpu")
    args = ap.parse_args()
    argv = ["--arch", args.arch, "--batch", str(args.batch),
            "--prompt-len", str(args.prompt_len), "--gen", str(args.gen),
            "--temperature", str(args.temperature)]
    if args.device:
        argv += ["--device", args.device]
    S.main(argv)


if __name__ == "__main__":
    main()
