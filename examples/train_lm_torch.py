"""Train a ~100M-parameter LM for a few hundred steps on the PyTorch /
CUDA port -- twin of ``examples/train_lm.py``.

    PYTHONPATH=src python3 examples/train_lm_torch.py --steps 300
    PYTHONPATH=src python3 examples/train_lm_torch.py --device cpu --steps 20

The full launcher path: config -> state laid out by the sharding rules
-> fault-tolerant loop (async checkpoints, straggler monitor) -> loss
curve (`repro_torch.launch.train`).  The default is a 100M-parameter
dense config at short sequence length; ``--arch`` selects any of the ten
registered architectures (smoke-sized).  ``--logdet-reg`` turns on the
paper's technique as a training feature (the decorrelation aux loss
through the condensation core: K1 on the card).  It runs on the card
unless ``--device cpu`` is given.
"""
import argparse
import sys

from repro_torch.launch import train as T


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--arch", default="lm100m")
    ap.add_argument("--logdet-reg", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="None (the card) or cpu")
    args = ap.parse_args()

    if args.arch == "lm100m":
        # ~100M dense transformer (GPT-2-small-ish), trained for real
        import repro_torch.configs.qwen2_5_3b as q
        from repro_torch.configs import registry

        def lm100m():
            return q.full().replace(
                name="lm100m", n_layers=12, d_model=768, n_heads=12,
                n_kv_heads=12, head_dim=64, d_ff=2048, vocab=32768,
                qkv_bias=False)
        registry._MODULES = dict(registry._MODULES)
        mod = type(sys)("lm100m_cfg")
        mod.full = lm100m
        mod.smoke = lm100m
        mod.SKIP_SHAPES = set()
        sys.modules["repro_torch.configs._lm100m"] = mod
        registry._MODULES["lm100m"] = "repro_torch.configs._lm100m"
        registry.ARCHS = tuple(registry._MODULES)

    argv = ["--arch", args.arch, "--steps", str(args.steps),
            "--batch", str(args.batch), "--seq", str(args.seq),
            "--log-every", "10"]
    if args.arch == "lm100m":
        argv.append("--full")          # lm100m's full() IS the 100M config
    if args.logdet_reg:
        argv += ["--logdet-reg", str(args.logdet_reg)]
    if args.device:
        argv += ["--device", args.device]
    T.main(argv)


if __name__ == "__main__":
    main()
