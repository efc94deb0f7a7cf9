"""Serving launcher -- counterpart of `repro.launch.serve`: batched
prefill + decode loop.

``python -m repro_torch.launch.serve --arch <id> --batch 4 --prompt-len 32
--gen 16 [--device cpu]``

Runs a token-generation loop on the smoke configs (greedy, or sampling
at ``--temperature``), through the same `repro_torch.models` prefill and
decode steps the dry run (`launch.dryrun`) records at production shapes,
on the card unless ``--device cpu``.  Sampling draws from an explicit
`torch.Generator` (the JAX package splits a key).

``--metrics-port N`` exposes the `repro_torch.obs` metrics registry over
HTTP (``GET /metrics``, Prometheus text) for the run; the
``serve.requests`` / ``serve.tokens`` counters and the
``serve.tok_per_s`` gauge are recorded when ``REPRO_OBS`` is
``metrics`` or ``trace``.  ``--metrics-hold S`` keeps the endpoint up S
seconds after generation so a scraper can collect.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.estimators.operators.base import resolve_device
from repro_torch.models import model as M

__all__ = ["generate", "main"]


@torch.no_grad()
def generate(model, prompt, *, max_len: int, gen: int, temperature=0.0,
             extras=None, generator=None):
    """prompt (B, T0) -> tokens (B, T0+gen); greedy if temperature == 0,
    else sampled from softmax(logits / temperature) with ``generator``
    (default: seed 0 on the prompt's device)."""
    batch = dict(extras or {})
    batch["tokens"] = prompt
    t0 = prompt.shape[1]
    logits, caches = M.prefill(model, batch, max_len)
    if temperature > 0 and generator is None:
        generator = torch.Generator(device=prompt.device).manual_seed(0)

    def pick(lg):
        if temperature > 0:
            probs = torch.softmax(lg.float() / temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=generator)
        return torch.argmax(lg, dim=-1, keepdim=True)

    tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True).to(prompt.dtype)
    out = [prompt, tok]
    for pos in range(t0, t0 + gen - 1):
        lg, caches = M.decode_step(model, tok, caches, pos,
                                   batch_extras=extras)
        tok = pick(lg[:, -1]).to(prompt.dtype)
        out.append(tok)
    return torch.cat(out, dim=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b", choices=list(ARCHS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (default)")
    obs.add_metrics_cli(ap)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    server = obs.start_metrics_from_args(args)
    try:
        cfg = get_config(args.arch, smoke=True).replace(remat=False)
        rng = np.random.default_rng(0)
        model = M.init_model(cfg, generator=torch.Generator(
            device=dev).manual_seed(0), device=dev)
        prompt = torch.from_numpy(rng.integers(
            0, cfg.vocab, (args.batch, args.prompt_len)).astype(np.int32)
        ).to(dev)

        def normal(*shape):
            return torch.from_numpy(rng.standard_normal(shape)).to(
                device=dev, dtype=cfg.dtype)
        extras = None
        if cfg.family == "encdec":
            with torch.no_grad():
                extras = {"memory": M._encode(model, {"frames": normal(
                    args.batch, cfg.enc_seq, cfg.d_model)})}
        elif cfg.family == "vlm":
            extras = {"img_embeds": normal(args.batch, cfg.n_img_tokens,
                                           cfg.d_model)}

        max_len = args.prompt_len + args.gen
        t0 = time.time()
        with obs.span("serve.generate", arch=args.arch, batch=args.batch,
                      gen=args.gen):
            toks = generate(model, prompt, max_len=max_len, gen=args.gen,
                            temperature=args.temperature, extras=extras)
            if toks.is_cuda:
                torch.cuda.synchronize(toks.device)
        dt = time.time() - t0
        obs.inc("serve.requests", arch=args.arch)
        obs.inc("serve.tokens", args.batch * args.gen, arch=args.arch)
        obs.set_gauge("serve.tok_per_s", args.batch * args.gen / dt,
                      arch=args.arch)
        print(f"{args.arch}: generated {args.batch}x{args.gen} tokens "
              f"in {dt:.2f}s ({args.batch * args.gen / dt:.1f} tok/s incl. "
              "the first call's warm-up)")
        print("sample:", toks[0, args.prompt_len:].cpu().numpy())
        if server is not None and args.metrics_hold > 0:
            time.sleep(args.metrics_hold)
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
    return toks


if __name__ == "__main__":
    main()
