"""The port's mesh step with the model split (`sharding.tensor`: tensor and
expert parallel on the "model" axis) against one rank's step, on a 1x2
grid (model only) and a 2x2 grid of gloo ranks on the CPU, for every
arch's smoke config (f32 activations, AdamW, the logdet aux, batch 4 x
16, the state from one seed): gemma3's whole kv head under split q
heads, the MoE archs' split experts (llama4 every second layer), whisper
(its encoder, and its cross-attention on the encoder's output; its smoke
vocab of 256 splits, and one case at an odd vocab that stays whole),
qwen2-moe at 3 experts, which do not divide the model line (their mlp
columns split instead),
llama-3.2-vision's cross-attention on image embeddings, zamba2's and
mamba2's SSM blocks (each rank its 4 of the 8 SSM heads: ``out_proj``
row-parallel, the other SSM leaves gathered whole and their gradients
summed over the model line, the gated norm's sum of squares summed over
it) with zamba2's shared attention block.  llama4's smoke
parameters are bf16; here they are f32, as bf16 rounds each rank's
partial weight gradient far above the gradient gate.

Held: the reduced gradient before the clip (each rank's blocks, gathered
whole after the step) within GRAD_TOL of the largest element of one
rank's, the metrics within METRIC_RTOL, the gathered gradient the same
bits on every rank, the step's collectives equal to `layout.step_plan`,
and every rank of a model line computing its own share of the heads (kv
heads where they divide), mlp columns, experts and vocab rows, or the
whole where they do not divide.

Each of four faults planted in the model split
(`test_torch_ranks.mutated_split_step`) fails the gates: a partial
gradient of a whole k / v projection summed not at all or twice over the
model line, a column-parallel input's gradient not summed over it, and
the cross-entropy's log-sum-exp taken per rank."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.registry import ARCHS
from repro_torch.core.mesh import run_ranks

from test_torch_ranks import mutated_split_step, split_step

GRAD_TOL = {"ssm": 1e-4, "hybrid": 1e-4, "default": 1e-5}
METRIC_RTOL = {"grad_norm": 1e-4, "default": 1e-5}
GRIDS = {"1x2": 2, "2x2": 4}
BATCH, SEQ = 4, 16
ODD_VOCAB = 257
ODD_EXPERTS = 3
MUTATIONS = ["partial_unsummed", "partial_twice", "to_model_unsummed",
             "lse_per_rank"]


def _cfg(name):
    arch, over = _CASES[name]
    return get_config(arch, smoke=True).replace(**{
        k: v for k, v in over.items()
        if k in ("vocab", "param_dtype", "n_experts")})


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)
    out = {"tokens": tok, "targets": np.roll(tok, -1, axis=1)}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (BATCH, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["img_embeds"] = rng.standard_normal(
            (BATCH, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    return out


_CASES = {a: (a, {}) for a in ARCHS}
_CASES["llama4-maverick-400b-a17b"] = ("llama4-maverick-400b-a17b",
                                       {"param_dtype": torch.float32})
_CASES["whisper-tiny-odd-vocab"] = ("whisper-tiny", {"vocab": ODD_VOCAB})
# experts that do not divide the model line: the rules split their mlp
# dim instead, and every rank runs every expert on its mlp columns
_CASES["qwen2-moe-a2.7b-odd-experts"] = ("qwen2-moe-a2.7b",
                                         {"n_experts": ODD_EXPERTS})


def _made(names):
    return {n: (_CASES[n][0], 0, _batch(_cfg(n)),
                {"optimizer": "adamw", "logdet_reg": 0.05,
                 **_CASES[n][1]}) for n in names}


def _one(cases):
    threads = torch.get_num_threads()
    try:
        return split_step(None, "1x1", cases)
    finally:
        torch.set_num_threads(threads)


def gate_failures(one, ranks, family) -> list:
    """What of the gates against one rank ``ranks`` fail."""
    out = []
    want = one["grads"]
    gmax = max(float(np.abs(v).max()) for v in want.values())
    tol = GRAD_TOL.get(family, GRAD_TOL["default"]) * gmax
    for k, g in ranks[0]["grads"].items():
        err = float(np.abs(g - want[k]).max())
        if not err <= tol:
            out.append(f"gradient {k} off by {err} (gate {tol})")
    for r in ranks:
        for k, v in one["metrics"].items():
            rtol = METRIC_RTOL.get(k, METRIC_RTOL["default"])
            if not abs(r["metrics"][k] - v) <= rtol * abs(v):
                out.append(f"{r['coords']} {k} {r['metrics'][k]} vs {v}")
    return out


@pytest.fixture(scope="module")
def runs():
    cases = _made(list(_CASES))
    return {"one": _one(cases),
            "grids": {g: run_ranks(split_step, n, backend="gloo",
                                   device="cpu", timeout=600,
                                   args=(g, cases))
                      for g, n in GRIDS.items()}}


PARAMS = [(g, n) for g in GRIDS for n in _CASES]


@pytest.mark.parametrize("grid,name", PARAMS)
def test_model_split_step_is_one_ranks(runs, grid, name):
    ranks = [r[name] for r in runs["grids"][grid]]
    assert gate_failures(runs["one"][name], ranks, _cfg(name).family) == []
    for r in ranks:
        assert r["digests"] == ranks[0]["digests"], r["coords"]
        plan = r["plan"]
        assert r["counts"] == {"broadcast": plan["broadcast"],
                               "all_sum": plan["all_sum"]}, (name, plan)


@pytest.mark.parametrize("grid,name", PARAMS)
def test_each_rank_of_a_model_line_computes_its_share(runs, grid, name):
    cfg = _cfg(name)
    kinds = {"vocab"}
    if cfg.n_heads:
        kinds |= {"heads", "kv_heads", "mlp"}
    if cfg.n_experts:
        kinds.add("experts")
    if cfg.family == "ssm":
        kinds = {"vocab"}
    if cfg.ssm_state:
        kinds.add("ssm_heads")
    for r in (x[name] for x in runs["grids"][grid]):
        m = r["coords"]["model"]
        assert set(r["shares"]) == kinds, (name, r["shares"])
        for kind, seen in r["shares"].items():
            for n, whole, first in seen:
                if whole % 2:
                    assert (n, first) == (whole, None), (name, kind)
                else:
                    assert (n, first) == (whole // 2, m * whole // 2), (
                        name, kind, r["coords"])
    if name == "whisper-tiny-odd-vocab":
        assert r["shares"]["vocab"] == [(ODD_VOCAB, ODD_VOCAB, None)]
    if name == "qwen2-moe-a2.7b-odd-experts":
        f = cfg.d_ff_expert
        assert r["shares"]["experts"] == [(ODD_EXPERTS, ODD_EXPERTS, None)]
        assert (f // 2, f, m * f // 2) in r["shares"]["mlp"]


@pytest.mark.parametrize("mutation", MUTATIONS)
def test_a_fault_in_the_model_split_fails_the_gates(runs, mutation):
    cases = _made(["gemma3-1b"])
    ranks = run_ranks(mutated_split_step, 2, backend="gloo", device="cpu",
                      timeout=600, args=("1x2", cases, mutation))
    assert gate_failures(runs["one"]["gemma3-1b"],
                         [r["gemma3-1b"] for r in ranks], "dense") != []


def test_vocab_parallel_lookup_and_unembedding_tile_the_whole():
    """In a shape-only model split of two (nothing exchanged), each rank's
    lookup holds the rows of the ids in its vocab block and zeros
    elsewhere, so the two ranks' lookups add up to the whole lookup
    (`tensor.from_model` sums them on a line), and their unembeddings are
    the whole logits' column blocks; a block that does not tile the dim
    raises."""
    from repro_torch.models.common import embed_lookup, unembed
    from repro_torch.sharding import tensor
    g = torch.Generator().manual_seed(0)
    table = torch.randn(10, 4, generator=g)
    ids = torch.tensor([[0, 4, 5, 9], [7, 2, 5, 5]])
    x = torch.randn(2, 4, 4, generator=g)
    rows, logits = [], []
    for r in range(2):
        with tensor.model_split(size=2, rank=r):
            block = table[5 * r:5 * (r + 1)]
            rows.append(embed_lookup(block, ids, torch.float32, vocab=10))
            logits.append(unembed(block, x, softcap=3.0, vocab=10))
            with pytest.raises(ValueError):
                tensor.share(3, 10, "vocab")
    assert torch.equal(rows[0] + rows[1], table[ids])
    assert torch.equal(torch.cat(logits, -1), unembed(table, x, softcap=3.0))
    assert tensor.share(10, 10, "vocab") is None
