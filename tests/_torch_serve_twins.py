"""Shared by tests/test_torch_serve_split_jax*.py: the port's prefill and
decode on a grid of gloo ranks (`repro_torch.sharding.serving`, rank
function `test_torch_ranks.serve_split`) against the JAX package's
jitted ``M.prefill`` / ``M.decode_step`` on a fake-device mesh of the
same shape (``XLA_FLAGS=--xla_force_host_platform_device_count=4``, in a
subprocess: `_subproc.run_with_devices`), laid out as the JAX dry run
lays a serving cell out (`repro.launch.dryrun.lower_cell`: the
parameters by ``param_shardings``, the caches by ``cache_shardings`` in
and out, the batch by ``batch_spec``, ``kv_masked_write`` where the
batch does not divide the data axes, chunked attention and no remat),
from the same JAX parameters carried across (`models.convert`).

`check` holds, for one case on one grid: the prefill's and each decode
step's whole logits within ``tol`` of max(1, |JAX's|) on every rank, and
the same bits on every rank; every rank's cache blocks shaped as the
JAX rules' ``cache_shardings`` cut them, the ranks that hold one block
the same bits, and the blocks, put together, within ``tol`` of max(1,
|JAX's caches|) after the prefill and after the last step; each call's
collectives (`core.mesh.tallying`) equal to `layout.serve_plan`."""
from __future__ import annotations

import pickle

import jax
import numpy as np

from repro.models import model as JM
from repro.sharding import rules as JR

from repro_torch.core.mesh import run_ranks
from repro_torch.launch.mesh import GridMesh
from repro_torch.sharding import layout
from repro_torch.sharding.rules import Sharding

from _subproc import run_with_devices
from _torch_train_twins import jax_params
from test_torch_ranks import serve_split

PROMPT, STEPS, MAX_LEN = 16, 3, 20

JAX_CODE = """
import pickle
import numpy as np
jax.config.update("jax_enable_x64", False)
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs.registry import get_config
from repro.models import model as M
from repro.sharding import hints
from repro.sharding.rules import batch_spec, cache_shardings, param_shardings

with open({path!r}, "rb") as f:
    runs = pickle.load(f)
out = {{}}
for (grid, name), (dims, arch, params, prompt, fed, max_len) in runs.items():
    mesh = Mesh(np.asarray(jax.devices()[:dims[0] * dims[1]]).reshape(dims),
                ("data", "model"))
    cfg = get_config(arch, smoke=True).replace(
        dtype=jnp.float32, attn_impl="chunked", remat=False)
    b = prompt.shape[0]
    hints.configure(cfg, mesh, kv_masked_write=b % dims[0] != 0)
    pshard = param_shardings(params, cfg, mesh)
    cshard = jax.tree.map(lambda s: NamedSharding(mesh, s), cache_shardings(
        M.cache_specs(cfg, b, max_len), cfg, mesh),
        is_leaf=lambda x: isinstance(x, P))
    bsh = {{kind: {{k: NamedSharding(mesh, s) for k, s in batch_spec(
        cfg, mesh, kind=kind, batch=b).items()}}
        for kind in ("prefill", "decode")}}
    prefill = jax.jit(lambda p, x: M.prefill(p, x, cfg, max_len),
                      in_shardings=(pshard, bsh["prefill"]),
                      out_shardings=(None, cshard))
    decode = jax.jit(lambda p, t, c, pos: M.decode_step(p, t, c, pos, cfg),
                     in_shardings=(pshard, bsh["decode"]["tokens"], cshard,
                                   NamedSharding(mesh, P())),
                     out_shardings=(None, cshard), donate_argnums=(2,))
    with mesh:
        ps = jax.device_put(params, pshard)
        logits, caches = prefill(ps, {{"tokens": jnp.asarray(prompt)}})
        got = [np.asarray(logits)]
        first = jax.device_get(caches)
        for i in range(fed.shape[1]):
            logits, caches = decode(ps, jnp.asarray(fed[:, i:i + 1]), caches,
                                    jnp.int32(prompt.shape[1] + i))
            got.append(np.asarray(logits))
    out[grid, name] = {{"logits": got, "prefill_caches": first,
                       "caches": jax.device_get(caches)}}
    hints.configure(cfg, None)
with open({path!r} + ".out", "wb") as f:
    pickle.dump(out, f)
"""


def case(arch: str, batch: int, seed: int = 0):
    """(arch, the JAX smoke parameters (numpy), a seeded prompt (batch,
    PROMPT) and the tokens of STEPS decode steps, int32, MAX_LEN)."""
    jcfg, _, params = jax_params(arch)
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, jcfg.vocab, (batch, PROMPT)).astype(np.int32)
    fed = rng.integers(0, jcfg.vocab, (batch, STEPS)).astype(np.int32)
    return arch, jax.device_get(params), prompt, fed, MAX_LEN


def run(tmp_path, grids: dict, cases: dict, runs) -> dict:
    """JAX's outputs and the port's ranks' for each (grid, case name) of
    ``runs``; ``grids`` maps a grid to its (data, model) dims."""
    path = str(tmp_path / "cases.pkl")
    with open(path, "wb") as f:
        pickle.dump({(g, n): (grids[g],) + cases[n] for g, n in runs}, f)
    run_with_devices(JAX_CODE.format(path=path), 4, timeout=900)
    with open(path + ".out", "rb") as f:
        jax_out = pickle.load(f)
    ranks = {}
    for g, dims in grids.items():
        names = [n for gg, n in runs if gg == g]
        if names:
            ranks[g] = run_ranks(serve_split, dims[0] * dims[1],
                                 backend="gloo", device="cpu", timeout=600,
                                 args=(g, {n: cases[n] for n in names}))
    return {"jax": jax_out, "ranks": ranks, "cases": cases, "grids": grids}


def _jax_flat(tree) -> dict:
    """A JAX tree of `PartitionSpec`s as {path: spec}, paths as
    `layout.flat` names them (dict keys, sequence indices as strings)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, JR.P))[0]:
        out[tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                  for k in path)] = leaf
    return out


def _scale(a) -> float:
    return max(1.0, float(np.abs(a).max()))


def check(runs: dict, grid: str, name: str, tol: float) -> dict:
    """The gates of the module docstring for one case on one grid ->
    {"logit_err", "cache_err", "blocks_split", "blocks_shared"}."""
    from repro.configs.registry import get_config as jax_config
    want = runs["jax"][grid, name]
    ranks = [r[name] for r in runs["ranks"][grid]]
    arch, _, prompt, _, max_len = runs["cases"][name]
    logit_err = 0.0
    for r in ranks:
        assert len(r["logits"]) == len(want["logits"])
        for got, w in zip(r["logits"], want["logits"]):
            assert got.shape == w.shape, (grid, name, got.shape, w.shape)
            logit_err = max(logit_err, float(np.abs(got - w).max())
                            / _scale(w))
        for got, lead in zip(r["logits"], ranks[0]["logits"]):
            assert got.tobytes() == lead.tobytes(), (grid, name, r["coords"])
        assert r["tallies"][0] == r["plans"]["prefill"], (grid, name)
        assert all(t == r["plans"]["decode"] for t in r["tallies"][1:]), (
            grid, name, r["tallies"], r["plans"]["decode"])
        assert r["plans"]["decode"]["all_sum"] > 0
    assert logit_err <= tol, (grid, name, logit_err)
    jcfg = jax_config(arch, smoke=True)
    fm = GridMesh(("data", "model"), runs["grids"][grid])
    specs = _jax_flat(JR.cache_shardings(
        JM.cache_specs(jcfg, prompt.shape[0], max_len), jcfg, fm))
    cache_err, split, shared = 0.0, 0, 0
    for which in ("prefill_caches", "caches"):
        whole = layout.flat(want[which])
        assert set(".".join(p) for p in whole) == set(ranks[0][which])
        for path, w in whole.items():
            w = np.asarray(w)
            sh = Sharding(fm, tuple(specs[path]))
            key = ".".join(path)
            got = np.full(w.shape, np.nan, dtype=w.dtype)
            held = {}
            for r in ranks:
                blk = r[which][key]
                assert blk.shape == layout.shard_shape(w.shape, sh), (
                    grid, name, which, key, blk.shape)
                where = layout.block_slices(w.shape, sh, r["coords"])
                got[where] = blk
                held.setdefault(str(where), set()).add(blk.tobytes())
            assert all(len(v) == 1 for v in held.values()), (grid, name, key)
            assert not np.isnan(got).any()
            cache_err = max(cache_err, float(np.abs(got - w).max())
                            / _scale(w))
            split += len(held) > 1
            shared += len(held) < len(ranks)
    assert cache_err <= tol, (grid, name, cache_err)
    return {"logit_err": logit_err, "cache_err": cache_err,
            "blocks_split": split, "blocks_shared": shared}
