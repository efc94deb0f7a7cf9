"""CPU twins of `repro_torch.optim` against `repro.optim`.

The JAX optimizers see a tree whose layers are stacked on leading axes;
the port sees one tensor per layer (the names `repro_torch.models.convert
.unstacked` gives).  The trees below hold a stacked ``(L, d)`` leaf (a
per-layer norm scale), a stacked ``(L, a, b)`` matrix, depth-2 ``(n,
per, d)`` and ``(n, per, a, b)`` leaves (llama4's dense blocks), and
unstacked 2-D and 1-D leaves.  Same numpy inputs, seeded; the update is
f32 arithmetic in the same order in both packages, so the tolerance is a
few f32 ulps (UPDATE_RTOL) where JAX and PyTorch round ``pow``, ``cos``
or a reduction differently.

Two cases must fail for an optimizer that works layer by layer: AdamW's
decoupled decay of a stacked ``(L, d)`` leaf under a zero gradient (JAX
decays it: its rank is 2), and Adafactor's shared ``vc`` and whole-leaf
RMS clip on a stacked ``(L, d)`` leaf whose layers' gradients differ by
six orders of magnitude.
"""
from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.optim import optimizers as J

from repro_torch.models.convert import flatten, unstacked
from repro_torch.optim import optimizers as T

# f32 arithmetic in the same order: a few ulps where the libraries round
# pow / sqrt / cos / reductions differently
UPDATE_RTOL, UPDATE_ATOL = 4e-6, 1e-12
LR_RTOL = 1e-6
STEPS = 3

L, N, PER, D, A, B = 3, 2, 2, 8, 4, 6


def tree_shapes():
    return {"blocks": {"norm": (L, D), "w": (L, A, B)},
            "dense_blocks": {"norm": (N, PER, D), "w": (N, PER, A, B)},
            "embed": (16, D), "final_norm": (D,)}


def make_tree(rng, shapes=None, dtype=np.float32, scale=1.0):
    shapes = tree_shapes() if shapes is None else shapes
    return {k: make_tree(rng, v, dtype, scale) if isinstance(v, dict)
            else (scale * rng.standard_normal(v)).astype(dtype)
            for k, v in shapes.items()}


def to_jax(tree, dtype=None):
    return jax.tree.map(lambda x: jnp.asarray(x, dtype), tree)


def to_port(tree, dtype=torch.float32):
    return {k: torch.tensor(np.asarray(v, np.float32)).to(dtype)
            for k, v in unstacked(tree).items()}


def port_view(jtree):
    """A JAX tree (stacked) as the port's per-layer names, in f64."""
    return {k: np.asarray(v, np.float64)
            for k, v in unstacked(jax.device_get(jtree)).items()}


def assert_params(port, jtree, rtol=UPDATE_RTOL, atol=UPDATE_ATOL):
    want = port_view(jtree)
    assert set(port) == set(want)
    for k, v in port.items():
        np.testing.assert_allclose(v.double().numpy(), want[k], rtol=rtol,
                                   atol=atol, err_msg=k)


def assert_state(port_state, jax_state):
    """The port's optimizer state is the JAX state leaf for leaf: the same
    nested keys, stacked shapes, f32."""
    want = flatten(jax.device_get(jax_state))
    got = flatten({k: v for k, v in port_state.items()})
    assert set(got) == set(want)
    for k in want:
        g = port_state
        for part in k.split("."):
            g = g[part]
        assert tuple(g.shape) == tuple(want[k].shape), k
        assert g.dtype == (torch.int32 if k == "count" else torch.float32), k
        np.testing.assert_allclose(g.double().numpy(),
                                   np.asarray(want[k], np.float64),
                                   rtol=UPDATE_RTOL, atol=UPDATE_ATOL,
                                   err_msg=k)


def run_both(cfg_kw, params_np, grads_np_steps, dtype=np.float32):
    """Both optimizers over the same gradients -> (port params, port state,
    JAX params, JAX state)."""
    jcfg, tcfg = J.OptConfig(**cfg_kw), T.OptConfig(**cfg_kw)
    jinit, jupd = J.get_optimizer(jcfg)
    tinit, tupd = T.get_optimizer(tcfg)
    jdt = jnp.bfloat16 if dtype == "bf16" else None
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    jp = to_jax(params_np, jdt)
    tp = to_port(params_np, tdt)
    js, ts = jinit(jp), tinit(tp)
    jupd = jax.jit(jupd)
    for g in grads_np_steps:
        jp, js = jupd(to_jax(g, jdt), js, jp)
        tp, ts = tupd(to_port(g, tdt), ts, tp)
    return tp, ts, jp, js


@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgd"])
def test_update_matches_jax_on_stacked_trees(name):
    """Three steps of each optimizer on the same stacked tree and the same
    gradients: parameters and state equal the JAX package's."""
    rng = np.random.default_rng(0)
    params = make_tree(rng)
    grads = [make_tree(rng, scale=0.1) for _ in range(STEPS)]
    tp, ts, jp, js = run_both(dict(name=name, lr=1e-2, warmup=2,
                                   decay_steps=10, weight_decay=0.1),
                              params, grads)
    assert_params(tp, jp)
    assert_state(ts, js)
    assert int(ts["count"]) == STEPS


def test_adamw_decays_stacked_norm_under_zero_gradient():
    """JAX decays a stacked (L, d) norm scale (rank 2 there): with a zero
    gradient its Adam term is 0 and it moves by lr * wd * p.  A per-layer
    optimizer would see (d,) tensors and leave it unchanged.  The
    unstacked (d,) final norm stays undecayed in both."""
    rng = np.random.default_rng(1)
    params = make_tree(rng)
    zeros = jax.tree.map(np.zeros_like, params)
    tp, _, jp, _ = run_both(dict(name="adamw", lr=1e-2, warmup=1,
                                 decay_steps=10, weight_decay=0.1),
                            params, [zeros])
    assert_params(tp, jp)
    before = to_port(params)
    for i in range(L):
        k = f"blocks.{i}.norm"
        delta = (tp[k] - before[k]).double().numpy()
        want = -1e-2 * 0.1 * before[k].double().numpy()
        np.testing.assert_allclose(delta, want, rtol=1e-4)
    for i in range(N):
        for j in range(PER):
            k = f"dense_blocks.{i}.{j}.norm"
            assert not torch.equal(tp[k], before[k]), k
    assert torch.equal(tp["final_norm"], before["final_norm"])


def test_adafactor_factors_the_stacked_leaf_as_a_whole():
    """A stacked (L, d) leaf whose layers' gradients are 1e-3, 1 and 1e3:
    JAX factors it (vr (L,), ONE vc (d,) for all layers) and clips the
    update by the RMS over the whole leaf.  The port matches; the same
    gradients applied layer by layer (each layer a (d,) leaf, as a
    per-layer optimizer would) give other numbers."""
    rng = np.random.default_rng(2)
    shapes = {"blocks": {"norm": (L, D)}}
    params = make_tree(rng, shapes)
    g = make_tree(rng, shapes)
    g["blocks"]["norm"] *= np.array([1e-3, 1.0, 1e3], np.float32)[:, None]
    kw = dict(name="adafactor", lr=1e-2, warmup=1, decay_steps=10,
              weight_decay=0.0)
    tp, ts, jp, js = run_both(kw, params, [g])
    assert_params(tp, jp)
    assert_state(ts, js)
    assert tuple(ts["f"]["blocks"]["norm"]["vc"].shape) == (D,)
    # the per-layer reading: each layer a 1-D leaf of its own
    jinit, jupd = J.get_optimizer(J.OptConfig(**kw))
    per_layer = []
    for i in range(L):
        p_i = {"norm": jnp.asarray(params["blocks"]["norm"][i])}
        new, _ = jupd({"norm": jnp.asarray(g["blocks"]["norm"][i])},
                      jinit(p_i), p_i)
        per_layer.append(np.asarray(new["norm"], np.float64))
    stacked = np.stack([tp[f"blocks.{i}.norm"].double().numpy()
                        for i in range(L)])
    p0 = params["blocks"]["norm"].astype(np.float64)
    off = np.abs((np.stack(per_layer) - p0) - (stacked - p0)).max(axis=1)
    scale = np.abs(stacked - p0).max(axis=1)
    assert (off > 0.1 * scale).all(), (off, scale)


def test_bf16_params_keep_dtype_with_f32_moments():
    """bf16 parameters stay bf16 and their update rounds as JAX's (within
    one bf16 ulp); every moment is f32 (test_adamw_moments_dtype)."""
    rng = np.random.default_rng(3)
    params = make_tree(rng)
    grads = [make_tree(rng, scale=0.1)]
    for name in ("adamw", "adafactor"):
        tp, ts, jp, _ = run_both(dict(name=name, lr=1e-1, warmup=1,
                                      decay_steps=10), params, grads,
                                 dtype="bf16")
        assert all(v.dtype == torch.bfloat16 for v in tp.values())
        want = port_view(jp)
        for k, v in tp.items():
            np.testing.assert_allclose(v.double().numpy(), want[k],
                                       rtol=2.0 ** -8, atol=0, err_msg=k)
        leaves = jax.tree.leaves({k: v for k, v in ts.items()
                                  if k != "count"})
        assert leaves and all(x.dtype == torch.float32 for x in leaves)
    st = T.get_optimizer(T.OptConfig(name="adamw"))[0](
        {"w": torch.ones((2, 2), dtype=torch.bfloat16)})
    assert st["m"]["w"].dtype == torch.float32


def test_lr_at_matches_jax():
    """Warmup, cosine decay and the floor, in f32, at every step."""
    cfg = dict(lr=3e-4, warmup=10, decay_steps=50, min_lr_frac=0.1)
    jc, tc = J.OptConfig(**cfg), T.OptConfig(**cfg)
    steps = np.arange(0, 60, dtype=np.int32)
    want = np.asarray(jax.vmap(lambda s: J.lr_at(jc, s))(jnp.asarray(steps)))
    got = np.array([T.lr_at(tc, torch.tensor(int(s), dtype=torch.int32))
                    .item() for s in steps])
    assert T.lr_at(tc, torch.tensor(0, dtype=torch.int32)).dtype == \
        torch.float32
    np.testing.assert_allclose(got, want, rtol=LR_RTOL)
    assert got[0] == pytest.approx(3e-5) and got[-1] == pytest.approx(3e-5)


@pytest.mark.parametrize("max_norm", [0.5, 1e6])
def test_clip_by_global_norm_matches_jax(max_norm):
    """The norm over every leaf in f32 and each gradient scaled in f32 and
    cast back (bf16 leaves stay bf16); no clip (scale 1) leaves the bits."""
    rng = np.random.default_rng(4)
    grads = make_tree(rng)
    jg, jn = J.clip_by_global_norm(to_jax(grads), max_norm)
    tg, tn = T.clip_by_global_norm(to_port(grads), max_norm)
    assert tn.dtype == torch.float32
    assert float(tn) == pytest.approx(float(jn), rel=1e-6)
    assert_params(tg, jg)
    np.testing.assert_allclose(float(T.global_norm(to_port(grads))),
                               float(J.global_norm(to_jax(grads))),
                               rtol=1e-6)
    if max_norm > 1e3:
        assert all(torch.equal(tg[k], v) for k, v in to_port(grads).items())
    bf = {"w": torch.ones(3, dtype=torch.bfloat16)}
    assert T.clip_by_global_norm(bf, 0.1)[0]["w"].dtype == torch.bfloat16


@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgd"])
def test_optimizer_reduces_quadratic(name):
    """Each optimizer makes progress on a convex toy problem (twin of
    tests/test_substrates.py::test_optimizer_reduces_quadratic)."""
    cfg = T.OptConfig(name=name, lr=0.05, warmup=1, decay_steps=400,
                      weight_decay=0.0)
    init, update = T.get_optimizer(cfg)
    params = {"w": torch.ones((4, 4)) * 3.0, "b": torch.ones((4,)) * -2.0}
    opt = init(params)

    def loss(p):
        return (p["w"] ** 2).sum() + (p["b"] ** 2).sum()

    l0 = float(loss(params))
    for _ in range(200):
        grads = {k: 2 * v for k, v in params.items()}
        params, opt = update(grads, opt, params)
    assert float(loss(params)) < 0.05 * l0, name


def test_jax_leaves_group_layers():
    """The port's per-layer names group into the JAX leaves, sorted as the
    JAX tree flattens, with their stacked leading axes; a stack with a
    missing layer is refused."""
    names = to_port(make_tree(np.random.default_rng(5)))
    leaves = T.jax_leaves(names)
    assert [".".join(x.path) for x in leaves] == [
        "blocks.norm", "blocks.w", "dense_blocks.norm", "dense_blocks.w",
        "embed", "final_norm"]
    by = {".".join(x.path): x for x in leaves}
    assert by["blocks.w"].lead == (L,)
    assert by["dense_blocks.w"].lead == (N, PER)
    assert by["dense_blocks.w"].names[:3] == (
        "dense_blocks.0.0.w", "dense_blocks.0.1.w", "dense_blocks.1.0.w")
    assert by["embed"].lead == ()
    assert T.jax_ndim("blocks.0.norm", names["blocks.0.norm"]) == 2
    assert T.jax_ndim("final_norm", names["final_norm"]) == 1
    del names["blocks.1.norm"]
    with pytest.raises(ValueError):
        T.jax_leaves(names)
