"""Shared twin checks of `repro_torch.models` against `repro.models`.

Each family's test file (tests/test_torch_models_*.py) parametrizes the
checks below over its archs; the files are split by family so that each
runs on one worker of the parallel test run in well under two minutes.

For one arch at its smoke config (f32 activations; llama4 keeps its bf16
parameters) the JAX references are computed once per module, under
``jax.jit``: the JAX ``init_model(PRNGKey(0), cfg)`` tree, carried into
the port by `from_jax_params`; the forward logits and aux on a seeded
batch; and the loss and gradients of one SGD step (remat on, as
``tests/test_arch_smoke.py::test_train_step_one``).

MoE routing: a near-tie of the f32 router gates can send a token to
another expert in one framework than in the other, and then the logits
differ by far more than any tolerance.  So the MoE checks first assert,
layer by layer, that the JAX gates' top-k margin at every token exceeds
the two frameworks' gate difference: a flip shows as a named failure.
"""
from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs.registry import get_config as jax_config
from repro.models import model as JM
from repro.models.attention import attn_apply as jax_attn_apply
from repro.models.blocks import dense_block_apply as jax_dense_block
from repro.models.common import rmsnorm as jax_rmsnorm
from repro.models.moe import moe_apply as jax_moe_apply

from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.models.convert import from_jax_params, unstacked
from repro_torch.models.moe import MoE

FWD_RTOL = FWD_ATOL = 1e-4
AUX_RTOL = 1e-5
DECODE_TOL = 2e-4
LOSS_RTOL = 1e-5
GRAD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}
FWD_SHAPE, SGD_SHAPE = (2, 16), (2, 8)


def configs(arch: str, **kw):
    """(JAX cfg, port cfg) at the smoke size, f32 activations."""
    jcfg = jax_config(arch, smoke=True).replace(dtype=jnp.float32, **kw)
    cfg = get_config(arch, smoke=True).replace(dtype=torch.float32, **kw)
    return jcfg, cfg


def make_batch(cfg, b: int, t: int, rng):
    """The same batch as numpy arrays (f32 extras)."""
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["img_embeds"] = rng.standard_normal(
            (b, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    return batch


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def jax_loss_fn(jcfg):
    def loss_fn(p, batch, targets):
        logits, aux = JM.forward(p, batch, jcfg)
        ll = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(ll, targets[..., None], axis=-1).mean()
        return nll + 0.01 * sum(aux.values()) if aux else nll
    return loss_fn


def port_loss(model, batch, targets):
    logits, aux = M.forward(model, batch)
    ll = torch.log_softmax(logits, dim=-1)
    nll = -torch.take_along_dim(ll, targets[..., None].long(), dim=-1).mean()
    return nll + 0.01 * sum(aux.values()) if aux else nll


class Twin:
    """One arch's JAX references, computed once."""

    def __init__(self, arch: str):
        self.arch = arch
        self.jcfg, self.cfg = configs(arch, remat=False)
        rng = np.random.default_rng(0)
        self.params = JM.init_model(jax.random.PRNGKey(0), self.jcfg)
        self.np_params = jax.device_get(self.params)
        self.fwd_batch = make_batch(self.cfg, *FWD_SHAPE, rng)
        self.sgd_batch = make_batch(self.cfg, *SGD_SHAPE, rng)
        self.sgd_targets = rng.integers(0, self.cfg.vocab,
                                        SGD_SHAPE).astype(np.int32)
        jcfg = self.jcfg
        logits, aux = jax.jit(lambda p, b: JM.forward(p, b, jcfg))(
            self.params, to_jax(self.fwd_batch))
        self.logits = np.asarray(logits)
        self.aux = {k: float(v) for k, v in aux.items()}
        jcfg_r = self.jcfg.replace(remat=True)
        loss, grads = jax.jit(jax.value_and_grad(jax_loss_fn(jcfg_r)))(
            self.params, to_jax(self.sgd_batch),
            jnp.asarray(self.sgd_targets))
        self.loss = float(loss)
        self.grads = unstacked(jax.device_get(grads))

    def model(self, cfg=None):
        return from_jax_params(self.np_params, cfg or self.cfg, device="cpu")


# ---------------------------------------------------------------- routing

def _jax_moe_inputs(params, batch, jcfg):
    """Each MoE layer's normalized input in the JAX forward (its blocks'
    own functions, layer by layer), with that layer's router."""
    x = params["embed"][batch["tokens"]].astype(jcfg.dtype)
    windows = JM.layer_windows(jcfg)
    eps = jcfg.norm_eps
    out = []
    plan, c = JM._family_plan(jcfg)

    def sl(tree, *idx):
        for i in idx:
            tree = jax.tree.map(lambda l, i=i: l[i], tree)
        return tree

    def moe_block(bp, x, window):
        h, _ = jax_attn_apply(bp["attn"],
                              jax_rmsnorm({"scale": bp["attn_norm"]}, x, eps),
                              jcfg, mode="train", window=window)
        x = x + h
        xin = jax_rmsnorm({"scale": bp["mlp_norm"]}, x, eps)
        out.append((xin, bp["moe"]["router"]))
        return x + jax_moe_apply(bp["moe"], xin, jcfg)[0]

    for i in range(c["n"]):
        if plan == "pair_moe":
            for j in range(c["dense_per"]):
                x = jax_dense_block(sl(params["dense_blocks"], i, j), x, jcfg,
                                    mode="train", window=0)[0]
            x = moe_block(sl(params["moe_blocks"], i), x, 0)
        else:
            x = moe_block(sl(params["blocks"], i), x, int(windows[i]))
    return out


def _port_moe_inputs(model, batch):
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: seen.append((mod, args[0].detach())))
        for m in model.modules() if isinstance(m, MoE)]
    try:
        with torch.no_grad():
            M.forward(model, batch)
    finally:
        for h in hooks:
            h.remove()
    return seen


def assert_routing_margin(twin: Twin, model, batch_np):
    """At every MoE layer and token: the JAX gates' gap between the k-th
    and (k+1)-th expert exceeds the largest gate difference between the
    frameworks, so both pick the same experts."""
    k, e = twin.cfg.top_k, twin.cfg.n_experts
    jin = _jax_moe_inputs(twin.params, to_jax(batch_np), twin.jcfg)
    pin = _port_moe_inputs(model, to_torch(batch_np))
    assert len(jin) == len(pin) > 0
    for layer, ((jx, router), (mod, px)) in enumerate(zip(jin, pin)):
        d = jx.shape[-1]
        jg = np.asarray(jax.nn.softmax(
            jnp.einsum("nd,de->ne", jx.reshape(-1, d).astype(jnp.float32),
                       router), axis=-1))
        with torch.no_grad():
            pg = mod.route(px.reshape(-1, d))[0].numpy()
        diff = float(np.abs(jg - pg).max())
        top = -np.sort(-jg, axis=-1)
        margin = top[:, k - 1] - (top[:, k] if k < e else -np.inf)
        assert float(margin.min()) > diff, (
            f"{twin.arch} MoE layer {layer}: a routing near-tie "
            f"(min top-{k} margin {margin.min():.3g} <= gate difference "
            f"{diff:.3g}); the frameworks may route differently")


# ---------------------------------------------------------------- checks

def check_forward(twin: Twin):
    """Forward logits within 1e-4 (rtol and atol), aux within 1e-5."""
    model = twin.model()
    if twin.cfg.n_experts:
        assert_routing_margin(twin, model, twin.fwd_batch)
    with torch.no_grad():
        logits, aux = M.forward(model, to_torch(twin.fwd_batch))
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), twin.logits, rtol=FWD_RTOL,
                               atol=FWD_ATOL, err_msg=twin.arch)
    assert set(aux) == set(twin.aux)
    for key, want in twin.aux.items():
        assert abs(float(aux[key]) - want) <= AUX_RTOL * abs(want), (
            twin.arch, key, float(aux[key]), want)


def check_prefill_decode(twin: Twin):
    """prefill(6 tokens) + 4 decode steps == forward(10 tokens) logits,
    on the port alone (MoE dropless, as the JAX twin test)."""
    cfg = twin.cfg
    if cfg.n_experts:
        cfg = cfg.replace(capacity_factor=float(cfg.n_experts))
    model = twin.model(cfg)
    b, t_pre, t_total, max_len = 2, 6, 10, 16
    batch = to_torch(make_batch(cfg, b, t_total, np.random.default_rng(1)))
    with torch.no_grad():
        full, _ = M.forward(model, batch)
        pre = dict(batch, tokens=batch["tokens"][:, :t_pre])
        logits_p, caches = M.prefill(model, pre, max_len)
        np.testing.assert_allclose(logits_p[:, 0].numpy(),
                                   full[:, t_pre - 1].numpy(),
                                   rtol=DECODE_TOL, atol=DECODE_TOL)
        extras = None
        if cfg.family == "encdec":
            extras = {"memory": M._encode(model, batch)}
        elif cfg.family == "vlm":
            extras = {"img_embeds": batch["img_embeds"]}
        for pos in range(t_pre, t_total):
            tok = batch["tokens"][:, pos:pos + 1]
            logits_d, caches = M.decode_step(model, tok, caches, pos,
                                             batch_extras=extras)
            np.testing.assert_allclose(
                logits_d[:, 0].numpy(), full[:, pos].numpy(),
                rtol=DECODE_TOL, atol=DECODE_TOL,
                err_msg=f"{twin.arch} pos={pos}")


def tree_sig(tree):
    """Nested (shape, dtype-name) of a cache tree: meta or real tensors,
    or JAX arrays / ShapeDtypeStructs."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_sig(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(tree_sig(v) for v in tree)
    return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))


def check_cache_specs(twin: Twin):
    """The caches prefill returns equal the port's `cache_specs`, and
    those equal the JAX ``cache_specs``, shape for shape and dtype for
    dtype; the port's specs allocate nothing (meta tensors)."""
    model = twin.model()
    max_len = 12
    batch = to_torch(make_batch(twin.cfg, 2, 6, np.random.default_rng(2)))
    with torch.no_grad():
        _, caches = M.prefill(model, batch, max_len)
    specs = M.cache_specs(twin.cfg, 2, max_len)
    assert tree_sig(caches) == tree_sig(specs), twin.arch
    assert tree_sig(specs) == tree_sig(JM.cache_specs(twin.jcfg, 2, max_len))
    for leaf in _leaves(specs):
        assert leaf.device.type == "meta"


def _leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def port_grads(twin: Twin, remat: bool):
    model = twin.model(twin.cfg.replace(remat=remat))
    loss = port_loss(model, to_torch(twin.sgd_batch),
                     torch.from_numpy(twin.sgd_targets))
    loss.backward()
    return model, loss, {n: p.grad for n, p in model.named_parameters()}


def check_sgd_step(twin: Twin):
    """One SGD step as ``test_train_step_one``: the loss within 1e-5
    relative of JAX's, every gradient leaf within 1e-4 relative norm of
    ``jax.grad``'s (2^-7 for a bf16 leaf: both frameworks round an f32
    gradient to bf16 at the end), and the stepped model's logits finite."""
    if twin.cfg.n_experts:
        assert_routing_margin(twin, twin.model(), twin.sgd_batch)
    model, loss, grads = port_grads(twin, remat=True)
    assert abs(loss.item() - twin.loss) <= LOSS_RTOL * abs(twin.loss)
    assert set(grads) == set(twin.grads)
    for name, g in grads.items():
        want = np.asarray(twin.grads[name]).astype(np.float64)
        assert g is not None and g.dtype == dict(
            model.named_parameters())[name].dtype, name
        got = g.double().numpy()
        scale = max(np.linalg.norm(want), 1e-30)
        rel = np.linalg.norm(got - want) / scale
        assert rel <= GRAD_RTOL[g.dtype], (twin.arch, name, rel)
    with torch.no_grad():
        for p in model.parameters():
            p -= 1e-3 * p.grad.to(p.dtype)
        logits, _ = M.forward(model, to_torch(twin.sgd_batch))
    assert bool(torch.isfinite(logits).all()), twin.arch


def check_remat_bitwise(twin: Twin):
    """Recomputing each block in the backward changes no bit of the loss
    or of any gradient."""
    _, loss_r, g_r = port_grads(twin, remat=True)
    _, loss_n, g_n = port_grads(twin, remat=False)
    assert torch.equal(loss_r, loss_n)
    for name in g_r:
        assert torch.equal(g_r[name], g_n[name]), (twin.arch, name)


CHECKS = {"forward": check_forward, "prefill_decode": check_prefill_decode,
          "cache_specs": check_cache_specs, "sgd_step": check_sgd_step,
          "remat_bitwise": check_remat_bitwise}


def twin_fixture(archs):
    """A module-scoped fixture: arch -> its `Twin`, built on first use."""
    cache = {}

    @pytest.fixture(scope="module")
    def twins():
        def get(arch):
            if arch not in cache:
                cache[arch] = Twin(arch)
            return cache[arch]
        return get
    return twins
