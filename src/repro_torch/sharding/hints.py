"""Activation-sharding hints -- counterpart of `repro.sharding.hints`.

The JAX package installs, per (config, mesh), a table of GSPMD
constraints for intermediates (attention logits, the residual stream,
the MoE dispatch buffer, ...) that model code consults through
``constrain(x, kind)``, and flags such as ``kv_masked_write``.

`configure` builds the same table and `flag` reads the same flags.  On a
mesh the port's step computes on whole parameters and this rank's rows
of the batch (`sharding.layout`, `sharding.split`), so there is no
activation to lay out: `constrain` returns its input, and the model code
carries no call to it.  The one flag the port's model
reads is ``kv_masked_write`` (`models.attention`: the decode write as a
one-hot merge, which keeps a sequence-sharded cache's write local).
"""
from __future__ import annotations

import threading

from repro_torch.sharding.rules import PartitionSpec as P

__all__ = ["configure", "flag", "constrain"]

_STATE = threading.local()


def configure(cfg, mesh, *, kv_masked_write: bool = False) -> None:
    """Install hints for cfg on mesh; pass mesh=None to clear.

    kv_masked_write: decode writes the KV cache with a one-hot masked
    merge instead of an indexed write -- the JAX package needs it when
    S is sharded (long_500k).
    """
    if mesh is None:
        _STATE.hints = None
        return
    data_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    model_ax = "model" if "model" in mesh.axis_names else None
    msize = mesh.shape.get("model", 1)
    heads_div = cfg.n_heads and msize > 1 and cfg.n_heads % msize == 0
    b = data_axes or None
    # sequence-parallel residual stream for the families without a
    # temporal mix (ssm/hybrid keep the sequence local)
    seq_sp = cfg.family in ("dense", "moe", "vlm", "encdec")

    hints = {}
    if model_ax and msize > 1:
        if heads_div:
            hints["attn_logits"] = P(b, model_ax, None, None)
            hints["qkv"] = P(b, None, model_ax, None)
            hints["attn_out"] = P(b, None, model_ax, None)
        else:
            hints["attn_logits"] = P(b, None, model_ax, None)
            hints["qkv"] = P(b, None, None, None)
            hints["attn_out"] = P(b, None, None, None)
        hints["mlp_hidden"] = P(b, None, model_ax)
        hints["residual"] = P(b, model_ax if seq_sp else None, None)
        hints["gathered"] = P(b, None, None)
        hints["ce_logits"] = P(b, None, model_ax)
        if cfg.n_experts and cfg.n_experts % msize == 0:
            hints["moe_buf"] = P(model_ax, None, None)
        else:
            hints["moe_buf"] = P(None, b, None)
    _STATE.hints = {"mesh": mesh, "specs": hints,
                    "flags": {"kv_masked_write": kv_masked_write}}


def flag(name: str) -> bool:
    st = getattr(_STATE, "hints", None)
    return bool(st and st.get("flags", {}).get(name))


def constrain(x, kind: str):
    """Returns ``x``: the port's mesh step lays out no activation."""
    return x
