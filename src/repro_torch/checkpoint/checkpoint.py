"""Checkpoints -- counterpart of `repro.checkpoint.checkpoint`: atomic,
async-capable, restored onto any device.

Layout, the JAX package's: ``step_%08d/`` holding one ``.npy`` per leaf
(the leaf's path joined by ``__``: ``params__blocks__0__attn__wq``,
``opt__m__blocks__attn__wq``) and ``manifest.json`` with the step and a
name/shape/dtype table; written into ``.tmp_step_%08d_<pid>`` and
renamed atomically, so a crash mid-save never corrupts the latest
checkpoint.  A state is a tree of dicts, lists and tuples whose leaves
are tensors; an ``nn.Module`` node contributes its named parameters and
buffers (the port's layer names, ``blocks.0.attn.wq``).

numpy has no bf16: a bf16 leaf is stored as its bits (uint16) with
``bfloat16`` in the manifest, so that it round-trips bitwise.
``save_async`` copies every leaf to the host on the caller's thread
(``t.detach().to("cpu", copy=True)``, as JAX's ``device_get``): on the
CPU ``t.cpu()`` and ``t.numpy()`` are views of the live tensor, which
the next step's in-place update would race.  `wait_pending` joins the
background writes.

``restore(dir, like, device=)`` builds a new state shaped as ``like``
(whose tensor leaves may be on any device, ``meta`` included) on the
card unless ``device="cpu"``, so a checkpoint saved from the card
restores onto the CPU.  Restoring onto another mesh (``shardings=`` in
the JAX package) waits for the port's sharding rules.
"""
from __future__ import annotations

import copy
import itertools
import json
import os
import re
import shutil
import threading
from pathlib import Path
from typing import Any, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.estimators.operators.base import resolve_device

__all__ = ["save", "save_async", "restore", "latest_step", "wait_pending"]

_PENDING: List[threading.Thread] = []


def _leaves(tree, path=()) -> Iterator[Tuple[tuple, torch.Tensor]]:
    """(path, tensor) for every leaf, dict keys in sorted order (JAX's)."""
    if isinstance(tree, torch.nn.Module):
        named = itertools.chain(tree.named_parameters(), tree.named_buffers())
        for name, t in named:
            yield path + tuple(name.split(".")), t
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    elif isinstance(tree, torch.Tensor):
        yield path, tree
    else:
        raise TypeError(f"{'__'.join(path)}: checkpoint leaves are tensors, "
                        f"got {type(tree).__name__}")


def _leaf_name(path) -> str:
    return "__".join(path) or "leaf"


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A host tensor as the array written to disk and its dtype's name."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _write(ckpt_dir: Path, named, step: int) -> Path:
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_step_{step:08d}_{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": int(step), "leaves": []}
    for name, t in named:
        arr, dtype = _to_numpy(t)
        np.save(tmp / f"{name}.npy", arr)
        manifest["leaves"].append(
            {"name": name, "shape": list(t.shape), "dtype": dtype})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)                      # atomic on POSIX
    return final


def save(ckpt_dir: str | Path, state: Any, step: int) -> Path:
    """Synchronous atomic save of a state; returns the final directory."""
    named = [(_leaf_name(p), t.detach().cpu()) for p, t in _leaves(state)]
    return _write(Path(ckpt_dir), named, step)


def save_async(ckpt_dir: str | Path, state: Any,
               step: int) -> threading.Thread:
    """Background save: every leaf is copied to the host on the caller's
    thread first, so the training loop may update the state in place as
    soon as this returns."""
    named = [(_leaf_name(p), t.detach().to("cpu", copy=True))
             for p, t in _leaves(state)]
    t = threading.Thread(target=_write, args=(Path(ckpt_dir), named, step),
                         daemon=True)
    t.start()
    _PENDING.append(t)
    return t


def wait_pending():
    while _PENDING:
        _PENDING.pop().join()


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(m.group(1)) for p in ckpt_dir.iterdir()
             if (m := re.fullmatch(r"step_(\d+)", p.name))]
    return max(steps) if steps else None


def _skeleton(module: torch.nn.Module) -> torch.nn.Module:
    """A copy of ``module`` whose parameters and buffers are meta tensors
    (nothing allocated), to be filled with ``load_state_dict(assign=True)``."""
    memo = {}
    for t in itertools.chain(module.parameters(), module.buffers()):
        meta = torch.empty_like(t, device="meta")
        memo[id(t)] = (torch.nn.Parameter(meta, requires_grad=t.requires_grad)
                       if isinstance(t, torch.nn.Parameter) else meta)
    return copy.deepcopy(module, memo)


def restore(ckpt_dir: str | Path, like: Any, *, step: Optional[int] = None,
            device=None) -> Tuple[Any, int]:
    """Restore a state saved by `save` -> (state, step), on the card unless
    ``device="cpu"``.  ``like`` gives the tree (its leaves' shapes are
    checked: a mismatch raises ``ValueError``); each leaf keeps the dtype
    it was saved with."""
    dev = resolve_device(device)
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    dtypes = {leaf["name"]: leaf["dtype"] for leaf in manifest["leaves"]}

    def load(path, want):
        name = _leaf_name(path)
        arr = np.load(d / f"{name}.npy")
        if tuple(arr.shape) != tuple(want.shape):
            raise ValueError(f"{name}: checkpoint shape {arr.shape} != "
                             f"{tuple(want.shape)}")
        return _from_numpy(arr, dtypes[name]).to(dev)

    def build(node, path):
        if isinstance(node, torch.nn.Module):
            new = _skeleton(node)
            sd = {}
            for name, t in itertools.chain(node.named_parameters(),
                                           node.named_buffers()):
                sd[name] = load(path + tuple(name.split(".")), t)
            new.load_state_dict(sd, strict=True, assign=True)
            return new
        if isinstance(node, dict):
            return {k: build(node[k], path + (str(k),)) for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v, path + (str(i),))
                              for i, v in enumerate(node))
        return load(path, node)

    return build(like, ()), int(manifest["step"])
