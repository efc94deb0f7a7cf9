"""CPU twins of `repro_torch.launch.dryrun` against `repro.launch.dryrun`.

The JAX launcher test's two smoke cells (tests/test_launch_integration.py
::test_dryrun_smoke_cell: gemma3-1b train_4k on 16x16 and decode_32k on
2x16x16) through the port's `run_cell`: the peak is positive, the
bottleneck one of the three terms, the mesh named.  Their argument bytes
per device equal the bytes of the JAX rules' shards of the JAX cell's
arguments (``jax.eval_shape`` trees, `repro.sharding.rules` specs on a
`FakeMesh` of the production shape), computed without compiling.  Their
broadcasts and wire bytes: a serving cell gathers those shards (one
broadcast per block of every split leaf, the leaf's bytes on the wire);
a train cell's split step gathers the parameters only (the optimizer
state never), one unit at a time: a layer's for its forward and again
for its backward, the embedding's and the final norm's once; its
all_sums are the nll's exchange over the D ranks of the data axes (D
f32s), one of every parameter's gradient (its bytes), the global norm's
(one f64) and the agreement (one f32).  A leaf the rules split on "model"
where the port's step computes its model block (heads, kv heads, mlp,
vocab, experts; not the router nor the SSM's inner leaves) is gathered
over the data axes only, and its gradient summed at its model block's
bytes; the model line adds its activations' all_sums (`_model_line`).  The skip record and the ``--out`` / ``--skip-existing`` files of
the port's CLI equal the JAX CLI's (run in a subprocess: the JAX module
sets its device count on import)."""
from __future__ import annotations

import importlib.util
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.registry import batch_specs as jax_batch_specs
from repro.configs.registry import get_config as jax_config
from repro.models import model as JM
from repro.optim.optimizers import OptConfig as JOptConfig
from repro.sharding import rules as JR
from repro.train.step import TrainConfig as JTrainConfig
from repro.train.step import init_train_state as jax_init_train_state

from repro_torch.configs import get_config
from repro_torch.launch import dryrun as D
from repro_torch.models import Model
from repro_torch.models.common import empty_init
from repro_torch.models.convert import STACK_DEPTH

from _subproc import SRC

CELLS = [("gemma3-1b", "train_4k", False), ("gemma3-1b", "decode_32k", True)]


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def _mesh(multi_pod):
    if multi_pod:
        return FakeMesh({"pod": 2, "data": 16, "model": 16})
    return FakeMesh({"data": 16, "model": 16})


def _split(spec, fm) -> list:
    """The split count of each entry of a JAX spec."""
    return [1 if e is None else math.prod(
        fm.shape[a] for a in (e if isinstance(e, tuple) else (e,)))
        for e in spec]


def jax_cell_bytes(arch, shape_name, multi_pod, smoke=True):
    """(argument bytes per device, broadcasts, their wire bytes, all_sums,
    their bytes) of the JAX cell's arguments laid out by the JAX rules: a
    serving cell's gathers; a train cell's split step (one microbatch, no
    aux and no MoE layer, as the port's dry run trains these archs): the
    parameters' gathers (a stacked layer leaf twice: its forward and its
    backward), then the nll's exchange over the data axes, the gradients'
    reduction, the global norm's and the agreement."""
    from repro_torch.configs.shapes import SHAPES
    shape = SHAPES[shape_name]
    fm = _mesh(multi_pod)
    jcfg = jax_config(arch, smoke=smoke)
    specs = jax_batch_specs(jcfg, shape.global_batch, shape.seq_len,
                            kind=shape.kind)
    bspec = JR.batch_spec(jcfg, fm, kind=shape.kind,
                          batch=shape.global_batch)
    leaves = [(specs[k], bspec[k]) for k in specs]
    if shape.kind == "train":
        tcfg = JTrainConfig(opt=JOptConfig(name="adamw"))
        state = jax.eval_shape(lambda k: jax_init_train_state(k, jcfg, tcfg),
                               jax.random.PRNGKey(0))
        ps = JR.param_specs({"params": state["params"], "opt": state["opt"]},
                            jcfg, JR.make_rules(jcfg, fm), fm)
        trees = [({"params": state["params"], "opt": state["opt"]}, ps, 1)]
        leaves.append((state["step"], JR.P()))
    else:
        scfg = jcfg.replace(attn_impl="chunked", remat=False)
        params = jax.eval_shape(lambda k: JM.init_model(k, scfg),
                                jax.random.PRNGKey(0))
        caches = JM.cache_specs(scfg, shape.global_batch, shape.seq_len)
        trees = [(params, JR.param_specs(params, scfg,
                                         JR.make_rules(scfg, fm), fm), 0),
                 (caches, JR.cache_shardings(caches, scfg, fm), None)]
        leaves.append((jax.ShapeDtypeStruct((), jnp.int32), JR.P()))
    leaves = [(leaf, spec, 1, False, False, 1) for leaf, spec in leaves]
    # the port holds a parameter's stacked layers as tensors apart (one
    # gather each; ``top`` is where the parameter tree's top-level key
    # sits in a path); optimizer and cache leaves stay stacked
    for tree, spec_tree, top in trees:
        for (path, leaf), spec in zip(
                jax.tree_util.tree_flatten_with_path(tree)[0],
                jax.tree.leaves(spec_tree,
                                is_leaf=lambda x: isinstance(x, JR.P))):
            keys = [getattr(k, "key", None) for k in path]
            params = top is not None and (top == 0 or keys[0] == "params")
            depth = STACK_DEPTH.get(keys[top], 0) if params else 0
            leaves.append((leaf, spec, math.prod(leaf.shape[:depth]),
                           params, depth > 0,
                           _model_ways(path, leaf, spec, fm)
                           if params and shape.kind == "train" else 1))
    train = shape.kind == "train"
    data = math.prod(fm.shape[a] for a in ("pod", "data")
                     if a in fm.shape)
    split = train and shape.global_batch % data == 0
    arg, count, wire = 0, 0, 0
    sums, summed = (3, data * 4 + 8 + 4) if split else (0, 0)
    for leaf, spec, tensors, param, layer, mways in leaves:
        nbytes = int(np.prod(leaf.shape)) * jnp.dtype(leaf.dtype).itemsize
        n = math.prod(_split(spec, fm))
        arg += nbytes // n
        # a train step gathers a layer's leaf (a stacked one) twice; a leaf
        # computed on its model block over the data line only
        times = 2 if train and layer else 1
        if n // mways > 1 and (param or not train):
            count += n // mways * tensors * times
            wire += nbytes // mways * times
        if split and param:
            sums += tensors
            summed += nbytes // mways
    if train and fm.shape.get("model", 1) > 1:
        line, line_bytes = _model_line(jcfg, shape, fm, data)
        sums += line
        summed += line_bytes
    return arg, count, wire, sums, summed


def _model_ways(path, leaf, spec, fm) -> int:
    """How many ways the port's step splits a parameter leaf over its
    model line: the "model" axis where the JAX spec puts it on a dim of
    logical axis heads, kv_heads, mlp, vocab, or expert outside the router
    (the SSM's inner leaves and the router are gathered whole), else 1."""
    last = getattr(path[-1], "key", None)
    for ax, e in zip(JR.logical_axes_for(path, leaf), spec):
        axes = () if e is None else (e if isinstance(e, tuple) else (e,))
        if "model" in axes and (ax in ("heads", "kv_heads", "mlp", "vocab")
                                or (ax == "expert" and last != "router")):
            return fm.shape["model"]
    return 1


def _model_line(jcfg, shape, fm, data) -> tuple:
    """(all_sums, their bytes) over the model line in a dense arch's
    train step without the aux, one microbatch, remat (gemma3-1b): a
    layer's split attention (heads dividing the model axis) and its split
    MLP each sum their output twice (the forward and the recomputation)
    and their input's gradient once, bf16 activations of the rank's rows;
    a vocab-parallel embedding sums its lookup; each 512-token CE chunk
    exchanges three f32s a row and rank (twice) and sums its f32 hidden
    chunk's gradient."""
    assert jcfg.family == "dense" and jcfg.remat
    m = fm.shape["model"]
    b, t, d = shape.global_batch // data, shape.seq_len, jcfg.d_model
    x = b * t * d * 2
    per_layer = 3 * ((jcfg.n_heads % m == 0) + (jcfg.d_ff % m == 0))
    count, nbytes = jcfg.n_layers * per_layer, jcfg.n_layers * per_layer * x
    if jcfg.vocab % m == 0:
        chunks = t // min(512, t)
        count += 1 + 3 * chunks
        nbytes += x + chunks * (2 * m * 3 * b * min(512, t) * 4
                                + b * min(512, t) * d * 4)
    return count, nbytes


@pytest.mark.parametrize("arch,shape,multi_pod", CELLS)
def test_smoke_cell_records(arch, shape, multi_pod):
    rec = D.run_cell(arch, shape, multi_pod=multi_pod, smoke=True, fast=True)
    assert rec["memory"]["peak_bytes_per_device"] > 0
    assert rec["bottleneck"] in ("compute_s", "memory_s", "collective_s")
    assert rec["mesh"] == ("2x16x16" if multi_pod else "16x16")
    assert rec["chips"] == (512 if multi_pod else 256)
    arg, count, wire, sums, summed = jax_cell_bytes(arch, shape, multi_pod)
    assert rec["memory"]["argument_bytes_per_device"] == arg
    # a train step adds the nll's exchange over the 16 data ranks, the
    # gradients' reduction, the global norm's and the agreement that it
    # commits
    assert (sums > 0) == shape.startswith("train")
    assert rec["collective_counts"] == dict(
        {"broadcast": count}, **({"all_sum": sums} if sums else {}))
    assert rec["wire_bytes_per_chip"] == wire + summed
    assert rec["memory"]["temp_bytes_per_device"] is None     # fast
    assert rec["hlo_flops_global"] >= rec["model_flops"] > 0
    assert rec["hlo_bytes_global"] > 0
    assert rec["step_s_lower_bound"] == max(
        rec["compute_s"], rec["memory_s"], rec["collective_s"])


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smokes_full_cells_hold_the_jax_rules_bytes():
    """`chip_smoke.py` phase 15(d) holds the dry run's full-size records
    against byte totals it cannot derive on the card (no JAX there):
    these are the JAX rules' shards of the JAX cells' arguments."""
    cells = _chip_smoke().DRYRUN_CELLS
    assert len(cells) == 2
    for arch, shape, multi_pod, _, want in cells:
        assert want == jax_cell_bytes(arch, shape, multi_pod, smoke=False)


def test_the_memory_pass_counts_the_steps_allocations():
    """Without ``fast`` the second pass adds what the step allocates
    beyond its arguments -- the parameters gathered whole among it -- and
    the peak is that plus what a rank holds at the step's start: its
    blocks of the state and its rows of the batch, its arguments."""
    rec = D.run_cell("gemma3-1b", "train_4k", multi_pod=False, smoke=True)
    m = rec["memory"]
    params = sum(t.numel() * t.element_size() for t in Model(
        get_config("gemma3-1b", smoke=True),
        empty_init(torch.device("meta"))).parameters())
    assert m["temp_bytes_per_device"] > params
    assert m["held_bytes_per_device"] == m["argument_bytes_per_device"] > 0
    assert m["peak_bytes_per_device"] == (m["held_bytes_per_device"]
                                          + m["temp_bytes_per_device"])


def _jax_cli(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = SRC
    env["JAX_PLATFORMS"] = "cpu"
    code = ("import sys; from repro.launch.dryrun import main; "
            f"main({args!r})")
    subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                   check=True, capture_output=True, timeout=300)


def test_cli_skip_records_and_files_match_jax(tmp_path, capsys):
    args = ["--arch", "qwen2.5-3b", "--shape", "long_500k", "--mesh", "both"]
    jfile, pfile = tmp_path / "jax.jsonl", tmp_path / "port.jsonl"
    _jax_cli(args + ["--out", str(jfile)], tmp_path)
    D.main(args + ["--out", str(pfile)])
    jlines = jfile.read_text().splitlines()
    assert len(jlines) == 2
    assert [json.loads(x) for x in pfile.read_text().splitlines()] == \
        [json.loads(x) for x in jlines]
    out = capsys.readouterr().out
    assert "[16x16] qwen2.5-3b x long_500k: SKIP" in out
    assert "ALL CELLS PASSED" in out
    # --skip-existing: both leave their files as they are, and the port's
    # reads the JAX file's records as done
    _jax_cli(args + ["--out", str(jfile), "--skip-existing"], tmp_path)
    D.main(args + ["--out", str(pfile), "--skip-existing"])
    D.main(args + ["--out", str(jfile), "--skip-existing"])
    assert jfile.read_text().splitlines() == jlines
    assert [json.loads(x) for x in pfile.read_text().splitlines()] == \
        [json.loads(x) for x in jlines]


def test_cli_records_a_smoke_cell_and_skips_it_again(tmp_path):
    out = tmp_path / "cells.jsonl"
    argv = ["--arch", "mamba2-370m", "--shape", "decode_32k", "--mesh",
            "single", "--smoke", "--out", str(out)]
    D.main(argv)
    D.main(argv + ["--skip-existing"])
    recs = [json.loads(x) for x in out.read_text().splitlines()]
    assert len(recs) == 1
    assert (recs[0]["arch"], recs[0]["shape"], recs[0]["mesh"]) == (
        "mamba2-370m", "decode_32k", "16x16")
