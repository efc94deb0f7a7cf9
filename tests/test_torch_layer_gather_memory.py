"""What the unit-by-unit mesh step (`sharding.fsdp`) keeps whole, seen by
weak references that the test keeps itself (`test_torch_ranks
.layer_gather_memory`, on a 2x2 grid of gloo ranks on the CPU, gemma3-1b
smoke at 2 and 12 layers, AdamW with the logdet aux, with and without
remat, and without remat at bf16 activations, where every block casts
its f32 weights and the cast is what its ops save): at no gather and no
reduction of the forward or the backward are
more than the root unit and two layer units whole alive; no whole
gradient of a split leaf outlives its unit's reduction; the high-water
of whole bytes is the same at 2 and 12 layers.  Then Adafactor, whose
update reads the whole leaf, against the JAX package's jitted step
(`_torch_layer_gather`), and a one-rank mesh step bitwise the
single-device step."""
from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from repro_torch.core.mesh import run_ranks

import _torch_layer_gather as LG
from test_torch_ranks import layer_gather_memory, split_step

RUNS = [("gemma3-1b", n, remat, dtype)
        for remat, dtype in ((True, "float32"), (False, "float32"),
                             (False, "bfloat16"))
        for n in (2, 12)]
CASES = {"adafactor": ("gemma3-1b", {"optimizer": "adafactor",
                                     "logdet_reg": 0.05})}


@pytest.fixture(scope="module")
def memory():
    return run_ranks(layer_gather_memory, 4, backend="gloo", device="cpu",
                     timeout=600, args=("2x2", RUNS))


@pytest.mark.parametrize("remat,dtype", [(True, "float32"),
                                         (False, "float32"),
                                         (False, "bfloat16")])
def test_at_most_the_root_and_two_layer_units_are_whole(memory, remat,
                                                        dtype):
    for ranks in memory:
        for run, seen in zip(RUNS, ranks):
            if run[2:] != (remat, dtype):
                continue
            # the root once; each layer for its forward and again for its
            # backward (a saved whole, or its cast, is gathered again)
            assert seen["gathers"] == 1 + 2 * run[1], (run, seen)
            assert 1 <= seen["units"] <= 2, (run, seen)
            assert seen["root"], (run, seen)
            assert seen["grads_seen"] > 0, (run, seen)
            assert seen["grads_after"] == 0, (run, seen)
            assert seen["grads_at_end"] == 0, (run, seen)
        two, twelve = [s for run, s in zip(RUNS, ranks)
                       if run[2:] == (remat, dtype)]
        assert two["bytes"] == twelve["bytes"] > 0, (remat, two, twelve)
        assert np.isfinite([two["loss"], twelve["loss"]]).all()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return LG.run(tmp_path_factory.mktemp("layer_gather_adafactor"), CASES)


def test_adafactor_step_is_the_jax_meshs_step(runs):
    LG.check_against_jax(runs, "adafactor")
    LG.check_shared_bits(runs, "adafactor")
    LG.check_plan(runs, "adafactor")


def test_a_one_rank_mesh_step_is_the_single_device_step():
    """`layout.mesh_step` on a one-rank mesh gathers nothing and reduces
    nothing: its gradients, metrics and state after the step are bitwise
    `train.make_train_step`'s."""
    from repro_torch.configs import get_config
    from repro_torch.models.convert import from_jax_train_state
    from repro_torch.optim import OptConfig
    from repro_torch.sharding import layout
    from repro_torch.train import TrainConfig, make_train_step
    arch, kw = CASES["adafactor"][0], {"optimizer": "adamw",
                                       "logdet_reg": 0.05}
    cases = {"one": (arch, *LG._case(arch, kw), kw)}
    threads = torch.get_num_threads()
    try:
        mesh = split_step(None, "1x1", cases)["one"]
    finally:
        torch.set_num_threads(threads)
    assert mesh["counts"] == {"broadcast": 0, "all_sum": 0}
    _, np_state, batch, _ = cases["one"]
    cfg = get_config(arch, smoke=True).replace(dtype=torch.float32)
    tcfg = TrainConfig(opt=OptConfig(name="adamw"), logdet_reg=0.05)
    state = from_jax_train_state(np_state, cfg, tcfg, device="cpu")
    torch.set_num_threads(1)
    try:
        state, metrics = make_train_step(cfg, tcfg)(
            copy.deepcopy(state), {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
    finally:
        torch.set_num_threads(threads)
    assert mesh["metrics"] == {k: float(v) for k, v in metrics.items()}
    got = {".".join(p): t for p, t in layout.flat(state).items()}
    import hashlib
    for k, d in mesh["blocks"].items():
        want = hashlib.sha256(np.ascontiguousarray(
            got[k].detach().numpy()).data).hexdigest()
        assert d == want, k
