"""The port's sharding rules, meshes and elastic resharding
(`repro_torch.distributed.sharding` / `elastic`, `repro_torch.launch.mesh`)
against `repro.distributed.sharding` / `elastic`.

The specs must equal the JAX package's exactly, on the three duck-typed
meshes of tests/test_sharding.py (16 x 16, 2 x 16 x 16, 1 x 1).  The port
keeps a segment as a list of per-layer dicts where the JAX package stacks
it, so a per-layer leaf's spec is the JAX stacked leaf's without its
leading layer dim (which JAX never shards).  Full-size trees are built
abstractly on both sides: `jax.eval_shape` of the JAX init, the port's
init under `FakeTensorMode`.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree
from hypothesis import given, settings, strategies as st
from torch._subclasses.fake_tensor import FakeTensorMode

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.distributed import elastic as jelastic
from repro.distributed import sharding as jsh
from repro.models import lm as jlm
from repro_torch.distributed import elastic, sharding
from repro_torch.launch import mesh as tmesh
from repro_torch.models import lm as tlm
from repro_torch.optim import adamw_init


@dataclasses.dataclass(frozen=True)
class FakeMesh:
    """Duck-typed mesh: the rules touch only axis_names and shape."""

    shape: dict
    axis_names: tuple


MESHES = [
    FakeMesh({"data": 16, "model": 16}, ("data", "model")),
    FakeMesh({"pod": 2, "data": 16, "model": 16}, ("pod", "data", "model")),
    FakeMesh({"data": 1, "model": 1}, ("data", "model")),
]
AXES = ["data", "model", "pod", ("data",), ("pod", "data"), ("data", "model")]

dims = st.lists(st.sampled_from([0, 1, 2, 3, 4, 5, 16, 25, 40, 64, 128, 2048,
                                 32000, 122753]), min_size=0, max_size=4)
prefs = st.lists(st.tuples(st.integers(0, 4), st.sampled_from(AXES)),
                 max_size=8)


@given(dims, prefs, st.integers(0, 2))
@settings(max_examples=200, deadline=None)
def test_best_fit_matches_jax(shape, preferences, mesh_i):
    mesh = MESHES[mesh_i]
    want = jsh.best_fit(shape, mesh, preferences)
    assert sharding.best_fit(shape, mesh, preferences) == tuple(want)


@functools.cache
def _trees(arch: str, reduced: bool):
    """(JAX abstract params, the port's fake fp32 params) of `arch`."""
    jm = jlm.build(jconfigs.get(arch, reduced=reduced))
    jp = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    tm = tlm.build(tconfigs.get(arch, reduced=reduced))
    with FakeTensorMode():
        tp = tm.init(None, torch.float32, device="cpu")
    return jp, tp


def _key(k):
    return getattr(k, "key", getattr(k, "idx", getattr(k, "name", k)))


def _jax_spec(jspecs, path):
    """The JAX spec of the port's leaf at `path` (keys of the port's tree):
    the stacked leaf's spec without its layer dim for a per-layer leaf."""
    node, keys, layer = jspecs, [_key(k) for k in path], False
    for i, k in enumerate(keys):
        if isinstance(k, int) and isinstance(keys[i - 1], str) \
                and (keys[i - 1].startswith("seg") or keys[i - 1] == "encoder"):
            layer = True
            continue
        node = node[k]
    return tuple(node)[1:] if layer else tuple(node)


def _is_spec(x):
    return isinstance(x, jax.sharding.PartitionSpec)


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", jconfigs.all_archs())
def test_param_specs_match_jax(arch, reduced):
    jp, tp = _trees(arch, reduced)
    for mesh in MESHES:
        for fsdp in (False, True):
            jspecs = jsh.tree_specs(jp, mesh, "param", fsdp=fsdp)
            got = sharding.tree_specs(tp, mesh, "param", fsdp=fsdp)
            for path, spec in pytree.tree_flatten_with_path(
                    got, is_leaf=lambda x: isinstance(x, tuple))[0]:
                assert spec == _jax_spec(jspecs, path), (arch, path, mesh,
                                                         fsdp)
    # per-layer leaves were among them
    assert any(isinstance(_key(k), int)
               for path, _ in pytree.tree_flatten_with_path(tp)[0]
               for k in path)


def test_state_specs_carry_the_params_rules():
    """A train state's params, mu and nu get the params' specs; its step
    (an int) none."""
    _, tp = _trees("tinyllama-1.1b", True)
    state = adamw_init(tp)
    got = sharding.tree_specs(state, MESHES[0], "param", fsdp=True)
    want = sharding.tree_specs(tp, MESHES[0], "param", fsdp=True)
    assert got.params == want and got.mu == want and got.nu == want
    assert got.step == ()


@functools.cache
def _caches(arch: str, batch: int, seq: int):
    jm = jlm.build(jconfigs.get(arch, reduced=True))
    jc = jax.eval_shape(lambda: jm.init_cache(batch, seq))
    tm = tlm.build(tconfigs.get(arch, reduced=True))
    with FakeTensorMode():
        tc = tm.init_cache(batch, seq, "cpu")
    return jc, tc


@pytest.mark.parametrize("arch", jconfigs.all_archs())
def test_cache_specs_match_jax(arch):
    for batch, seq in ((1, 64), (32, 64), (16, 48)):
        jc, tc = _caches(arch, batch, seq)
        for mesh in MESHES:
            jspecs = jsh.tree_specs(jc, mesh, "cache")
            got = sharding.tree_specs(tc, mesh, "cache")
            leaves = pytree.tree_flatten_with_path(
                got, is_leaf=lambda x: isinstance(x, tuple))[0]
            assert leaves
            for path, spec in leaves:
                assert spec == _jax_spec(jspecs, path), (arch, path, mesh)


@pytest.mark.parametrize("shape", [(), (1,), (32,), (1, 4096), (256, 4096),
                                   (2, 1500, 64), (48, 7)])
def test_batch_spec_matches_jax(shape):
    for mesh in MESHES:
        want = jsh.batch_spec(jax.ShapeDtypeStruct(shape, np.int32), mesh)
        got = sharding.batch_spec(torch.empty(shape, dtype=torch.long), mesh)
        assert got == tuple(want), (shape, mesh)
    assert sharding.batch_spec(4095, MESHES[0]) == ()   # the decode index


def test_qwen3_heads_and_minicpm_vocab_fall_back():
    """Qwen3's 40 heads do not divide model = 16: its q projection puts
    the model axis on d_model; MiniCPM's 122,753-entry vocabulary does not
    either: its table puts it on d_model.  Both as in the JAX package."""
    mesh = MESHES[0]
    jp, tp = _trees("qwen3-14b", False)
    got = sharding.tree_specs(tp, mesh, "param")["seg0"][0]["attn"]["wq"]
    assert got == ("model", None, None)
    assert got == tuple(jsh.tree_specs(jp, mesh, "param")["seg0"]["attn"]
                        ["wq"])[1:]
    jp, tp = _trees("minicpm-2b", False)
    table = tp["embed"]["table"]
    assert table.shape[0] == 122753
    got = sharding.tree_specs(tp, mesh, "param")["embed"]["table"]
    assert got == (None, "model")
    assert got == tuple(jsh.tree_specs(jp, mesh, "param")["embed"]["table"])


@pytest.mark.parametrize("batch", [1, 15, 16, 32, 100, 256, 511, 512])
def test_rebalance_batch_matches_jax(batch):
    for mesh in MESHES + [tmesh.make_production_mesh(),
                          tmesh.make_production_mesh(multi_pod=True),
                          tmesh.make_host_mesh(device="cpu")]:
        assert elastic.rebalance_batch(batch, mesh) == \
            jelastic.rebalance_batch(batch, mesh)


def test_reshard_state_keeps_values():
    """As tests/test_system.py::test_elastic_reshard_preserves_values for
    the JAX package: params and a train state placed on the host mesh keep
    every value."""
    cfg = tconfigs.get("tinyllama-1.1b", reduced=True)
    params = tlm.build(cfg).init(torch.Generator().manual_seed(0))
    mesh = tmesh.make_host_mesh(device="cpu")
    moved = elastic.reshard_state(params, mesh)
    for a, b in zip(pytree.tree_leaves(params), pytree.tree_leaves(moved),
                    strict=True):
        assert b.device.type == "cpu" and torch.equal(a, b)
    state = elastic.reshard_state(adamw_init(params), mesh)
    assert state.step == 0
    assert torch.equal(state.params["embed"]["table"],
                       params["embed"]["table"])


def test_meshes():
    prod = tmesh.make_production_mesh()
    assert (prod.shape, prod.axis_names, prod.devices) == (
        {"data": 16, "model": 16}, ("data", "model"), ())
    multi = tmesh.make_production_mesh(multi_pod=True)
    assert (multi.shape, multi.axis_names) == (
        {"pod": 2, "data": 16, "model": 16}, ("pod", "data", "model"))
    host = tmesh.make_host_mesh(device="cpu")
    assert host.shape == {"data": 1, "model": 1}
    assert host.devices == (torch.device("cpu"),)
    assert sharding.dp_axes(multi) == jsh.dp_axes(MESHES[1])
    with pytest.raises(ValueError, match="one-device"):
        sharding.place({"x": torch.zeros(2)}, prod)


def test_host_mesh_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmesh.make_host_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sharding.sweep_mesh()


def test_sweep_mesh_and_activation_constraints_are_one_device():
    mesh = sharding.sweep_mesh(1, device="cpu")
    assert mesh.shape == {"sweep": 1} and sharding.sweep_mesh(
        None, device="cpu") == mesh
    assert sharding.sweep_chunk_spec() == ("sweep",) == tuple(
        jsh.sweep_chunk_spec())
    with pytest.raises(ValueError, match="one device"):
        sharding.sweep_mesh(2, device="cpu")
    x = torch.randn(2, 3, 4)
    sharding.enable_activation_sharding(tmesh.make_host_mesh(device="cpu"),
                                        seq_parallel=True)
    try:
        for kind in ("residual", "heads", "hidden", "logits"):
            assert sharding.constrain(x, kind) is x
        with pytest.raises(ValueError):
            sharding.constrain(x, "other")
    finally:
        sharding.enable_activation_sharding(None)
    with pytest.raises(ValueError, match="one-device"):
        sharding.enable_activation_sharding(tmesh.make_production_mesh())
