"""The port's mesh and sharding arithmetic (ray_tpu_torch.parallel.mesh,
parallel.sharding, the ZeRO layouts of train.spmd) against the JAX
package's on meshes of the same shape: (data=2, tensor=2),
(data=2, fsdp=2) and (data=4). The port computes on an AbstractMesh
(axis names and sizes, no process group), the JAX side on a Mesh over
four CPU devices, so this runs in one process. Then a one-rank gloo
group in this process: the DeviceMesh build_mesh makes there, and a
mesh step at world 1 (ZeRO stages 0 and 3) against the single-device
step, the shape of the chip run's mesh phase."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

import ray_tpu.parallel.mesh as jax_mesh
from ray_tpu.models import gpt2 as jax_gpt2
from ray_tpu.models import llama as jax_llama
from ray_tpu.parallel import sharding as jax_sharding
from ray_tpu.train import spmd as jax_spmd
from ray_tpu_torch import interop
from ray_tpu_torch.models import gpt2 as t_gpt2
from ray_tpu_torch.models import llama as t_llama
from ray_tpu_torch.parallel import mesh as t_mesh
from ray_tpu_torch.parallel import sharding as t_sharding
from ray_tpu_torch.train import optim as t_optim
from ray_tpu_torch.train import spmd as t_spmd

MESHES = {"data2-tensor2": {"data": 2, "tensor": 2},
          "data2-fsdp2": {"data": 2, "fsdp": 2},
          "data4": {"data": 4}}


@pytest.fixture(scope="module")
def jax_meshes():
    devices = jax.devices()[:4]
    return {k: jax_mesh.build_mesh(jax_mesh.MeshSpec(**v), devices=devices)
            for k, v in MESHES.items()}


def _abstract(name):
    """The port's mesh of the same shape: every axis, sizes resolved."""
    return t_mesh.AbstractMesh(
        t_mesh.MeshSpec(**MESHES[name]).resolve(4))


@pytest.fixture(scope="module")
def models():
    """(JAX params, port params, JAX rules, port rules) per model."""
    jcfg = dataclasses.replace(jax_gpt2.GPT2Config.tiny(), dtype=jnp.float32)
    jp = jax_gpt2.init_gpt2(jax.random.PRNGKey(0), jcfg)
    lp = jax_llama.init_llama(jax.random.PRNGKey(1),
                              jax_llama.LlamaConfig.tiny())
    return {"gpt2": (jp, interop.params_from_jax(jp),
                     jax_gpt2.gpt2_partition_rules(),
                     t_gpt2.gpt2_partition_rules()),
            "llama": (lp, interop.params_from_jax(lp),
                      jax_llama.llama_partition_rules(),
                      t_llama.llama_partition_rules())}


def _spec(s):
    return tuple(tuple(e) if isinstance(e, list) else e for e in s)


def _jax_specs(tree):
    """{path: spec} of a JAX tree of NamedShardings, the optimizer's
    chain index dropped from the path."""
    out = {}
    for path, sh in jax.tree_util.tree_flatten_with_path(tree)[0]:
        p = jax_sharding.path_str(path)
        out[p.split("/", 1)[1] if p[:1].isdigit() else p] = _spec(sh.spec)
    return out


def _port_specs(tree):
    out = {}

    def walk(obj, path):
        if isinstance(obj, t_sharding.NamedSharding):
            out["/".join(path)] = _spec(obj.spec)
        elif isinstance(obj, dict):
            for k, v in obj.items():
                walk(v, path + (k,))
        elif dataclasses.is_dataclass(obj):
            for f in dataclasses.fields(obj):
                walk(getattr(obj, f.name), path + (f.name,))

    walk(tree, ())
    return out


@pytest.mark.parametrize("kwargs,n", [
    ({}, 4), ({"data": 2, "tensor": 2}, 4), ({"data": -1, "fsdp": 2}, 8),
    ({"data": 1}, 1), ({"tensor": 4}, 8), ({"data": -1, "tensor": 3}, 4),
    ({"data": 2, "tensor": 2}, 8), ({"data": -1, "fsdp": -1}, 4)])
def test_mesh_spec_resolve_matches_jax(kwargs, n):
    def run(mod):
        try:
            return mod.MeshSpec(**kwargs).resolve(n)
        except ValueError as e:
            return f"ValueError: {e}"

    assert run(t_mesh) == run(jax_mesh)
    assert t_mesh.CANONICAL_AXIS_ORDER == jax_mesh.CANONICAL_AXIS_ORDER
    assert t_mesh.BATCH_AXES == jax_mesh.BATCH_AXES


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("model", ["gpt2", "llama"])
def test_spec_for_matches_jax(models, jax_meshes, model, mesh):
    jp, tp, jrules, trules = models[model]
    paths = [jax_sharding.path_str(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert len(paths) == len(list(t_spmd._state_leaves(tp)))
    for p in paths:
        assert _spec(trules.spec_for(p)) == _spec(jrules.spec_for(p)), p
        assert _spec(trules.spec_for(p, _abstract(mesh))) == _spec(
            jrules.spec_for(p, jax_meshes[mesh])), (p, mesh)


SPECS = [(), (None,), ("data",), ("tensor", None), (None, "fsdp", "tensor"),
         (("data", "fsdp"), None, "tensor"), (("tensor", "data"),),
         ("seq", "expert"), (("dcn", "data", "fsdp"), None)]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_prune_spec_matches_jax(jax_meshes, mesh):
    for s in SPECS:
        got = t_sharding._prune_spec(t_sharding.PartitionSpec(*s),
                                     _abstract(mesh))
        want = jax_sharding._prune_spec(jax.sharding.PartitionSpec(*s),
                                        jax_meshes[mesh])
        assert _spec(got) == _spec(want), (s, mesh)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("model", ["gpt2", "llama"])
def test_add_axis_to_spec_matches_jax(models, jax_meshes, model, mesh):
    jp, _, jrules, trules = models[model]
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        p = jax_sharding.path_str(path)
        for axis in ("data", "fsdp", "tensor"):
            got = t_sharding.add_axis_to_spec(
                trules.spec_for(p, _abstract(mesh)), leaf.shape,
                _abstract(mesh), axis)
            want = jax_sharding.add_axis_to_spec(
                jrules.spec_for(p, jax_meshes[mesh]), leaf.shape,
                jax_meshes[mesh], axis)
            assert _spec(got) == _spec(want), (p, axis, mesh)


OPTIMIZERS = {"sgd-momentum": (lambda: optax.sgd(0.05, momentum=0.9),
                               lambda: t_optim.sgd(0.05, momentum=0.9)),
              "adamw": (lambda: optax.adamw(1e-3), lambda: t_optim.adamw(1e-3))}


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("model", ["gpt2", "llama"])
def test_zero_shardings_match_jax(models, jax_meshes, model, mesh, stage):
    """Every component's layout at every rung (params, grads, and the
    optimizer state of sgd with momentum and of adamw), spec for spec."""
    jp, tp, jrules, trules = models[model]
    jm, am = jax_meshes[mesh], _abstract(mesh)
    for component in ("params", "grads"):
        want = _jax_specs(jax_spmd.zero_shardings(jrules, jp, jm, stage,
                                                  component))
        got = _port_specs(t_spmd.zero_shardings(trules, tp, am, stage,
                                                component))
        assert got == want, (component, stage)
    for name, (jtx, ttx) in OPTIMIZERS.items():
        want = _jax_specs(jax_spmd.zero_shardings(
            jrules, jtx().init(jp), jm, stage, "optimizer"))
        got = _port_specs(t_spmd.zero_shardings(
            trules, ttx().init(tp), am, stage, "optimizer"))
        # the port's step counts are host ints, with no layout
        want = {k: v for k, v in want.items() if not k.endswith("count")}
        assert got == want, (name, stage)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_and_state_shardings_match_jax(models, jax_meshes, mesh):
    jp, tp, jrules, trules = models["gpt2"]
    batch = {"tokens": np.zeros((8, 16), np.int32),
             "targets": np.zeros((8, 16), np.int32)}
    want = _jax_specs(jax_spmd.batch_shardings(jax_meshes[mesh], batch))
    got = _port_specs(t_spmd.batch_shardings(_abstract(mesh), batch))
    assert got == want
    jstate = jax_spmd.TrainState.create(jp, optax.sgd(0.1, momentum=0.9),
                                        grad_accum=True)
    tstate = t_spmd.TrainState.create(tp, t_optim.sgd(0.1, momentum=0.9),
                                      grad_accum=True)
    for stage in range(4):
        js = jax_spmd.state_shardings(jrules, jstate, jax_meshes[mesh],
                                      zero_stage=stage)
        ts = t_spmd.state_shardings(trules, tstate, _abstract(mesh),
                                    zero_stage=stage)
        for part in ("params", "opt_state", "grad_accum"):
            assert _port_specs(getattr(ts, part)) == _jax_specs(
                getattr(js, part)), (part, stage)
        assert _spec(ts.step.spec) == _spec(js.step.spec)


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard

    mesh = t_mesh.AbstractMesh({"data": 2, "fsdp": 2, "tensor": 2})
    P = t_sharding.PartitionSpec
    assert t_sharding.placements(P(), mesh) == (Replicate(),) * 3
    assert t_sharding.placements(P(None, "fsdp", "tensor"), mesh) == (
        Replicate(), Shard(1), Shard(2))
    assert t_sharding.placements(P(("data", "fsdp")), mesh) == (
        Shard(0), Shard(0), Replicate())
    # ("tensor", "data") on one dim: the same shards, split in mesh order
    assert t_sharding.placements(P(("tensor", "data")), mesh) == (
        Shard(0), Replicate(), Shard(0))
    with pytest.raises(ValueError, match="lacks"):
        t_sharding.placements(P("seq"), mesh)
    with pytest.raises(ValueError, match="two dims"):
        t_sharding.placements(P("data", "data"), mesh)


def test_constrain_leaves_plain_tensors_alone():
    x = torch.ones(2, 3)
    assert t_sharding.constrain(x, "data", None) is x
    with t_sharding.use_mesh(_abstract("data4")):
        assert t_sharding.constrain(x, "data", None) is x
    assert t_sharding.replicate_like(x, torch.zeros(1)) is x
    assert t_sharding._current_mesh() is None


def test_build_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="not initialised"):
        t_mesh.build_mesh(t_mesh.MeshSpec(data=1), device="cpu")
    assert t_mesh.slice_groups() == {0: [0]}


@pytest.fixture(scope="module")
def world1():
    """A one-rank gloo process group in this process, torn down after
    the module's tests; one intra-op thread meanwhile (the tiny steps'
    operators are too small to share, and test workers share the
    cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield t_mesh.build_mesh(t_mesh.MeshSpec(data=1), device="cpu")
    finally:
        dist.destroy_process_group()
        torch.set_num_threads(threads)


def test_world1_mesh_keeps_one_dim(world1):
    assert world1.mesh_dim_names == ("data",)
    assert tuple(world1.mesh.shape) == (1,)
    assert world1.device_type == "cpu"
    assert t_mesh.slice_groups() == {0: [0]}
    mesh = t_mesh.build_mesh({"tensor": 1, "data": 1}, device="cpu")
    assert mesh.mesh_dim_names == ("data",)


@pytest.mark.parametrize("stage", [0, 3])
@pytest.mark.parametrize("model", ["gpt2", "llama"])
def test_world1_mesh_step_equals_the_plain_step(models, world1, model,
                                                stage):
    """The chip's mesh phase at world 1, on the CPU: the same params and
    batches through the mesh step (DTensors, attention through
    local_map) and the plain step, loss and grad norm each step and the
    final params."""
    from torch.distributed.tensor import DTensor

    _, tp, _, trules = models[model]
    if model == "gpt2":
        cfg = dataclasses.replace(t_gpt2.GPT2Config.tiny(),
                                  dtype=torch.float32)

        def loss_fn(p, b):
            return t_gpt2.gpt2_loss(p, b, cfg)
    else:
        cfg = t_llama.LlamaConfig.tiny()

        def loss_fn(p, b):
            return t_llama.llama_loss(p, b, cfg)
    tx = t_optim.adamw(1e-3, weight_decay=0.1)

    def clone():
        return interop.params_from_jax(interop.params_to_numpy(tp))

    mstate = t_spmd.init_sharded_state(clone, tx, world1, trules,
                                       zero_stage=stage)
    assert isinstance(mstate.params["wte"], DTensor)
    mstep = t_spmd.make_train_step(loss_fn, tx, mesh=world1, rules=trules,
                                   zero_stage=stage)
    pstate = t_spmd.TrainState.create(clone(), tx)
    pstep = t_spmd.make_train_step(loss_fn, tx)
    rng = np.random.RandomState(5)
    for _ in range(3):
        toks = rng.randint(0, cfg.vocab_size, (2, 17)).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        mstate, mm = mstep(mstate, batch)
        pstate, pm = pstep(pstate, batch)
        assert not isinstance(mm["loss"], DTensor)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(mm[k]), float(pm[k]),
                                       rtol=1e-6, atol=1e-6)
    got = interop.params_to_numpy(mstate.params)
    want = interop.params_to_numpy(pstate.params)
    for path, g in _flat(got):
        np.testing.assert_allclose(g, dict(_flat(want))[path], atol=1e-6,
                                   err_msg=path)


@pytest.mark.parametrize("on_mesh", [True, False])
def test_step_refuses_a_state_laid_out_for_the_other_path(models, world1,
                                                          on_mesh):
    """`mesh=` decides whether the step runs on the mesh: a mesh step
    given plain params, or a plain step given DTensor params, raises
    instead of running the other path."""
    _, tp, _, trules = models["gpt2"]
    cfg = dataclasses.replace(t_gpt2.GPT2Config.tiny(), dtype=torch.float32)
    tx = t_optim.sgd(0.1)
    params = interop.params_from_jax(interop.params_to_numpy(tp))
    if on_mesh:
        state = t_spmd.TrainState.create(params, tx)
        kwargs, match = {"mesh": world1, "rules": trules}, "DTensors"
    else:
        state = t_spmd.init_sharded_state(lambda: params, tx, world1,
                                          trules)
        kwargs, match = {}, r"needs make_train_step\(mesh=\)"
    step = t_spmd.make_train_step(
        lambda p, b: t_gpt2.gpt2_loss(p, b, cfg), tx, **kwargs)
    toks = np.zeros((2, 17), np.int32)
    with pytest.raises(ValueError, match=match):
        step(state, {"tokens": toks[:, :-1], "targets": toks[:, 1:]})


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{path}/{k}")
    else:
        yield path, tree


@pytest.mark.parametrize("policy", ["full", "save_flash", "save_dots",
                                    "none"])
def test_world1_remat_policies_compose_with_the_mesh(models, world1,
                                                     monkeypatch, policy):
    """Each RAY_TPU_REMAT_POLICY under DTensor params: the same loss and
    grad norm as the plain step, and the same attention forwards a step
    (2 L under full, L otherwise: save_flash and save_dots keep the
    flash operator's outputs through local_map)."""
    from ray_tpu_torch.ops import flash_attention as t_flash

    monkeypatch.setenv("RAY_TPU_REMAT_POLICY", policy)
    calls = []
    plain = t_flash._fwd_plain
    monkeypatch.setattr(t_flash, "_fwd_plain",
                        lambda *a: calls.append(1) or plain(*a))
    _, tp, _, trules = models["gpt2"]
    cfg = dataclasses.replace(t_gpt2.GPT2Config.tiny(), dtype=torch.float32)
    tx = t_optim.sgd(0.1)
    toks = np.random.RandomState(6).randint(0, cfg.vocab_size, (2, 17))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    out = []
    for mesh in (world1, None):
        params = interop.params_from_jax(interop.params_to_numpy(tp))
        state = (t_spmd.init_sharded_state(lambda: params, tx, mesh, trules)
                 if mesh is not None else t_spmd.TrainState.create(params, tx))
        step = t_spmd.make_train_step(
            lambda p, b: t_gpt2.gpt2_loss(p, b, cfg), tx, mesh=mesh,
            rules=trules if mesh is not None else None)
        calls.clear()
        _, m = step(state, batch)
        out.append((float(m["loss"]), float(m["grad_norm"]), len(calls)))
    assert out[0][2] == out[1][2] == (2 if policy == "full" else 1) \
        * cfg.n_layer
    np.testing.assert_allclose(out[0][:2], out[1][:2], rtol=1e-6)


def test_init_sharded_state_sets_the_byte_gauges(models, world1):
    """The train_{optimizer,grad,param}_state_bytes gauges read the bytes
    the rank holds, tagged by the layout of the stage."""
    from ray_tpu_torch.util import metrics as t_metrics

    _, tp, _, trules = models["gpt2"]
    state = t_spmd.init_sharded_state(
        lambda: interop.params_from_jax(interop.params_to_numpy(tp)),
        t_optim.adamw(1e-3), world1, trules, zero_stage=3, accum_steps=2)
    gauges = {m.name: m for m in t_metrics._registry.collect()}
    for name, part, layout in (
            ("train_optimizer_state_bytes", state.opt_state, "zero1"),
            ("train_grad_state_bytes", state.grad_accum, "zero2"),
            ("train_param_state_bytes", state.params, "zero3")):
        assert gauges[name]._values[(layout,)] == \
            t_spmd.optimizer_state_bytes(part) > 0, name
