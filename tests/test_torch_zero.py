"""The port's mesh training (ray_tpu_torch.train.spmd `make_train_step`
with mesh=, rules=, zero_stage= and accum_steps=, `init_sharded_state`)
on four gloo ranks of the CPU, against the JAX package's
`make_train_step` at the same ZeRO stage on a mesh of the same shape
over four CPU devices, in float32:

- GPT-2 tiny and Llama tiny on (data=2, tensor=2) at stages 0-3, and
  GPT-2 tiny on (data=2, fsdp=2) at stages 0 and 3, with
  sgd(0.05, momentum 0.9) for 4 steps: losses, grad norms and final
  params against JAX within TRAJ_TOL, and each stage against the
  port's own stage 0 within 1e-5 (the JAX ladder's own gate);
- adamw at stage 1, with the final params at ADAM_PARAM_ATOL;
- stage 2 with accum_steps=2;
- the bytes each rank holds of each component at <= 1.25/N of the
  replicated layout, and a stage-3 step's all_gathers outnumbering
  stage 0's (CommDebugMode's counts);
- the stage-0 mesh step against the port's single-device step;
- `init_sharded_state` laying out rank 0's values, and `constrain`
  holding in a remat block replayed on another thread;
- JAX params laid out with shard_pytree and gathered back.

The ranks run in one spawn for the module (test_torch_collectives.py's
`run_ranks`); the JAX side runs in this process meanwhile. jax is
imported only inside the fixtures, never on the ranks' import path."""

import dataclasses

import numpy as np
import pytest
import torch

from tests.test_torch_collectives import run_ranks

STEPS = 4
B, T = 4, 32
TRAJ_TOL = 1e-4
LADDER_TOL = 1e-5
ADAM_PARAM_ATOL = 1e-3  # as test_torch_gpt2_train.py
MESHES = {"tensor": {"data": 2, "tensor": 2}, "fsdp": {"data": 2, "fsdp": 2}}
N_DATA = 2
# (model, mesh, stage, optimizer, accum_steps)
CASES = ([("gpt2", "tensor", s, "sgd", 1) for s in range(4)]
         + [("llama", "tensor", s, "sgd", 1) for s in range(4)]
         + [("gpt2", "fsdp", s, "sgd", 1) for s in (0, 3)]
         + [("gpt2", "tensor", 1, "adamw", 1),
            ("gpt2", "tensor", 2, "sgd", 2)])


def _case_id(case):
    model, mesh, stage, opt, accum = case
    return f"{model}-{mesh}-zero{stage}-{opt}" + (
        f"-accum{accum}" if accum > 1 else "")


def _batches(vocab, n):
    out = []
    for s in range(n):
        rng = np.random.RandomState(20 + s)
        toks = rng.randint(0, vocab, (B, T + 1)).astype(np.int32)
        out.append({"tokens": toks[:, :-1], "targets": toks[:, 1:]})
    return out


def _port_model(model):
    from ray_tpu_torch.models import gpt2, llama

    if model == "gpt2":
        cfg = dataclasses.replace(gpt2.GPT2Config.tiny(),
                                  dtype=torch.float32)
        return (cfg, lambda p, b: gpt2.gpt2_loss(p, b, cfg),
                gpt2.gpt2_partition_rules())
    cfg = llama.LlamaConfig.tiny()
    return (cfg, lambda p, b: llama.llama_loss(p, b, cfg),
            llama.llama_partition_rules())


def _port_tx(opt):
    from ray_tpu_torch.train import optim

    if opt == "adamw":
        return optim.adamw(3e-3, weight_decay=0.1)
    return optim.sgd(0.05, momentum=0.9)


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    return np.array(tree)


def _zero_body(rank, init):
    """Every case on this rank; rank 0's numpy results are returned
    (the others' must agree, which the losses being replicated shows)."""
    from torch.distributed.tensor.debug import CommDebugMode

    from ray_tpu_torch import interop
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu_torch.parallel.ops import collective_op_counts
    from ray_tpu_torch.parallel.sharding import shard_pytree
    from ray_tpu_torch.train import spmd

    meshes = {k: build_mesh(MeshSpec(**v), device="cpu")
              for k, v in MESHES.items()}
    out = {}
    for case in CASES:
        model, mesh_name, stage, opt, accum = case
        mesh = meshes[mesh_name]
        cfg, loss_fn, rules = _port_model(model)
        tx = _port_tx(opt)
        state = spmd.init_sharded_state(
            lambda: interop.params_from_jax(init[model]), tx, mesh, rules,
            zero_stage=stage, accum_steps=accum)
        step = spmd.make_train_step(loss_fn, tx, mesh=mesh, rules=rules,
                                    zero_stage=stage, accum_steps=accum)
        traj = []
        for batch in _batches(cfg.vocab_size, STEPS * accum):
            state, m = step(state, batch)
            traj.append((float(m["loss"]), float(m["grad_norm"])))
        out[_case_id(case)] = {
            "traj": np.array(traj),
            # copied: a replicated leaf's numpy view would see the
            # in-place update of the counted step below
            "params": _copy(interop.params_to_numpy(state.params)),
            "step": state.step}
        if (model, mesh_name, opt, accum) == ("gpt2", "tensor", "sgd", 1) \
                and stage in (0, 3):
            with CommDebugMode() as comm:
                step(state, _batches(cfg.vocab_size, 1)[0])
            out[f"counts/zero{stage}"] = collective_op_counts(comm)

    # bytes this rank holds of each component, at the rung that shards
    # it and replicated
    cfg, loss_fn, rules = _port_model("gpt2")
    tx = _port_tx("adamw")
    mesh = meshes["tensor"]
    for stage in (0, 1, 2, 3):
        state = spmd.init_sharded_state(
            lambda: interop.params_from_jax(init["gpt2"]), tx, mesh, rules,
            zero_stage=stage, accum_steps=2)
        out[f"bytes/zero{stage}"] = {
            "optimizer": spmd.optimizer_state_bytes(state.opt_state),
            "grads": spmd.optimizer_state_bytes(state.grad_accum),
            "params": spmd.optimizer_state_bytes(state.params)}

    # init_sharded_state lays out rank 0's values, whatever the other
    # ranks' init_fn gives
    for stage in (0, 3):
        state = spmd.init_sharded_state(
            lambda: interop.params_from_jax(_shift(init["gpt2"], rank)),
            _port_tx("sgd"), mesh, rules, zero_stage=stage)
        got = interop.params_to_numpy(state.params)
        err = torch.tensor(max(
            np.abs(g - w).max() for (_, g), (_, w) in
            zip(_leaves(got), _leaves(init["gpt2"]))))
        torch.distributed.all_reduce(err, torch.distributed.ReduceOp.MAX)
        out[f"init_from_rank0/zero{stage}"] = float(err)
    out["remat_backward_on_a_thread"] = _remat_backward_on_a_thread(
        mesh, init["gpt2"])

    sharded = shard_pytree(interop.params_from_jax(init["gpt2"]), rules,
                           mesh)
    out["shard_pytree"] = {
        "params": interop.params_to_numpy(sharded),
        "qkv_local": tuple(sharded["blocks"]["attn_qkv"]["kernel"]
                           .to_local().shape)}
    return out if rank == 0 else None


def _shift(tree, d):
    if isinstance(tree, dict):
        return {k: _shift(v, d) for k, v in tree.items()}
    return np.asarray(tree) + np.float32(d)


def _remat_backward_on_a_thread(mesh, init):
    """GPT-2's loss on this thread and its gradient on another, as the
    autograd engine runs the backward of CUDA tensors: the remat blocks
    replay there, with no ambient mesh on either thread. Returns how
    many `constrain` calls each thread made, how many gave placements
    other than the spec's, and the largest difference between those
    grads and the grads of a backward on this thread."""
    import threading

    from ray_tpu_torch import interop
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.parallel.sharding import (PartitionSpec, _prune_spec,
                                                 placements)
    from ray_tpu_torch.train import spmd
    from ray_tpu_torch.util import tree

    cfg, loss_fn, rules = _port_model("gpt2")
    state = spmd.init_sharded_state(
        lambda: interop.params_from_jax(init), _port_tx("sgd"), mesh, rules)
    batch = spmd._shard_batch(_batches(cfg.vocab_size, 1)[0], mesh)
    inputs = [t.detach().requires_grad_() for t in tree.leaves(state.params)]
    calls = {"main": 0, "thread": 0, "wrong": 0}
    real = gpt2.constrain

    def spy(x, *spec):
        y = real(x, *spec)
        main = threading.current_thread() is threading.main_thread()
        calls["main" if main else "thread"] += 1
        want = placements(_prune_spec(PartitionSpec(*spec), mesh), mesh)
        calls["wrong"] += tuple(y.placements) != want
        return y

    def loss():
        return loss_fn(tree.unflatten(state.params, inputs), batch)

    gpt2.constrain = spy
    try:
        first, on_thread = loss(), {}
        worker = threading.Thread(target=lambda: on_thread.update(
            grads=torch.autograd.grad(first, inputs)))
        worker.start()
        worker.join()
        here = torch.autograd.grad(loss(), inputs)
    finally:
        gpt2.constrain = real
    calls["grad_diff"] = max(
        float((a.full_tensor() - b.full_tensor()).abs().max())
        for a, b in zip(on_thread["grads"], here))
    return calls


def _jax_parts(model):
    import jax.numpy as jnp

    from ray_tpu.models import gpt2 as jax_gpt2
    from ray_tpu.models import llama as jax_llama

    if model == "gpt2":
        cfg = dataclasses.replace(jax_gpt2.GPT2Config.tiny(),
                                  dtype=jnp.float32)
        return (cfg, lambda p, b: jax_gpt2.gpt2_loss(p, b, cfg),
                jax_gpt2.gpt2_partition_rules(),
                lambda key: jax_gpt2.init_gpt2(key, cfg))
    cfg = jax_llama.LlamaConfig.tiny()
    return (cfg, lambda p, b: jax_llama.llama_loss(p, b, cfg),
            jax_llama.llama_partition_rules(),
            lambda key: jax_llama.init_llama(key, cfg))


def _jax_runs(init):
    """The JAX package's step on a 4-device mesh for every case."""
    import jax
    import optax

    from ray_tpu.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu.train import spmd as jax_spmd

    devices = jax.devices()[:4]
    meshes = {k: build_mesh(MeshSpec(**v), devices=devices)
              for k, v in MESHES.items()}
    out = {}
    for case in CASES:
        model, mesh_name, stage, opt, accum = case
        mesh = meshes[mesh_name]
        cfg, loss_fn, rules, _ = _jax_parts(model)
        tx = (optax.adamw(3e-3, weight_decay=0.1) if opt == "adamw"
              else optax.sgd(0.05, momentum=0.9))
        params = jax.tree.map(jax.numpy.asarray, init[model])
        state = jax_spmd.init_sharded_state(
            lambda: params, tx, mesh, rules, zero_stage=stage,
            accum_steps=accum)
        step = jax_spmd.make_train_step(
            loss_fn, tx, donate=False, zero_stage=stage, mesh=mesh,
            rules=rules, accum_steps=accum)
        traj = []
        with mesh:
            for batch in _batches(cfg.vocab_size, STEPS * accum):
                batch = jax.device_put(
                    batch, jax_spmd.batch_shardings(mesh, batch))
                state, m = step(state, batch)
                traj.append((float(m["loss"]), float(m["grad_norm"])))
        out[_case_id(case)] = {
            "traj": np.array(traj),
            "params": jax.tree.map(np.asarray, state.params)}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    import ray_tpu.parallel.mesh  # noqa: F401 - threefry mode, first

    init = {m: jax.tree.map(np.asarray, _jax_parts(m)[3](
        jax.random.PRNGKey(0))) for m in ("gpt2", "llama")}
    ranks, jax_out = run_ranks(_zero_body, tmp_path_factory.mktemp("zero"),
                               init, meanwhile=lambda: _jax_runs(init))
    return init, ranks[0], jax_out


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, np.asarray(tree)


def _assert_trees(got, want, atol, what):
    pairs = list(zip(_leaves(got), _leaves(want)))
    assert len(pairs) == len(list(_leaves(want)))
    for (pg, g), (pw, w) in pairs:
        assert pg == pw and g.shape == w.shape, (what, pg, pw)
        np.testing.assert_allclose(g, w, atol=atol, err_msg=f"{what}{pg}")


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_mesh_step_matches_jax_at_the_same_stage(runs, case):
    _, port, jax_out = runs
    cid = _case_id(case)
    got, want = port[cid], jax_out[cid]
    np.testing.assert_allclose(got["traj"], want["traj"], atol=TRAJ_TOL,
                               rtol=TRAJ_TOL, err_msg=cid)
    assert got["step"] == STEPS * case[4]
    atol = ADAM_PARAM_ATOL if case[3] == "adamw" else TRAJ_TOL
    _assert_trees(got["params"], want["params"], atol, cid)


LADDER = [c for c in CASES if c[2] > 0 and c[3] == "sgd" and c[4] == 1]


@pytest.mark.parametrize("case", LADDER, ids=_case_id)
def test_each_stage_matches_its_own_stage0(runs, case):
    _, port, _ = runs
    got = port[_case_id(case)]
    base = port[_case_id((case[0], case[1], 0, "sgd", 1))]
    np.testing.assert_allclose(got["traj"], base["traj"], atol=LADDER_TOL,
                               rtol=LADDER_TOL)
    _assert_trees(got["params"], base["params"], LADDER_TOL,
                  _case_id(case))


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_params_move_in_place_at_every_stage(runs, stage):
    """The update reaches state.params: at stages 1-2 the gathered
    shards are copied back into the resident tensors."""
    init, port, _ = runs
    got = port[_case_id(("gpt2", "tensor", stage, "sgd", 1))]["params"]
    moved = [np.abs(g - w).max() for (_, g), (_, w) in
             zip(_leaves(got), _leaves(init["gpt2"]))]
    assert min(moved[i] for i, (p, _) in enumerate(_leaves(got))
               if "kernel" in p) > 0


@pytest.mark.parametrize("component,rung", [("optimizer", 1), ("grads", 2),
                                            ("params", 3)])
def test_state_bytes_shrink_per_rung(runs, component, rung):
    _, port, _ = runs
    full = port["bytes/zero0"][component]
    for stage in range(4):
        have = port[f"bytes/zero{stage}"][component]
        if stage >= rung:
            assert have <= 1.25 * full / N_DATA, (component, stage)
        else:
            assert have == full, (component, stage)


def test_zero3_step_carries_param_gathers(runs):
    _, port, _ = runs
    z0, z3 = port["counts/zero0"], port["counts/zero3"]
    assert z3.get("all_gather", 0) > z0.get("all_gather", 0), (z0, z3)


@pytest.mark.parametrize("model", ["gpt2", "llama"])
def test_stage0_mesh_step_equals_the_single_device_step(runs, model):
    from ray_tpu_torch import interop
    from ray_tpu_torch.train import spmd

    init, port, _ = runs
    cfg, loss_fn, _ = _port_model(model)
    tx = _port_tx("sgd")
    state = spmd.TrainState.create(interop.params_from_jax(init[model]), tx)
    step = spmd.make_train_step(loss_fn, tx)
    traj = []
    for batch in _batches(cfg.vocab_size, STEPS):
        state, m = step(state, batch)
        traj.append((float(m["loss"]), float(m["grad_norm"])))
    mesh = port[_case_id((model, "tensor", 0, "sgd", 1))]
    np.testing.assert_allclose(mesh["traj"], np.array(traj),
                               atol=LADDER_TOL, rtol=LADDER_TOL)
    _assert_trees(mesh["params"], interop.params_to_numpy(state.params),
                  LADDER_TOL, model)


@pytest.mark.parametrize("stage", [0, 3])
def test_init_sharded_state_lays_out_rank0s_values(runs, stage):
    """Each rank's init_fn gave params shifted by its rank; every rank
    holds rank 0's."""
    _, port, _ = runs
    assert port[f"init_from_rank0/zero{stage}"] == 0.0


def test_constrain_holds_in_a_backward_on_another_thread(runs):
    """The remat blocks' replay on the backward's own thread lays each
    activation out as its spec says, and gives the grads of a backward
    on the caller's thread."""
    _, port, _ = runs
    calls = port["remat_backward_on_a_thread"]
    assert calls["main"] > 0 and calls["thread"] > 0, calls
    assert calls["wrong"] == 0, calls
    assert calls["grad_diff"] <= 1e-6, calls


def test_shard_pytree_lays_out_jax_params_and_gathers_them_back(runs):
    init, port, _ = runs
    _assert_trees(port["shard_pytree"]["params"], init["gpt2"], 0.0,
                  "shard_pytree")
    # attn_qkv/kernel (L, E, 3E) is P(None, fsdp, tensor): columns split
    L, E = 2, 128
    assert port["shard_pytree"]["qkv_local"] == (L, E, 3 * E // 2)
