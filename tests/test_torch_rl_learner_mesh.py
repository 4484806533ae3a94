"""The port's GRPO learner on a mesh (``LLMLearner(mesh=)``: params laid
out by GPT-2's partition rules with `shard_pytree`, the step of
`make_train_step(mesh=, rules=)` at ZeRO stage 0, the batch sharded over
(data, fsdp)) on four gloo ranks of the CPU at (data=2, tensor=2),
against the JAX package's ``LLMLearner(mesh=)`` on a 4-device CPU mesh
of the same shape, in float32: one update's loss, grad norm and params,
`get_weights` gathering the whole tensors on every rank, and
`teacher_forced_logprobs` on the sharded params; and the same update of
the port's learner on one device, which the mesh must reproduce.

The ranks run in one spawn for the module (test_torch_collectives.py's
`run_ranks`); the JAX side runs in this process meanwhile. jax is
imported only inside the fixture, never on the ranks' import path."""

import dataclasses

import numpy as np
import pytest

from tests.test_torch_collectives import run_ranks

MESH = {"data": 2, "tensor": 2}
TOL = 1e-4  # loss and grad norm relative; params of the leaf's largest
SAME_TOL = 1e-5  # the mesh against the port's own single-device update
TF_ATOL = 1e-5
# Adam divides each grad by its root second moment, so f32 noise in a
# near-zero grad (the summation order) moves that element by a share of
# the learning rate: GPT-2's key bias has a zero gradient in exact
# arithmetic (softmax ignores a shift shared by every key), so after one
# step from zero it is noise scaled to ~1e-3 on both sides, 3e-7 apart.
# Allowed per element on top of the leaf-relative tolerance: a hundredth
# of the learning rate
ADAM_ELEMENT_ATOL = 1e-2 * 1e-3


def _trajectories(mod, vocab: int, seed: int = 0) -> list:
    """A fixed seeded list for either package's Trajectory (`mod` is
    ray_tpu.rllib.llm or ray_tpu_torch.rllib.llm): 3 groups of 4
    DigitSumTask prompts with 1-6 random tokens, versions 0-2 in turn
    and two stale ones, so updates at learner versions 0-2 keep some and
    drop some."""
    rng = np.random.RandomState(seed)
    task = mod.DigitSumTask()
    out = []
    for g in range(3):
        prompt = task.make_prompt(*rng.randint(0, 10, 2).tolist())
        for i in range(4):
            n = int(rng.randint(1, 7))
            v = (4 * g + i) % 3
            out.append(mod.Trajectory(
                prompt, rng.randint(0, vocab, n).tolist(),
                (-3.0 * rng.rand(n)).tolist(), float(rng.rand()), v, [v],
                (g, i) in ((0, 1), (2, 3)), g, 1.0))
    return out


def _port_cfg():
    import torch

    from ray_tpu_torch.models import gpt2

    return dataclasses.replace(gpt2.GPT2Config.tiny(), dtype=torch.float32)


def _update(learner, trajs) -> dict:
    m = learner.update(trajs)
    return {"loss": m["loss"], "grad_norm": m["grad_norm"],
            "kept": m["kept"], "version": m["version"],
            "params": learner.get_weights(),
            "tf": learner.teacher_forced_logprobs(trajs[0])}


def _rl_body(rank, init):
    """One update of the mesh learner and of a single-device one from
    the same params; rank 0's numpy results, with every rank's loss."""
    import torch.distributed as dist

    from ray_tpu_torch import interop
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu_torch.rllib import llm
    from ray_tpu_torch.train import spmd

    cfg = _port_cfg()
    trajs = _trajectories(llm, cfg.vocab_size)
    mesh = build_mesh(MeshSpec(**MESH), device="cpu")
    params = interop.params_from_jax(init)
    learner = llm.LLMLearner("gpt2", cfg, params=params, mesh=mesh)
    qkv = learner.state.params["blocks"]["attn_qkv"]["kernel"]
    out = {"mesh": _update(learner, trajs),
           "qkv_local": tuple(qkv.to_local().shape),
           "opt_bytes": spmd.optimizer_state_bytes(learner.state.opt_state),
           "param_bytes": spmd.optimizer_state_bytes(learner.state.params)}
    losses = [None] * dist.get_world_size()
    dist.all_gather_object(losses, out["mesh"]["loss"])
    out["losses"] = losses
    if rank == 0:
        plain = llm.LLMLearner("gpt2", cfg, params=params, device="cpu")
        out["plain"] = _update(plain, trajs)
    return out if rank == 0 else None


def _jax_update(init):
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt2
    from ray_tpu.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu.rllib import llm

    cfg = dataclasses.replace(gpt2.GPT2Config.tiny(), dtype=jnp.float32)
    mesh = build_mesh(MeshSpec(**MESH), devices=jax.devices()[:4])
    learner = llm.LLMLearner("gpt2", cfg, mesh=mesh, params=jax.tree.map(
        jnp.asarray, init))
    return _update(learner, _trajectories(llm, cfg.vocab_size))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    import ray_tpu.parallel.mesh  # noqa: F401 - threefry mode, first
    from ray_tpu.models import gpt2

    cfg = dataclasses.replace(gpt2.GPT2Config.tiny(),
                              dtype=jax.numpy.float32)
    init = jax.tree.map(np.asarray,
                        gpt2.init_gpt2(jax.random.PRNGKey(0), cfg))
    ranks, want = run_ranks(_rl_body, tmp_path_factory.mktemp("rl"), init,
                            meanwhile=lambda: _jax_update(init))
    return init, ranks[0], want


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, np.asarray(tree)


def _assert_params(got, want, rel, what, element_atol=0.0):
    pairs = list(zip(_leaves(got), _leaves(want)))
    assert len(pairs) == len(list(_leaves(want)))
    for (pg, g), (pw, w) in pairs:
        assert pg == pw and g.shape == w.shape, (what, pg)
        np.testing.assert_allclose(
            g, w, rtol=0, atol=max(rel * np.abs(w).max(), element_atol),
            err_msg=f"{what}{pg}")


@pytest.mark.parametrize("key", ["loss", "grad_norm"])
def test_mesh_update_metrics_match_jax(runs, key):
    _, port, want = runs
    np.testing.assert_allclose(port["mesh"][key], want[key], rtol=TOL)
    assert (port["mesh"]["kept"], port["mesh"]["version"]) == \
        (want["kept"], want["version"]) == (10, 1)


def test_mesh_update_params_match_jax(runs):
    init, port, want = runs
    _assert_params(port["mesh"]["params"], want["params"], TOL, "jax",
                   ADAM_ELEMENT_ATOL)
    moved = [np.abs(g - w).max() for (_, g), (_, w) in
             zip(_leaves(port["mesh"]["params"]), _leaves(init))]
    assert min(moved) > 0  # every leaf took the step


def test_mesh_teacher_forced_logprobs_match_jax(runs):
    _, port, want = runs
    np.testing.assert_allclose(port["mesh"]["tf"], want["tf"],
                               atol=TF_ATOL)


def test_mesh_update_equals_the_single_device_update(runs):
    _, port, _ = runs
    mesh, plain = port["mesh"], port["plain"]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(mesh[key], plain[key], rtol=SAME_TOL)
    _assert_params(mesh["params"], plain["params"], SAME_TOL, "plain",
                   ADAM_ELEMENT_ATOL)
    np.testing.assert_allclose(mesh["tf"], plain["tf"], atol=SAME_TOL)


def test_mesh_learner_lays_out_params_and_moments(runs):
    """attn_qkv/kernel (L, E, 3E) is P(None, fsdp, tensor): its columns
    split over the two tensor ranks; Adam's two moments inherit every
    param's layout (stage 0), so they hold twice the params' bytes; every
    rank reports the same loss."""
    _, port, _ = runs
    L, E = 2, 128
    assert port["qkv_local"] == (L, E, 3 * E // 2)
    assert port["opt_bytes"] == 2 * port["param_bytes"]
    assert len(set(port["losses"])) == 1
