"""The port's PPO learner (ray_tpu_torch/rllib/learner.py) against the
JAX package's on the CPU: one `update` with num_sgd_iter=2 from the
same params (carried across by ``interop.rl_params_from_jax``) on the
same seeded batch, for the MLP towers and the conv actor-critic: the
four loss metrics within 1e-4 relative, the params within 1e-4 of each
leaf's largest plus an Adam per-element allowance.

Then four gloo ranks (test_torch_collectives.py's `run_ranks`, spawned
once for the module): ``PPOLearner(mesh=data 4)`` against the port's
single-device learner from the same params (the JAX package's
test_ppo_multi_learner_mesh_parity), one ``PPOConfig().learners(
num_learners=4)`` iteration leaving equal params on every rank, and
``num_learners`` other than the world size refused. The rank bodies
live here, so this module imports no jax at the top."""

import pickle

import numpy as np
import pytest
import torch

from tests.test_torch_collectives import run_ranks

TOL = 1e-4  # metrics relative; params of each leaf's largest
SAME_TOL = 1e-5  # the mesh against the port's own single-device learner
# Adam divides each grad by its root second moment, so f32 noise in a
# near-zero grad (the summation order) moves that element by a share of
# the learning rate: allowed per element on top of the leaf-relative
# tolerance, a hundredth of the learning rate (3e-4)
ADAM_ELEMENT_ATOL = 1e-2 * 3e-4
WORLD = 4


@pytest.fixture
def two_threads():
    """Train on two threads, leaving the other test workers their CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def batch_for(obs_spec, n: int, n_actions: int, seed: int = 0) -> dict:
    rng = np.random.RandomState(seed)
    shape = (obs_spec,) if isinstance(obs_spec, int) else tuple(obs_spec)
    return {
        "obs": rng.rand(n, *shape).astype(np.float32),
        "actions": rng.randint(0, n_actions, n),
        "logp_old": (rng.randn(n) * 0.1 - np.log(n_actions))
        .astype(np.float32),
        "advantages": rng.randn(n).astype(np.float32),
        "value_targets": rng.randn(n).astype(np.float32),
    }


def flat_leaves(t) -> list:
    """The leaves of a port or JAX RL tree by path (a JAX ConvLayer read
    by its attributes), as numpy."""
    from tests.test_torch_rllib_modules import flat

    return [(p, np.asarray(v)) for p, v in flat(t)]


def assert_params(got, want, rel, element_atol=0.0, what=""):
    g, w = flat_leaves(got), flat_leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        scale = max(np.abs(b).max(), 1e-30)
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=rel * scale + element_atol,
                                   err_msg=f"{what} {path}")


# ------------------------------------------------- one update against JAX


@pytest.mark.parametrize("obs_spec,n_actions", [(4, 2), ((10, 10, 2), 3)],
                         ids=["mlp", "conv"])
def test_update_equals_jax(obs_spec, n_actions, two_threads):
    import ray_tpu.parallel.mesh  # noqa: F401  partitionable threefry
    from ray_tpu.rllib.learner import PPOLearner as JaxLearner
    from ray_tpu.rllib.learner import PPOLearnerConfig as JaxConfig
    from ray_tpu_torch import interop
    from ray_tpu_torch.rllib.learner import PPOLearner, PPOLearnerConfig

    kw = dict(num_sgd_iter=2, minibatch_size=64, entropy_coeff=0.01)
    ref = JaxLearner(obs_spec, n_actions, JaxConfig(**kw), seed=0)
    ours = PPOLearner(obs_spec, n_actions, PPOLearnerConfig(**kw),
                      device="cpu")
    params, strides = interop.rl_params_from_jax(ref.get_weights())
    assert strides == ours.module.strides
    ours.set_weights(params)
    batch = batch_for(obs_spec, 200, n_actions)
    want = ref.update(dict(batch))
    got = ours.update(dict(batch))
    assert sorted(got) == sorted(want)
    for k in ("policy_loss", "vf_loss", "entropy", "mean_kl"):
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, err_msg=k)
    assert_params(interop.rl_params_to_jax(ours.get_weights(), strides),
                  ref.get_weights(), TOL, ADAM_ELEMENT_ATOL, "jax")


def test_learner_defaults_to_the_card():
    from ray_tpu_torch.rllib.learner import PPOLearner

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PPOLearner(4, 2)


def test_get_weights_are_host_copies():
    from ray_tpu_torch.rllib.learner import PPOLearner

    learner = PPOLearner(4, 2, device="cpu")
    w = learner.get_weights()
    assert isinstance(w["pi"][0]["w"], np.ndarray)
    before = w["pi"][0]["w"].copy()
    learner.update(batch_for(4, 128, 2))
    np.testing.assert_array_equal(w["pi"][0]["w"], before)
    learner.set_weights(w)
    np.testing.assert_array_equal(learner.get_weights()["pi"][0]["w"],
                                  before)


# ----------------------------------------------------------- gloo ranks


MESH_CASES = {
    # the JAX package's parity test: 64 rows, one minibatch, one epoch
    "mlp": dict(obs_spec=4, n_actions=2, n=64, num_sgd_iter=1,
                minibatch_size=64),
    # two epochs of two minibatches, the conv actor-critic
    "conv": dict(obs_spec=(10, 10, 2), n_actions=3, n=128, num_sgd_iter=2,
                 minibatch_size=64),
}


def _single(case, init):
    from ray_tpu_torch.rllib.learner import PPOLearner, PPOLearnerConfig

    c = MESH_CASES[case]
    cfg = PPOLearnerConfig(num_sgd_iter=c["num_sgd_iter"],
                           minibatch_size=c["minibatch_size"])
    learner = PPOLearner(c["obs_spec"], c["n_actions"], cfg, device="cpu")
    if init is not None:
        learner.set_weights(init)
    return learner, cfg


def _mesh_body(rank):
    """On each rank: every MESH_CASES learner on a data=4 mesh from the
    single learner's initial params, one PPO iteration at
    num_learners=4, and the refusal of num_learners=2."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu_torch.rllib import PPOConfig
    from ray_tpu_torch.rllib.learner import PPOLearner

    mesh = build_mesh(MeshSpec(data=WORLD), device="cpu")
    out = {"cases": {}}
    for case, c in MESH_CASES.items():
        single, cfg = _single(case, None)
        init = single.get_weights()
        learner = PPOLearner(c["obs_spec"], c["n_actions"], cfg, mesh=mesh)
        learner.set_weights(init)
        leaf = learner.params["vf"][0]["w"] if case == "mlp" else \
            learner.params["encoder"]["conv"][0]["w"]
        metrics = learner.update(batch_for(c["obs_spec"], c["n"],
                                           c["n_actions"]))
        out["cases"][case] = {"init": init, "metrics": metrics,
                              "params": learner.get_weights(),
                              "placements": str(leaf.placements)}
    algo = (PPOConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=0, num_envs_per_env_runner=4,
                         rollout_fragment_length=32)
            .training(num_sgd_iter=2, minibatch_size=64, device="cpu")
            .learners(num_learners=WORLD)).build()
    out["algo_mesh"] = dict(zip(algo.learner.mesh.mesh_dim_names,
                                algo.learner.mesh.mesh.shape))
    out["algo_result"] = algo.train()["num_env_steps_sampled"]
    out["algo_params"] = algo.get_weights()
    algo.stop()
    try:
        (PPOConfig().env_runners(num_env_runners=0)
         .training(device="cpu").learners(num_learners=2)).build()
    except ValueError as e:
        out["refusal"] = str(e)
    dist.barrier()
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(_mesh_body, tmp_path_factory.mktemp("ppo_mesh"),
                     world=WORLD)


@pytest.mark.parametrize("case", sorted(MESH_CASES))
def test_mesh_learner_equals_single(ranks, case, two_threads):
    """The data=4 mesh's update equals the single-device update from the
    same params within 1e-5 (the all-reduce-parity, DDP's guarantee),
    every rank's params equal, the params replicated."""
    c = MESH_CASES[case]
    got = ranks[0]["cases"][case]
    single, _ = _single(case, got["init"])
    want = single.update(batch_for(c["obs_spec"], c["n"], c["n_actions"]))
    for k, v in want.items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=SAME_TOL,
                                   atol=1e-7, err_msg=k)
    assert_params(got["params"], single.get_weights(), SAME_TOL,
                  what="mesh")
    for r in ranks[1:]:
        assert_params(r["cases"][case]["params"], got["params"], 0.0,
                      what="rank")
    assert got["placements"] == "(Replicate(),)"


def test_num_learners_iteration_leaves_equal_params(ranks):
    assert ranks[0]["algo_mesh"] == {"data": WORLD}
    assert ranks[0]["algo_result"] == 4 * 32
    for r in ranks[1:]:
        assert_params(r["algo_params"], ranks[0]["algo_params"], 0.0,
                      what="rank")
    before, _ = _single("mlp", None)
    moved = [np.abs(a - b).max() for (_, a), (_, b) in zip(
        flat_leaves(ranks[0]["algo_params"]),
        flat_leaves(before.get_weights()))]
    assert max(moved) > 0


def test_num_learners_other_than_the_world_refused(ranks):
    for r in ranks:
        assert "num_learners=2" in r["refusal"] and "4" in r["refusal"]


def test_learners_config_pickles():
    from ray_tpu_torch.rllib import PPOConfig

    cfg = (PPOConfig().environment("CartPole-v1")
           .env_runners(num_env_runners=0).learners(num_learners=4))
    back = pickle.loads(pickle.dumps(cfg))
    assert back.num_learners == 4 and back.learner_mesh is None
    assert back.to_dict() == cfg.to_dict()


def test_num_learners_without_a_process_group_refused():
    from ray_tpu_torch.rllib import PPOConfig

    with pytest.raises(ValueError, match="num_learners=2.*it has 1"):
        (PPOConfig().env_runners(num_env_runners=0)
         .training(device="cpu").learners(num_learners=2)).build()
