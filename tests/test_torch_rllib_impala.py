"""The port's IMPALA and APPO (ray_tpu_torch/rllib/impala.py, appo.py)
against the JAX package on the CPU: `vtrace` on off-policy log-probs
with episode ends and both clips active (1e-6); a fragment's V-trace
batch (`_to_batch`: the target log-probs from the learner's params);
one IMPALA learner step and one APPO step with the KL term to a target
network from the same params on the same batch (the loss within 1e-4,
the params within 1e-4 of each leaf's largest plus an Adam per-element
allowance); APPO's target copies every `target_update_freq` steps as
in JAX; the learner thread's exception re-raised by `train()`; the default
two runners as actors sampled by the remote branch, and the default
device refused without a card; a state round trip."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu.parallel.mesh  # noqa: F401  partitionable threefry first
from ray_tpu.rllib import appo as jappo
from ray_tpu.rllib import impala as jimpala
from ray_tpu.rllib import models as jmodels
from ray_tpu_torch import interop
from ray_tpu_torch.rllib import appo, impala
from tests.test_torch_rllib_learner import assert_params

TOL = 1e-4
VTRACE_TOL = 1e-6


@pytest.fixture
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _config(mod, **kw):
    cfg = (mod.APPOConfig() if hasattr(mod, "APPOConfig")
           else mod.IMPALAConfig())
    cfg = (cfg.environment("CartPole-v1")
           .env_runners(num_env_runners=0, num_envs_per_env_runner=3,
                        rollout_fragment_length=8)
           .training(**kw))
    if mod in (impala, appo):
        cfg.training(device="cpu")
    return cfg


@pytest.fixture
def pair(request):
    """(JAX algorithm, port algorithm) with the port's params copied
    from JAX's and its optimizer state fresh; both stopped after."""
    mod_j, mod_t, kw = request.param
    ref = _config(mod_j, **kw).build()
    ours = _config(mod_t, **kw).build()
    ours.params = interop.rl_params_from_jax(ref.params)[0]
    for p in jax.tree.leaves(ours.params):
        p.requires_grad_(True)
    ours.opt_state = ours.tx.init(ours.params)
    yield ref, ours
    ref.stop()
    ours.stop()


def _fragment(T=8, N=3, seed=0) -> dict:
    rng = np.random.RandomState(seed)
    return {
        "obs": rng.randn(T, N, 4).astype(np.float32),
        "actions": rng.randint(0, 2, (T, N)),
        "logp": np.log(rng.uniform(0.2, 0.8, (T, N))).astype(np.float32),
        "rewards": rng.rand(T, N).astype(np.float32),
        "values": rng.randn(T, N).astype(np.float32),
        "dones": rng.rand(T, N) < 0.2,
        "reset_mask": rng.rand(T, N) < 0.15,
        "last_values": rng.randn(N).astype(np.float32),
    }


def _batch(n=48, seed=1) -> dict:
    rng = np.random.RandomState(seed)
    return {
        "obs": rng.randn(n, 4).astype(np.float32),
        "actions": rng.randint(0, 2, n),
        "vs": rng.randn(n).astype(np.float32),
        "advantages": rng.randn(n).astype(np.float32),
        "logp_old": np.log(rng.uniform(0.2, 0.8, n)).astype(np.float32),
        "mask": (rng.rand(n) > 0.2).astype(np.float32),
    }


def _tensors(b: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def _jax(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}


def _weights(algo):
    return interop.rl_params_to_jax(algo.get_weights())


# ---------------------------------------------------------------- vtrace


@pytest.mark.parametrize("rho_clip,c_clip", [(1.0, 1.0), (0.8, 1.2)])
def test_vtrace_equals_jax(rho_clip, c_clip):
    T, N = 12, 5
    rng = np.random.RandomState(3)
    behavior = np.log(rng.uniform(0.1, 0.9, (T, N))).astype(np.float32)
    # off-policy: ratios on both sides of the clips
    target = (behavior + rng.randn(T, N) * 0.7).astype(np.float32)
    rewards = rng.randn(T, N).astype(np.float32)
    values = rng.randn(T, N).astype(np.float32)
    dones = rng.rand(T, N) < 0.2
    last = rng.randn(N).astype(np.float32)
    ratio = np.exp(target - behavior)
    assert (ratio > max(rho_clip, c_clip)).any() and (ratio < 1).any()
    args = (behavior, target, rewards, values, dones, last, 0.95)
    for got, want in zip(
            impala.vtrace(*args, rho_clip=rho_clip, c_clip=c_clip),
            jimpala.vtrace(*args, rho_clip=rho_clip, c_clip=c_clip)):
        np.testing.assert_allclose(got, want, rtol=0, atol=VTRACE_TOL)


@pytest.mark.parametrize("pair", [(jimpala, impala, {})], indirect=True)
def test_fragment_to_batch_equals_jax(pair):
    ref, ours = pair
    s = _fragment()
    want = ref._to_batch(s)
    got = ours._to_batch(s)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-5, err_msg=k)


# ---------------------------------------------------------------- updates


@pytest.mark.parametrize("pair", [(jimpala, impala, {})], indirect=True)
def test_impala_update_equals_jax(pair, two_threads):
    ref, ours = pair
    batch = _batch()
    jparams, _, jloss = ref._update(ref.params, ref.opt_state, _jax(batch))
    loss = ours._update(_tensors(batch))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL)
    assert_params(_weights(ours), jax.tree.map(np.asarray, jparams), TOL,
                  1e-2 * ours.config.lr, "impala")


@pytest.mark.parametrize(
    "pair", [(jappo, appo, {"use_kl_loss": True, "lr": 1e-3})],
    indirect=True)
def test_appo_step_with_kl_equals_jax(pair, two_threads):
    ref, ours = pair
    # a target that differs from the params, so the KL term is live
    target = jmodels.init_mlp_policy(jax.random.PRNGKey(9), 4, 2)
    ours.target_params = interop.rl_params_from_jax(target)[0]
    batch = _batch(seed=2)
    jparams, _, jloss = ref._appo_step(ref.params, ref.opt_state, target,
                                       _jax(batch))
    loss = ours._update(_tensors(batch))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL)
    assert_params(_weights(ours), jax.tree.map(np.asarray, jparams), TOL,
                  1e-2 * ours.config.lr, "appo")


@pytest.mark.parametrize(
    "pair", [(jappo, appo, {"target_update_freq": 2})], indirect=True)
def test_appo_target_syncs_equal_jax(pair, two_threads):
    ref, ours = pair
    params, opt = ref.params, ref.opt_state
    for i in range(5):
        batch = _batch(seed=10 + i)
        params, opt, _ = ref._update(params, opt, _jax(batch))
        ours._update(_tensors(batch))
    assert ours._appo_updates == ref._appo_updates == 5
    assert ours._target_syncs == 5 // 2
    # the target is the copy taken at step 4, in both
    assert_params(interop.rl_params_to_jax(ours.target_params),
                  jax.tree.map(np.asarray, ref.target_params), TOL,
                  1e-2 * ours.config.lr, "target")
    assert not np.allclose(_weights(ours)["pi"][0]["w"],
                           interop.rl_params_to_jax(
                               ours.target_params)["pi"][0]["w"])


# ---------------------------------------------------------------- driver


def test_learner_thread_error_reraised_by_train():
    algo = _config(impala).build()

    def broken(batch):
        raise ValueError("learner exploded")

    algo._update = broken
    try:
        with pytest.raises(RuntimeError, match="learner thread failed") as e:
            for _ in range(50):
                algo.train()
                algo.learner_thread.join(timeout=0.05)
        assert isinstance(e.value.__cause__, ValueError)
        assert algo.learner_thread.num_updates == 0
    finally:
        algo.stop()


def test_driver_iterations_feed_the_thread(two_threads):
    algo = _config(impala).build()
    try:
        for _ in range(4):
            r = algo.train()
        algo.learner_thread.stopped.set()
        algo.learner_thread.join(timeout=10)
        assert algo.learner_thread.num_updates >= 1
        assert np.isfinite(algo.learner_thread.last_loss)
        assert r["num_env_steps_sampled_lifetime"] == 4 * 3 * 8
        # the runner got the learner's weights at the last broadcast
        got = algo.env_runner_group.local.get_weights()
        assert set(got) == {"pi", "vf"}
    finally:
        algo.stop()


def test_state_round_trip(two_threads):
    a = _config(impala, seed=0).build()
    b = _config(impala, seed=5).build()
    try:
        a.train()
        # stop a's learner thread so that its weights hold still
        # between get_state and the comparison below
        a.learner_thread.stopped.set()
        a.learner_thread.join(timeout=10)
        b.set_state(a.get_state())
        for x, y in zip(jax.tree.leaves(_weights(a)),
                        jax.tree.leaves(_weights(b))):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(
            b.env_runner_group.local.get_weights()["pi"][0]["w"],
            _weights(a)["pi"][0]["w"])
    finally:
        a.stop()
        b.stop()


def test_remote_runners_and_missing_card_refused():
    """The default two runners are actors (here on the local runtime)
    that the remote branch samples asynchronously; without a card the
    default device is refused."""
    import ray_tpu_torch as ray

    ray.init(local_mode=True)
    try:
        algo = (impala.IMPALAConfig()
                .env_runners(num_envs_per_env_runner=2,
                             rollout_fragment_length=8)
                .training(device="cpu")).build()
        try:
            assert algo.env_runner_group.remote
            assert len(algo.env_runner_group.runners) == 2
            r = algo.train()
            assert r["num_env_steps_sampled_lifetime"] >= 2 * 8
            assert len(algo._inflight) == 2  # one sample in flight each
        finally:
            algo.stop()
    finally:
        ray.shutdown()
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        impala.IMPALAConfig().env_runners(num_env_runners=0).build()


def test_mlp_policy_interop_round_trip():
    jp = jmodels.init_mlp_policy(jax.random.PRNGKey(2), 4, 2, (16, 8))
    back = interop.rl_params_to_jax(interop.rl_params_from_jax(jp)[0])
    for x, y in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(x), y)


def test_readers_never_see_a_half_written_step():
    """The learner thread writes the params in place under the lock;
    the driver's reads (`get_weights`, `_to_batch`) take it too. With a
    step that adds 1 to each leaf in turn, yielding between leaves, and
    a short switch interval, every snapshot must hold one step count in
    all its leaves."""
    import sys
    import time

    from ray_tpu_torch.train.optim import GradientTransformation

    algo = _config(impala).build()

    def slow_step(grads, state, params):
        for p in jax.tree.leaves(params):
            with torch.no_grad():
                p.add_(1.0)
            time.sleep(0)  # let the driver's thread in mid-step
        return params, state

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with torch.no_grad():
            for p in jax.tree.leaves(algo.params):
                p.zero_()
        algo.tx = GradientTransformation(lambda p: None, slow_step)
        n = 40
        for i in range(n):
            algo._queue.put(_tensors(_batch(seed=i)))
        seen = set()
        deadline = time.monotonic() + 60
        while algo.learner_thread.num_updates < n and \
                time.monotonic() < deadline:
            leaves = jax.tree.leaves(algo.get_weights())
            steps = {float(x.flat[0]) for x in leaves}
            assert len(steps) == 1 and all(
                (x == x.flat[0]).all() for x in leaves), steps
            seen |= steps
            algo._to_batch(_fragment())
        assert algo.learner_thread.error is None
        assert algo.learner_thread.num_updates == n
        assert len(seen) > 2  # the reads overlapped the updates
    finally:
        sys.setswitchinterval(interval)
        algo.stop()
