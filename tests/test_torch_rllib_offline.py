"""The port's offline RL (ray_tpu_torch/rllib/offline.py, cql.py) against
the JAX package on the CPU, both packages on their local runtimes: the
rows each package's recorder writes from one seed are equal (CartPole
through the env runner with one deterministic policy in both, Pendulum
from the uniform recorder); BC's and MARWIL's Monte-Carlo returns over
one recorded dataset are equal exactly; one BC and one MARWIL update
from the same params (``interop.rl_params_from_jax``) on the same batch
within 1e-4; one CQL update given JAX's own noise (the draws of its
split keys passed in as tensors) within 1e-4; OPE over a dataset
recorded and read back through the port's data layer equals JAX's
estimate over the same rows; and a GPT-2-tiny train step fed by the
data layer (jsonl, seeded shuffle, map_batches, iter_torch_batches)
equals the step fed the JAX pipeline's numpy batches directly."""

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu.parallel.mesh  # noqa: F401  partitionable threefry first
import ray_tpu_torch
from ray_tpu_torch import interop
from tests.test_torch_rllib_learner import assert_params

TOL = 1e-4
HIDDEN = (32, 32)


@pytest.fixture
def runtimes():
    """Both packages' local runtimes, for the duration of a test."""
    ray_tpu.init(local_mode=True, num_cpus=4)
    ray_tpu_torch.init(local_mode=True, num_cpus=4)
    try:
        yield
    finally:
        ray_tpu_torch.shutdown()
        ray_tpu.shutdown()


@pytest.fixture
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _policy_action(obs):
    """A deterministic CartPole controller: push toward the pole's fall."""
    obs = np.asarray(obs, np.float32)
    return (obs[:, 2] + 0.5 * obs[:, 3] > 0).astype(np.int64)


@pytest.fixture
def deterministic_runners(monkeypatch):
    """Both packages' env runners act by `_policy_action` (logp log 0.5,
    value 0), so the same seed walks the same env stream."""
    from ray_tpu.rllib import env_runner as jrunner
    from ray_tpu_torch.rllib import env_runner as prunner

    def act(obs):
        a = _policy_action(obs)
        return a, np.full(len(a), np.log(0.5), np.float32), \
            np.zeros(len(a), np.float32)

    init = jrunner.SingleAgentEnvRunner.__init__

    def jinit(self, *args, **kw):
        init(self, *args, **kw)
        self._sample_fn = lambda params, obs, key: act(obs)

    monkeypatch.setattr(jrunner.SingleAgentEnvRunner, "__init__", jinit)
    monkeypatch.setattr(prunner.SingleAgentEnvRunner, "_explore",
                        lambda self, obs: act(obs))


# ------------------------------------------------------------- recorders


def test_cartpole_rows_equal(tmp_path, runtimes, deterministic_runners):
    from ray_tpu.rllib.offline import record_experiences as jrecord
    from ray_tpu_torch.rllib.offline import (load_offline_dataset,
                                             record_experiences)

    jpaths = jrecord("CartPole-v1", 6, str(tmp_path / "jax"), seed=3)
    paths = record_experiences("CartPole-v1", 6, str(tmp_path / "port"),
                               seed=3, device="cpu")
    assert len(paths) == len(jpaths) == 8
    for a, b in zip(paths, jpaths):
        assert open(a).read() == open(b).read()
    rows = load_offline_dataset(str(tmp_path / "port")).take_all()
    assert len(rows) > 100 and any(r["done"] for r in rows)
    assert any(r["truncated"] for r in rows)


def test_pendulum_rows_equal(tmp_path, runtimes):
    from ray_tpu.rllib.cql import record_continuous_experiences as jrecord
    from ray_tpu_torch.rllib.cql import record_continuous_experiences
    from ray_tpu_torch.rllib.offline import load_offline_dataset

    jpaths = jrecord("Pendulum-v1", 600, str(tmp_path / "jax"), seed=3)
    paths = record_continuous_experiences("Pendulum-v1", 600,
                                          str(tmp_path / "port"), seed=3)
    for a, b in zip(paths, jpaths, strict=True):
        assert open(a).read() == open(b).read()
    rows = load_offline_dataset(str(tmp_path / "port")).take_all()
    assert len(rows) == 600
    # three 200-step episodes: the reset after each truncation is taken
    assert rows[200]["obs"] != rows[199]["next_obs"]


# ------------------------------------------------------------- BC, MARWIL


@pytest.fixture
def cartpole_dataset(tmp_path, runtimes, deterministic_runners):
    from ray_tpu_torch.rllib.offline import record_experiences

    out = str(tmp_path / "exp")
    record_experiences("CartPole-v1", 6, out, seed=5, device="cpu")
    return out


def _bc_pair(out, marwil: bool):
    from ray_tpu.rllib import offline as joffline
    from ray_tpu_torch.rllib import offline

    jcfg = (joffline.MARWILConfig() if marwil else joffline.BCConfig())
    cfg = (offline.MARWILConfig() if marwil else offline.BCConfig())
    ref = jcfg.offline_data(out).training(hidden=HIDDEN, lr=1e-3).build()
    ours = cfg.offline_data(out).training(hidden=HIDDEN, lr=1e-3,
                                          device="cpu").build()
    return ref, ours


@pytest.mark.parametrize("marwil", [False, True], ids=["bc", "marwil"])
def test_bc_update_equals_jax(cartpole_dataset, marwil, two_threads):
    import jax
    import jax.numpy as jnp

    ref, ours = _bc_pair(cartpole_dataset, marwil)
    # the same rows, the same Monte-Carlo returns, exactly
    for k in ("obs", "actions", "returns"):
        np.testing.assert_array_equal(ours._data[k].numpy(),
                                      ref._data[k], err_msg=k)
    ours.params = interop.rl_params_from_jax(ref.params)[0]
    ours.opt_state = ours.tx.init(ours.params)
    idx = np.random.RandomState(0).permutation(len(ref._data["actions"]))
    idx = idx[:ours.config.train_batch_size]
    params, _, jloss = ref._update(
        ref.params, ref.opt_state,
        {k: jnp.asarray(v[idx]) for k, v in ref._data.items()})
    loss = ours._update({k: v[torch.from_numpy(idx)]
                         for k, v in ours._data.items()})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL)
    assert_params(interop.rl_params_to_jax(ours.params),
                  jax.tree.map(np.asarray, params), TOL,
                  1e-2 * ours.config.lr, "marwil" if marwil else "bc")
    ref.stop()
    ours.stop()


def test_bc_trains_and_evaluates(cartpole_dataset):
    """A few iterations on the CPU: the loss falls, the iteration's
    metrics are the JAX package's, and the greedy evaluation runs on the
    port's CartPole."""
    from ray_tpu_torch.rllib.offline import BCConfig

    algo = (BCConfig().offline_data(cartpole_dataset)
            .training(hidden=HIDDEN, lr=3e-3, device="cpu").build())
    losses = [algo.train()["learner/loss"] for _ in range(5)]
    assert losses[-1] < losses[0]
    ev = algo.evaluate("CartPole-v1", num_episodes=2)
    assert ev["num_episodes"] == 2 and ev["episode_return_mean"] > 0
    w = algo.get_weights()
    assert w["pi"][0]["w"].shape == (4, HIDDEN[0])
    algo.stop()


def test_bc_default_device_is_the_card(cartpole_dataset):
    from ray_tpu_torch.rllib.offline import BCConfig

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default is taken")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BCConfig().offline_data(cartpole_dataset).build()


# ------------------------------------------------------------------ CQL


@pytest.fixture
def pendulum_dataset(tmp_path, runtimes):
    from ray_tpu_torch.rllib.cql import record_continuous_experiences

    out = str(tmp_path / "pendulum")
    record_continuous_experiences("Pendulum-v1", 600, out, seed=3)
    return out


def _cql_config(mod, out, **kw):
    cfg = (mod.CQLConfig().offline_data(out).environment("Pendulum-v1")
           .training(hidden=HIDDEN, train_batch_size=64, lr=1e-3,
                     updates_per_iteration=4, **kw))
    if mod.__name__.startswith("ray_tpu_torch"):
        cfg.training(device="cpu")
    return cfg


def test_cql_update_equals_jax(pendulum_dataset, two_threads):
    """One whole CQL update (critic with the conservative term, actor,
    temperature, Polyak targets) from the same params on the same batch,
    given the draws of JAX's split keys."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.rllib import cql as jcql
    from ray_tpu_torch.rllib import cql

    ref = _cql_config(jcql, pendulum_dataset, cql_alpha=5.0).build()
    ours = _cql_config(cql, pendulum_dataset, cql_alpha=5.0).build()
    for k in ("obs", "actions", "rewards", "next_obs", "dones"):
        np.testing.assert_array_equal(ours._data[k].numpy(),
                                      ref._data[k], err_msg=k)
    ref.log_alpha = jnp.asarray(-0.3, jnp.float32)
    ref.alpha_opt = ref.alpha_tx.init(ref.log_alpha)
    ours.params = interop.rl_params_from_jax(ref.params)[0]
    ours.target_q = interop.rl_params_from_jax(ref.target_q)[0]
    ours.log_alpha = torch.tensor(-0.3)
    ours.opt_state = ours.tx.init(ours.params)
    ours.alpha_opt = ours.alpha_tx.init(ours.log_alpha)

    idx = np.random.RandomState(0).randint(0, 600, 64)
    B, A, N = 64, 1, ours.config.n_action_samples
    key = jax.random.PRNGKey(11)
    kc, ka = jax.random.split(key)
    kn, kr, kp, kp2 = jax.random.split(kc, 4)
    draws = {
        "eps_next": jax.random.normal(kn, (B, A)),
        "rand_a": jax.random.uniform(kr, (B, N, A), minval=-1.0,
                                     maxval=1.0),
        "eps_pol": jax.random.normal(kp, (B * N, A)),
        "eps_nxt": jax.random.normal(kp2, (B * N, A)),
        "eps_actor": jax.random.normal(ka, (B, A)),
    }
    (jparams, _, jtarget, jlog_alpha, _, jbell, jgap, jal) = ref._update(
        ref.params, ref.opt_state, ref.target_q, ref.log_alpha,
        ref.alpha_opt, {k: jnp.asarray(v[idx]) for k, v in
                        ref._data.items()}, key)
    bell, gap, al = ours._update(
        {k: v[torch.from_numpy(idx)] for k, v in ours._data.items()},
        **{k: torch.from_numpy(np.array(v)) for k, v in draws.items()})
    for got, want in ((bell, jbell), (gap, jgap), (al, jal)):
        np.testing.assert_allclose(float(got), float(want), rtol=TOL,
                                   atol=TOL * 1e-2)
    allowance = 1e-2 * ours.config.lr
    assert_params(interop.rl_params_to_jax(ours.params),
                  jax.tree.map(np.asarray, jparams), TOL, allowance, "cql")
    assert_params(interop.rl_params_to_jax(ours.target_q),
                  jax.tree.map(np.asarray, jtarget), TOL, allowance,
                  "target")
    np.testing.assert_allclose(float(ours.log_alpha), float(jlog_alpha),
                               rtol=0, atol=TOL)
    ref.stop()
    ours.stop()


def test_cql_conservative_property_and_metrics(pendulum_dataset,
                                               two_threads):
    """test_cql.py on the port, at its config: after 10 iterations at
    cql_alpha=10 the Bellman loss is finite and the dataset actions' Q is
    above random actions' (ood_gap > 0), by more than at cql_alpha=0; the
    four metrics are reported and the evaluation runs."""
    from ray_tpu_torch.rllib import cql

    def build(alpha):
        return (cql.CQLConfig().offline_data(pendulum_dataset)
                .environment("Pendulum-v1")
                .training(hidden=(64, 64), train_batch_size=128, lr=1e-3,
                          updates_per_iteration=32, cql_alpha=alpha,
                          seed=0, device="cpu")).build()

    gaps = {}
    for alpha in (10.0, 0.0):
        algo = build(alpha)
        for _ in range(10):
            r = algo.train()
        for k in ("learner/bellman_loss", "learner/conservative_gap",
                  "learner/actor_loss", "alpha"):
            assert k in r, f"missing metric {k}"
        assert np.isfinite(r["learner/bellman_loss"])
        gaps[alpha] = algo.ood_gap()
        if alpha:
            ev = algo.evaluate(num_episodes=1)
            assert np.isfinite(ev["episode_return_mean"])
        algo.stop()
    assert gaps[10.0] > 0.0, gaps
    assert gaps[10.0] > gaps[0.0], gaps


# ------------------------------------------------------------------ OPE


def test_ope_over_a_recorded_dataset_equals_jax(tmp_path, runtimes):
    """test_ope.py's end-to-end case on the local runtimes: rows the
    port's recorder writes (its own seeded random policy) read back
    through the port's data layer; JAX's estimators over the same rows
    with the same target params agree."""
    import jax

    from ray_tpu.rllib import models as jmodels
    from ray_tpu.rllib import ope as jope
    from ray_tpu_torch.rllib import ope
    from ray_tpu_torch.rllib.offline import (load_offline_dataset,
                                             record_experiences)

    out = str(tmp_path / "exp")
    record_experiences("CartPole-v1", num_episodes=4, out_dir=out, seed=3,
                       device="cpu")
    rows = load_offline_dataset(out).take_all()
    policy = jmodels.init_mlp_policy(jax.random.PRNGKey(1), 4, 2, (16,))
    host = jax.tree.map(np.array, policy)
    for name in ("ImportanceSampling", "WeightedImportanceSampling",
                 "DoublyRobust"):
        want = getattr(jope, name)(policy, gamma=0.99).estimate(rows)
        got = getattr(ope, name)(host, gamma=0.99,
                                 device="cpu").estimate(rows)
        assert got["num_episodes"] == want["num_episodes"] >= 4
        for k in ("v_target", "v_behavior"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       err_msg=f"{name} {k}")
        if name == "ImportanceSampling":
            assert np.isfinite(got["v_target"]) and got["v_behavior"] > 0


# ------------------------------------------------------ data-fed training


def test_data_fed_gpt2_tiny_step_equals_direct(tmp_path, runtimes):
    """The chip phase's pipeline on the CPU at GPT-2-tiny's size: token
    rows written as jsonl, read back, shuffled with a seed, split into
    inputs and targets by map_batches and fed by iter_torch_batches. The
    batches equal the JAX pipeline's numpy batches (same order), and the
    steps fed them directly give the same losses, bit for bit."""
    import dataclasses

    import ray_tpu.data as jrd
    import ray_tpu_torch.data as rd
    from ray_tpu_torch.data import lineio
    from ray_tpu_torch.models.gpt2 import GPT2Config, gpt2_loss, init_gpt2
    from ray_tpu_torch.train import TrainState, adamw, make_train_step

    cfg = dataclasses.replace(GPT2Config.tiny(), dtype=torch.float32)
    B, T, steps = 4, 32, 3
    toks = np.random.RandomState(0).randint(0, cfg.vocab_size,
                                            (B * steps * 2, T + 1))

    def split(b):
        return {"tokens": b["tokens"][:, :-1], "targets": b["tokens"][:, 1:]}

    def pipeline(pkg, src):
        return (pkg.read_json(src).random_shuffle(seed=5)
                .map_batches(split))

    src = str(tmp_path / "tokens")
    rd.from_numpy({"tokens": toks}, parallelism=4).write_jsonl(src)
    assert lineio.native()
    fed = list(pipeline(rd, src).iter_torch_batches(batch_size=B,
                                                    device="cpu"))
    direct = list(pipeline(jrd, src).iter_batches(batch_size=B))
    assert len(fed) == len(direct) == 2 * steps
    for f, d in zip(fed, direct):
        for k in ("tokens", "targets"):
            assert f[k].dtype == torch.int64 and f[k].shape == (B, T)
            np.testing.assert_array_equal(f[k].numpy(), d[k])

    def run(batches):
        gen = torch.Generator().manual_seed(0)
        params = init_gpt2(gen, cfg, device="cpu")
        tx = adamw(1e-3, weight_decay=0.1)
        state = TrainState.create(params, tx)
        step = make_train_step(lambda p, b: gpt2_loss(p, b, cfg), tx)
        losses = []
        for b in batches[:steps]:
            state, m = step(state, b)
            losses.append(float(m["loss"]))
        return losses

    losses = run(fed)
    assert losses == run([{k: torch.from_numpy(v) for k, v in d.items()}
                          for d in direct])
    assert all(np.isfinite(losses))
