"""The port's DreamerV3 (ray_tpu_torch/rllib/dreamerv3.py) against the
JAX package on the CPU, at the XS size, on CartPole-v1 (the symlog MLP
world model) and PixelCatch-v0 (the conv world model, uint8 pixels):
symlog, symexp, twohot and the GRU within 1e-6; `EpisodeSequenceBuffer`
drawing the same windows; from the same params (carried across by
``interop.rl_params_from_jax``) and with the Gumbel noise of JAX's
own keys (``jax.random.categorical`` is the argmax of logits plus
``jax.random.gumbel`` of its key), the world-model loss and its
metrics, the actor and critic losses over the dream, one whole update
(three Adam steps and the EMA critic) and one acting step within 1e-4
(params: of each leaf's largest, plus an Adam per-element allowance).
Then the Dreamer tree's interop round trip, a checkpoint round trip,
and six iterations in which the world model's loss falls below 0.8 of
its first."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu.parallel.mesh  # noqa: F401  partitionable threefry first
from ray_tpu.rllib import dreamerv3 as jdv3
from ray_tpu_torch import interop
from ray_tpu_torch.rllib import dreamerv3 as dv3
from tests.test_torch_rllib_learner import assert_params

TOL = 1e-4
EXACT = 1e-6
B, T, H = 4, 8, 5
ENVS = ["CartPole-v1", "PixelCatch-v0"]


@pytest.fixture
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def t_(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------- units


def test_symlog_symexp_twohot_exact(monkeypatch):
    # the bins: torch's and XLA's linspace round some of the 63 points
    # of [-20, 20] differently, by at most one float32 step at 20
    np.testing.assert_allclose(dv3.BINS.numpy(), np.asarray(jdv3.BINS),
                               rtol=0, atol=np.spacing(np.float32(20)))
    monkeypatch.setattr(dv3, "BINS", t_(jdv3.BINS))
    y = np.array([-1000.0, -7.3, -1.0, 0.0, 0.4, 3.0, 12.0, 2e8],
                 np.float32)
    for ours, ref in ((dv3.symlog, jdv3.symlog), (dv3.symexp, jdv3.symexp),
                      (dv3.twohot, jdv3.twohot)):
        np.testing.assert_allclose(ours(t_(y)).numpy(), np.asarray(ref(y)),
                                   rtol=EXACT, atol=EXACT)
    logits = np.random.RandomState(0).randn(5, dv3.NUM_BINS).astype(
        np.float32)
    # symexp's exp of values up to ~5 turns a float32 rounding of the
    # mean into ~1e-6 relative: held at 10x that
    np.testing.assert_allclose(dv3.twohot_mean(t_(logits)).numpy(),
                               np.asarray(jdv3.twohot_mean(logits)),
                               rtol=10 * EXACT, atol=EXACT)


def test_gru_exact():
    p = jdv3._gru_init(jax.random.PRNGKey(0), 6, 8)
    rng = np.random.RandomState(1)
    h = rng.randn(3, 8).astype(np.float32)
    x = rng.randn(3, 6).astype(np.float32)
    got = dv3._gru(interop.rl_params_from_jax(p)[0], t_(h), t_(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jdv3._gru(p, h, x)),
                               rtol=0, atol=EXACT)


def test_sequence_buffer_draws_equal_jax():
    bufs = [mod.EpisodeSequenceBuffer(40, num_envs=2, seed=3)
            for mod in (dv3, jdv3)]
    for t in range(30):
        step = {"obs": np.array([[t, 0], [t, 1]], np.float32),
                "first": np.array([t % 7 == 0, False], np.float32)}
        for b in bufs:
            b.add_step(step)
    assert len(bufs[0]) == len(bufs[1]) == 40
    for _ in range(3):
        got, want = (b.sample_sequences(4, 6) for b in bufs)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------- pairs


def _config(mod, env, **kw):
    cfg = mod.DreamerV3Config().environment(env).training(
        model_size="XS", training_ratio=8.0, batch_size_B=B,
        batch_length_T=T, horizon_H=H, num_envs=4,
        rollout_fragment_length=16, **{"seed": 0, **kw})
    if mod is dv3:
        cfg.training(device="cpu")
    return cfg


@pytest.fixture(scope="module", params=ENVS)
def pair(request):
    """(JAX algorithm, its jitted functions' closure, port algorithm
    with JAX's params)."""
    ref = _config(jdv3, request.param).build()
    ours = _config(dv3, request.param).build()
    _load(ours, ref)
    fn = ref._update.__wrapped__
    # jitted: one XLA compile each, in place of eager dispatch's many
    fns = {k: jax.jit(c.cell_contents) if k in ("wm_loss", "ac_losses")
           else c.cell_contents
           for k, c in zip(fn.__code__.co_freevars, fn.__closure__)}
    yield ref, fns, ours
    ref.stop()
    ours.stop()


def _load(ours, ref):
    tree, strides = interop.rl_params_from_jax(
        {"wm": ref.wm, "actor": ref.actor, "critic": ref.critic,
         "critic_ema": ref.critic_ema})
    assert strides == ours._strides
    for k, v in tree.items():
        setattr(ours, k, v)
    ours.wm_opt = ours.wm_tx.init(ours.wm)
    ours.actor_opt = ours.actor_tx.init(ours.actor)
    ours.critic_opt = ours.critic_tx.init(ours.critic)


def _batch(ours, seed=0) -> dict:
    rng = np.random.RandomState(seed)
    shape = ours._obs_shape
    obs = (rng.randint(0, 256, (B, T, *shape)).astype(np.uint8)
           if ours._image_obs else rng.randn(B, T, *shape).astype(np.float32))
    first = (rng.rand(B, T) < 0.15).astype(np.float32)
    first[:, 0] = 1.0
    return {"obs": obs, "actions": rng.randint(0, ours.n_actions, (B, T)),
            "rewards": rng.randn(B, T).astype(np.float32) * 3,
            "dones": (rng.rand(B, T) < 0.1).astype(np.float32),
            "first": first}


def _wm_noise(ours, key):
    keys = jax.random.split(key, T)
    return torch.stack([t_(jax.random.gumbel(k, (B, ours.n_cat, ours.n_cls)))
                        for k in keys])


def _img_noise(ours, key, S):
    acts, lats = [], []
    for k in jax.random.split(key, H):
        ka, kz = jax.random.split(k)
        acts.append(t_(jax.random.gumbel(ka, (S, ours.n_actions))))
        lats.append(t_(jax.random.gumbel(kz, (S, ours.n_cat, ours.n_cls))))
    return {"action": torch.stack(acts), "latent": torch.stack(lats)}


def _close(got, want, what, scale=None):
    want = np.asarray(want)
    atol = TOL * (np.abs(want).max() if scale is None else scale)
    np.testing.assert_allclose(np.asarray(got), want, rtol=TOL,
                               atol=max(atol, 1e-7), err_msg=what)


def test_world_model_loss_equals_jax(pair, two_threads):
    ref, fns, ours = pair
    batch = _batch(ours)
    key = jax.random.PRNGKey(5)
    jtotal, (jfeat, jm) = fns["wm_loss"](
        ref.wm, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    total, feat, m = ours.wm_loss(
        ours.wm, {k: t_(v) for k, v in batch.items()},
        _wm_noise(ours, key))
    _close(float(total), float(jtotal), "wm/total")
    for k in jm:
        _close(float(m[k]), float(jm[k]), k)
    _close(feat.detach().numpy(), jfeat, "feat")


def test_actor_critic_losses_equal_jax(pair, two_threads):
    ref, fns, ours = pair
    rng = np.random.RandomState(2)
    feat = rng.randn(B, T, ours.deter + ours.stoch).astype(np.float32)
    key = jax.random.PRNGKey(6)
    ja, jc, jm = fns["ac_losses"](ref.actor, ref.critic, ref.critic_ema,
                                  ref.wm, key, jnp.asarray(feat))
    la, lc, m = ours.ac_losses(ours.actor, ours.critic, ours.critic_ema,
                               ours.wm, t_(feat),
                               _img_noise(ours, key, B * T))
    _close(float(la), float(ja), "actor loss")
    _close(float(lc), float(jc), "critic loss")
    for k in jm:
        _close(float(m[k]), float(jm[k]), k)


def test_one_update_equals_jax(pair, two_threads):
    ref, _, ours = pair
    batch = _batch(ours, seed=4)
    key = jax.random.PRNGKey(7)
    kw, ka = jax.random.split(key)
    (wm, _, actor, _, critic, _, ema, jm) = ref._update(
        ref.wm, ref.wm_opt, ref.actor, ref.actor_opt, ref.critic,
        ref.critic_opt, ref.critic_ema,
        {k: jnp.asarray(v) for k, v in batch.items()}, key)
    noise = {"wm": _wm_noise(ours, kw), **_img_noise(ours, ka, B * T)}
    m = ours._update({k: t_(v) for k, v in batch.items()}, noise)
    assert sorted(m) == sorted(jm)
    for k in jm:
        _close(float(m[k]), float(jm[k]), k)
    got = interop.rl_params_to_jax(
        {"wm": ours.wm, "actor": ours.actor, "critic": ours.critic,
         "critic_ema": ours.critic_ema}, ours._strides)
    want = jax.tree.map(np.asarray, {"wm": wm, "actor": actor,
                                     "critic": critic, "critic_ema": ema})
    for k, lr in (("wm", ours.config.lr_world),
                  ("actor", ours.config.lr_actor),
                  ("critic", ours.config.lr_critic),
                  ("critic_ema", ours.config.lr_critic)):
        assert_params(got[k], want[k], TOL, 1e-2 * lr, k)
    _load(ours, ref)  # the next test starts from JAX's params again


def test_act_equals_jax(pair, two_threads):
    ref, _, ours = pair
    n = 4
    rng = np.random.RandomState(8)
    h = rng.randn(n, ours.deter).astype(np.float32)
    z = rng.randn(n, ours.stoch).astype(np.float32)
    obs = _batch(ours, seed=9)["obs"][:, 0].astype(np.float32)
    first = np.array([True, False, False, True])
    key = jax.random.PRNGKey(12)
    kz, ka = jax.random.split(key)
    ja, jh, jz = ref._act(ref.wm, ref.actor, key, h, z, obs, first)
    a, hh, zz = ours.act(
        t_(h), t_(z), t_(obs), t_(first),
        {"latent": t_(jax.random.gumbel(kz, (n, ours.n_cat, ours.n_cls))),
         "action": t_(jax.random.gumbel(ka, (n, ours.n_actions)))})
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    _close(zz.numpy(), jz, "z")
    _close(hh.numpy(), jh, "h")


def test_dreamer_tree_interop_round_trip(pair):
    ref, _, ours = pair
    jt = {"wm": ref.wm, "actor": ref.actor, "critic": ref.critic}
    tree, strides = interop.rl_params_from_jax(jt)
    back = interop.rl_params_to_jax(tree, strides)
    from tests.test_torch_rllib_modules import flat

    want, got = dict(flat(jt)), dict(flat(back))
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_array_equal(np.asarray(want[k]), got[k])
    if ours._image_obs:  # HWIO in JAX, OIHW in the port
        w = tree["wm"]["encoder"]["conv"][0]["w"]
        assert w.shape[0] == ref.wm["encoder"]["conv"][0].w.shape[-1]


# ---------------------------------------------------------------- driver


def test_checkpoint_round_trip(tmp_path, two_threads):
    a = _config(dv3, "CartPole-v1").build()
    b = _config(dv3, "CartPole-v1", seed=99).build()
    a.train()
    b.restore_from_path(a.save_to_path(str(tmp_path / "dv3")))
    for x, y in zip(jax.tree.leaves(a.get_weights()),
                    jax.tree.leaves(b.get_weights())):
        np.testing.assert_array_equal(x, y)
    r = b.train()  # the restored tensors take the next updates
    assert np.isfinite(r["wm/total"])
    a.stop()
    b.stop()


def test_world_model_fits(two_threads):
    """The JAX test's bar, at its recipe: the world model's total loss
    falls below 0.8 of its first within six iterations, every metric
    finite."""
    algo = _config(dv3, "CartPole-v1").build()
    first = last = None
    try:
        for _ in range(6):
            r = algo.train()
            if "wm/total" in r:
                first = r["wm/total"] if first is None else first
                last = r["wm/total"]
        assert first is not None and np.isfinite(last)
        assert last < first * 0.8, (first, last)
        for k in ("wm/decoder", "wm/reward", "wm/dyn", "wm/rep",
                  "actor/entropy", "critic/value", "imagined_return"):
            assert np.isfinite(r[k]), k
        assert r["num_steps_replayed"] > 0
    finally:
        algo.stop()


@pytest.mark.parametrize("who", ["ppo_learner", "dreamer_pixel"])
def test_conv_backward_runs_under_deterministic_cudnn(who, two_threads):
    """cuDNN reads its deterministic flag when a convolution's backward
    runs: the flag must be set when the conv weights' gradients are
    made, and restored after the update."""
    from ray_tpu_torch.rllib.learner import PPOLearner
    from tests.test_torch_rllib_learner import batch_for

    seen = []
    if who == "ppo_learner":
        algo = PPOLearner((10, 10, 2), 3, device="cpu")
        conv = algo.params["encoder"]["conv"][0]["w"]
        run = lambda: algo.update(batch_for((10, 10, 2), 64, 3))  # noqa
    else:
        algo = _config(dv3, "PixelCatch-v0").build()
        conv = algo.wm["encoder"]["conv"][0]["w"]
        conv.requires_grad_(True)
        batch = {k: t_(v) for k, v in _batch(algo).items()}
        run = lambda: algo._update(batch)  # noqa
    conv.register_hook(
        lambda g: seen.append(torch.backends.cudnn.deterministic))
    before = torch.backends.cudnn.deterministic
    run()
    assert seen and all(seen)
    assert torch.backends.cudnn.deterministic == before
