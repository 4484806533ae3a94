"""The classic RL stack's building blocks in the port against the JAX
package on the CPU: the connectors and GAE (equal on seeded inputs), the
catalog's encoders and the models' forwards on JAX weights carried
across by ``interop.rl_params_from_jax`` (within 1e-5 of the largest
logit or value; "SAME" padding with stride, including the odd totals
(0, 1) and (1, 2)), the RLModule's greedy and sampled actions, the
interop round trip, and ``util.tree`` over lists of layers (dict-only
trees flatten as before; `adam` and `clip_by_global_norm` update a list
tree as optax does)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ray_tpu.parallel.mesh  # noqa: F401  partitionable threefry first
from ray_tpu.rllib import catalog as jcat
from ray_tpu.rllib import connectors as jconn
from ray_tpu.rllib import models as jmodels
from ray_tpu.rllib import rl_module as jrlm
from ray_tpu.rllib.learner import compute_gae as jgae
from ray_tpu_torch import interop
from ray_tpu_torch.rllib import catalog, connectors, models, rl_module
from ray_tpu_torch.rllib.learner import compute_gae, normalize_advantages
from ray_tpu_torch.train import optim
from ray_tpu_torch.util import tree

FWD_TOL = 1e-5  # of the largest logit or value


def flat(t, path=""):
    """(path, leaf) pairs of a JAX or port RL tree in one order: dict
    keys sorted, list indices, a JAX ConvLayer read by its attributes
    (as the dict ``rl_params_to_jax`` gives)."""
    if isinstance(t, dict):
        for k in sorted(t):
            yield from flat(t[k], f"{path}/{k}")
    elif isinstance(t, (list, tuple)):
        for i, v in enumerate(t):
            yield from flat(v, f"{path}/{i}")
    elif all(hasattr(t, a) for a in ("w", "b", "stride")):
        yield from flat({"w": t.w, "b": t.b, "stride": t.stride}, path)
    else:
        yield path, t


def t_(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32))


# ------------------------------------------------------------ connectors


def _frames(rng, n, c):
    return rng.randint(0, 256, (n, 6, 5, c)).astype(np.uint8)


@pytest.mark.parametrize("channels", [1, 3])
def test_frame_stack_equals_jax(channels):
    """The frame-major stack, multichannel included, restarting the
    stacks of the envs whose previous step was done."""
    rng = np.random.RandomState(channels)
    ours, ref = connectors.FrameStack(3), jconn.FrameStack(3)
    for step in range(6):
        obs = _frames(rng, 4, channels)
        dones = None if step == 0 else rng.rand(4) < 0.4
        np.testing.assert_array_equal(ours(obs, dones), ref(obs, dones))
    assert ours.output_shape((6, 5, channels)) == \
        ref.output_shape((6, 5, channels))
    ours.reset(4)
    ref.reset(4)
    obs = _frames(rng, 4, channels)
    np.testing.assert_array_equal(ours(obs), ref(obs))


def test_frame_stack_restarts_done_lanes():
    fs = connectors.FrameStack(2)
    a = np.full((2, 1, 1, 1), 1, np.uint8)
    b = np.full((2, 1, 1, 1), 2, np.uint8)
    fs(a)
    out = fs(b, dones=np.array([True, False]))
    assert out[0].ravel().tolist() == [2, 2]  # restarted from the new frame
    assert out[1].ravel().tolist() == [1, 2]


@pytest.mark.parametrize("shape", [(5, 4), (3, 6, 5, 2)])
def test_normalize_and_flatten_equal_jax(shape):
    rng = np.random.RandomState(0)
    obs = rng.randint(0, 256, shape).astype(np.uint8)
    np.testing.assert_array_equal(connectors.NormalizeImage()(obs),
                                  jconn.NormalizeImage()(obs))
    np.testing.assert_array_equal(connectors.FlattenObs()(obs),
                                  jconn.FlattenObs()(obs))
    assert connectors.FlattenObs().output_shape(shape[1:]) == \
        jconn.FlattenObs().output_shape(shape[1:])


@pytest.mark.parametrize("obs_shape,framestack",
                         [((4,), 1), ((10, 10, 1), 1), ((10, 10, 1), 2)])
def test_default_env_to_module_equals_jax(obs_shape, framestack):
    ours = connectors.default_env_to_module(obs_shape, framestack)
    ref = jconn.default_env_to_module(obs_shape, framestack)
    assert [type(c).__name__ for c in ours.connectors] == \
        [type(c).__name__ for c in ref.connectors]
    assert ours.output_shape(obs_shape) == ref.output_shape(obs_shape)
    rng = np.random.RandomState(1)
    for step in range(3):
        obs = rng.randint(0, 256, (3, *obs_shape)).astype(np.uint8)
        dones = None if step == 0 else np.array([False, True, False])
        np.testing.assert_array_equal(ours(obs, dones), ref(obs, dones))


def test_gae_and_connector_equal_jax():
    rng = np.random.RandomState(0)
    T, N = 7, 3
    sample = {"rewards": rng.rand(T, N).astype(np.float32),
              "values": rng.randn(T, N).astype(np.float32),
              "dones": rng.rand(T, N) < 0.2,
              "last_values": rng.randn(N).astype(np.float32)}
    adv, tgt = compute_gae(sample["rewards"], sample["values"],
                           sample["dones"], sample["last_values"], 0.9, 0.8)
    jadv, jtgt = jgae(sample["rewards"], sample["values"], sample["dones"],
                      sample["last_values"], 0.9, 0.8)
    np.testing.assert_array_equal(adv, jadv)
    np.testing.assert_array_equal(tgt, jtgt)
    ours = connectors.GeneralAdvantageEstimation(0.99, 0.95)(sample)
    ref = jconn.GeneralAdvantageEstimation(0.99, 0.95)(sample)
    for k in ("advantages", "value_targets"):
        np.testing.assert_array_equal(ours[k], ref[k])


def test_advantages_normalised_with_the_population_std():
    """The learner's normalisation is numpy's ``(a - mean) / (std +
    1e-8)`` with ddof 0, as the JAX learner's; Bessel's correction would
    differ by a factor sqrt(n / (n - 1))."""
    a = np.random.RandomState(3).randn(9).astype(np.float32) * 4 + 1
    want = (a - a.mean()) / (a.std() + 1e-8)
    got = normalize_advantages(torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    bessel = (a - a.mean()) / (a.std(ddof=1) + 1e-8)
    assert np.abs(got - bessel).max() > 1e-2


# ---------------------------------------------------------------- models


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= FWD_TOL, f"{what}: {err} of the largest"


def test_mlp_towers_forward_equal_jax():
    jp = jmodels.init_mlp_policy(jax.random.PRNGKey(0), 4, 2, (64, 64))
    params, strides = interop.rl_params_from_jax(jp)
    assert strides == ()
    assert isinstance(params["pi"], list) and len(params["pi"]) == 3
    obs = np.random.RandomState(0).randn(16, 4).astype(np.float32)
    jl, jv = jmodels.forward(jp, obs)
    pl, pv = models.forward(params, t_(obs))
    _close(pl, jl, "logits")
    _close(pv, jv, "value")


def test_mlp_encoder_forward_equal_jax():
    jp, dim = jcat.init_mlp_encoder(jax.random.PRNGKey(1), 6, (32, 16))
    params, _ = interop.rl_params_from_jax(jp)
    obs = np.random.RandomState(1).randn(5, 6).astype(np.float32)
    _close(catalog.apply_mlp_encoder(params, t_(obs)),
           jcat.apply_mlp_encoder(jp, obs), "features")
    assert dim == 16


@pytest.mark.parametrize("size,k,s,want", [(10, 3, 2, (0, 1)),
                                           (21, 4, 2, (1, 2)),
                                           (84, 8, 4, (2, 2)),
                                           (11, 3, 1, (1, 1)),
                                           (5, 3, 2, (1, 1))])
def test_same_padding_is_xlas(size, k, s, want):
    assert catalog.same_padding(size, k, s) == want


@pytest.mark.parametrize("hw,c,k,s", [(10, 2, 3, 2), (21, 32, 4, 2)])
def test_one_conv_layer_equals_lax_same(hw, c, k, s):
    """One strided conv whose padding total is odd ((0, 1) at 10x10 k3
    s2, (1, 2) at the Atari stack's 21x21 k4 s2) against XLA's "SAME"."""
    rng = np.random.RandomState(hw)
    x = rng.randn(2, hw, hw, c).astype(np.float32)
    w = rng.randn(k, k, c, 8).astype(np.float32) * 0.1
    b = rng.randn(8).astype(np.float32)
    want = jax.nn.relu(jax.lax.conv_general_dilated(
        x, w, (s, s), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
        + b)
    want = np.asarray(want).reshape(2, -1)
    # an identity projection: the encoder's output is the flattened
    # (h, w, c) map itself (already >= 0 after the conv's relu)
    p = {"conv": [{"w": t_(w).permute(3, 2, 0, 1), "b": t_(b)}],
         "proj": {"w": torch.eye(want.shape[1]),
                  "b": torch.zeros(want.shape[1])}}
    got = catalog.apply_conv_encoder(p, t_(x), (s,))
    _close(got, want, "conv")


@pytest.mark.parametrize("obs_shape,filters", [
    ((10, 10, 2), jcat.SMALL_FILTERS), ((84, 84, 4), jcat.ATARI_FILTERS)])
def test_conv_encoder_forward_equals_jax(obs_shape, filters):
    jp, dim = jcat.init_conv_encoder(jax.random.PRNGKey(2), obs_shape,
                                     filters=filters)
    params, strides = interop.rl_params_from_jax(jp)
    assert strides == catalog.conv_strides(filters)
    assert [tuple(lyr["w"].shape) for lyr in params["conv"]] == \
        [(oc, ic, k, k) for (oc, k, _), ic in zip(
            filters, (obs_shape[2],) + tuple(f[0] for f in filters[:-1]))]
    obs = np.random.RandomState(2).rand(3, *obs_shape).astype(np.float32)
    _close(catalog.apply_conv_encoder(params, t_(obs), strides),
           jcat.apply_conv_encoder(jp, obs), "features")
    assert dim == 256


@pytest.mark.parametrize("obs_spec", [4, (10, 10, 2)])
def test_actor_critic_module_equals_jax(obs_spec):
    """Logits and values within 1e-5, greedy actions equal; the sampled
    actions' logp is log_softmax at them."""
    jm = jrlm.DefaultActorCriticModule(obs_spec, 3)
    pm = rl_module.DefaultActorCriticModule(obs_spec, 3, device="cpu")
    jp = jm.init(jax.random.PRNGKey(3))
    params, strides = interop.rl_params_from_jax(jp)
    assert strides == pm.strides
    shape = (obs_spec,) if isinstance(obs_spec, int) else obs_spec
    obs = np.random.RandomState(3).randn(32, *shape).astype(np.float32)
    jout = jm.forward_inference(jp, {"obs": jnp.asarray(obs)})
    pout = pm.forward_inference(params, {"obs": t_(obs)})
    _close(pout["action_dist_inputs"], jout["action_dist_inputs"], "logits")
    _close(pout["vf_preds"], jout["vf_preds"], "values")
    np.testing.assert_array_equal(pout["actions"].numpy(),
                                  np.asarray(jout["actions"]))
    gen = torch.Generator().manual_seed(0)
    a, logp, v = pm.explore(params, t_(obs), gen)
    want = torch.log_softmax(pout["action_dist_inputs"], -1).gather(
        1, a[:, None])[:, 0]
    torch.testing.assert_close(logp, want, rtol=0, atol=0)
    torch.testing.assert_close(v, pout["vf_preds"], rtol=0, atol=0)
    assert pm.infer(params, t_(obs)).tolist() == pout["actions"].tolist()


def test_sampled_actions_follow_the_distribution():
    """The Gumbel-max draw's frequencies match softmax(logits)."""
    logits = torch.tensor([[0.0, 1.0, 2.0]]).repeat(20000, 1)
    gen = torch.Generator().manual_seed(1)
    a = models.categorical(logits, gen)
    freq = torch.bincount(a, minlength=3).float() / a.numel()
    torch.testing.assert_close(freq, torch.softmax(logits[0], -1),
                               atol=0.015, rtol=0)


def test_interop_round_trip():
    key = jax.random.PRNGKey(4)
    trees = [jmodels.init_mlp_policy(key, 4, 2),
             jmodels.init_actor_critic(key, (10, 10, 2), 3)]
    for jp in trees:
        params, strides = interop.rl_params_from_jax(jp)
        back = interop.rl_params_to_jax(params, strides)
        want, got = dict(flat(jp)), dict(flat(back))
        assert sorted(want) == sorted(got)
        for k in want:
            np.testing.assert_array_equal(np.asarray(want[k]), got[k])


# ------------------------------------------------------------------ trees


def _old_leaves(t):
    """util.tree.leaves before lists were walked: dicts only."""
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _old_leaves(t[k])]
    return [t]


def test_dict_trees_flatten_as_before():
    from ray_tpu_torch.models import gpt2

    p = gpt2.init_gpt2(torch.Generator().manual_seed(0),
                       gpt2.GPT2Config.tiny(), device="cpu")
    assert [id(x) for x in tree.leaves(p)] == \
        [id(x) for x in _old_leaves(p)]
    back = tree.unflatten(p, tree.leaves(p))
    assert [id(x) for x in tree.leaves(back)] == \
        [id(x) for x in tree.leaves(p)]


def test_list_trees_flatten_like_jax():
    jp = jmodels.init_mlp_policy(jax.random.PRNGKey(5), 3, 2, (4,))
    params, _ = interop.rl_params_from_jax(jp)
    got = [x.numpy() for x in tree.leaves(params)]
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(jp)]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    mapped = tree.tree_map(lambda x: x + 1, params)
    assert isinstance(mapped["pi"], list)
    assert tree.unflatten(params, tree.leaves(params))["vf"][1]["b"] is \
        params["vf"][1]["b"]


def test_tuple_subclasses_stay_leaves():
    """Plain lists and tuples are walked; a PartitionSpec (a tuple
    subclass) is a leaf, as jax.tree_util keeps it; paths name indices."""
    from ray_tpu_torch.parallel.sharding import PartitionSpec

    spec = PartitionSpec(None, "tensor")
    t = {"a": [spec, (1, 2)], "b": spec}
    assert tree.leaves(t) == [spec, 1, 2, spec]
    assert tree.leaves_with_path(t) == [(("a", "0"), spec),
                                        (("a", "1", "0"), 1),
                                        (("a", "1", "1"), 2), (("b",), spec)]
    assert tree.tree_map(lambda x: x, t) == t
    assert type(tree.tree_map(lambda x: x, t)["a"][1]) is tuple


@pytest.mark.parametrize("max_norm", [0.05, 100.0])
def test_adam_and_clip_on_a_list_tree_equal_optax(max_norm):
    """chain(clip_by_global_norm, adam) over a tree of lists of layers,
    three steps, against optax; max_norm 0.05 clips, 100 does not."""
    jp = jmodels.init_mlp_policy(jax.random.PRNGKey(6), 4, 2, (8,))
    tx = optax.chain(optax.clip_by_global_norm(max_norm), optax.adam(1e-2))
    state = tx.init(jp)
    params, _ = interop.rl_params_from_jax(jp)
    ptx = optim.chain(optim.clip_by_global_norm(max_norm), optim.adam(1e-2))
    pstate = ptx.init(params)
    rng = np.random.RandomState(7)
    for _ in range(3):
        grads = jax.tree.map(
            lambda x: jnp.asarray(rng.randn(*x.shape).astype(np.float32)),
            jp)
        upd, state = tx.update(grads, state, jp)
        jp = optax.apply_updates(jp, upd)
        pgrads, _ = interop.rl_params_from_jax(grads)
        params, pstate = ptx.update(pgrads, pstate, params)
    for (k, a), (_, b) in zip(flat(jp), flat(params)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
