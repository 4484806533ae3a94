"""The port's RL-for-LLMs flywheel (ray_tpu_torch.rllib.llm) against the
JAX package's (ray_tpu.rllib.llm), on the CPU in float32, with the JAX
parameters converted through ray_tpu_torch.interop:

- the trajectory schema, GRPO advantages, the padded train batch and
  the reward tasks give equal values;
- `adam` and `chain(clip_by_global_norm, adam)` follow optax over 5
  steps, clipped and unclipped;
- `LLMLearner.update` on one fixed trajectory list, 3 updates, GPT-2 and
  Llama tiny: losses, grad norms, params, versions and the staleness
  guard's counts; `teacher_forced_logprobs`;
- a greedy rollout gives the JAX worker's token streams and logprobs.

Then the JAX tests' own contracts on the port: rollout logprobs
reproduced teacher-forced at the tagged version across a hot-swap, the
8-stream mid-generation swap, the staleness guard, the temperature
check, one update preferring the rewarded completion, a 4-lap flywheel,
and the refusals (an engine and a handle at once, or neither; no card
without ``device="cpu"``).

GPT-2 runs at the JAX test's tiny config (tests/test_rllib_llm.py: vocab
64, 1 layer, 2 heads, E=32, f32, no remat; engine pages of 4 tokens,
chunks of 8); Llama at LlamaConfig.tiny()."""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ray_tpu.parallel.mesh  # noqa: F401 - threefry mode before any init
from ray_tpu.models import gpt2 as jax_gpt2
from ray_tpu.models import llama as jax_llama
from ray_tpu.rllib import llm as jax_rl
from ray_tpu.serve.llm import EngineConfig as JaxEngineConfig
from ray_tpu.serve.llm import LLMEngine as JaxEngine
from ray_tpu_torch import interop
from ray_tpu_torch.models import gpt2 as t_gpt2
from ray_tpu_torch.models import llama as t_llama
from ray_tpu_torch.rllib import llm as t_rl
from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine, SamplingParams
from ray_tpu_torch.train import optim
from ray_tpu_torch.util import metrics as t_metrics
from ray_tpu_torch.util import tree
from tests.test_torch_rl_learner_mesh import ADAM_ELEMENT_ATOL, _trajectories

LOSS_RTOL = 1e-4  # loss and grad norm, relative
PARAM_REL = 1e-4  # of each leaf's largest |value|
TF_ATOL = 1e-5  # teacher-forced logprobs against JAX's
ROLLOUT_ATOL = 1e-4  # greedy rollout logprobs against JAX's
CONTRACT_ATOL = 2e-4  # the JAX tests' determinism contract
OPTAX_RTOL = 1e-6
UPDATES = 3


def _tiny_cfgs(model: str):
    """(JAX cfg, port cfg) of the JAX test's tiny GPT-2 or Llama tiny."""
    if model == "gpt2":
        kw = dict(vocab_size=64, n_layer=1, n_head=2, n_embd=32,
                  block_size=64, vocab_pad_multiple=64, remat=False)
        return (jax_gpt2.GPT2Config(dtype=jnp.float32, **kw),
                t_gpt2.GPT2Config(dtype=torch.float32, **kw))
    return jax_llama.LlamaConfig.tiny(), t_llama.LlamaConfig.tiny()


def _jax_params(model: str, jcfg, seed: int = 0):
    """JAX params as numpy (a donated step cannot delete them)."""
    init = jax_gpt2.init_gpt2 if model == "gpt2" else jax_llama.init_llama
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), jcfg))


@pytest.fixture(scope="module", params=("gpt2", "llama"))
def model(request):
    """(name, JAX cfg, port cfg, params as numpy)."""
    jcfg, tcfg = _tiny_cfgs(request.param)
    return request.param, jcfg, tcfg, _jax_params(request.param, jcfg)


def _gpt2():
    jcfg, tcfg = _tiny_cfgs("gpt2")
    return jcfg, tcfg, _jax_params("gpt2", jcfg)


def _engine_kw(**over):
    kw = dict(block_size=4, num_blocks=128, max_model_len=48,
              max_batch_size=8, prefill_chunk_size=8,
              enable_prefix_cache=True, seed=0)
    kw.update(over)
    return kw


def _engine(cfg, params=None, **over):
    """The port's engine on the CPU at the JAX test's layout."""
    return LLMEngine(EngineConfig(model="gpt2", model_config=cfg,
                                  **_engine_kw(**over)),
                     params=params, device="cpu")


def _learner(cfg, params=None, model="gpt2", **config):
    return t_rl.LLMLearner(model, cfg, params=params, device="cpu",
                           config=t_rl.LLMLearnerConfig(**config))


def _leaves(t, path=""):
    if isinstance(t, dict):
        for k in sorted(t):
            yield from _leaves(t[k], f"{path}/{k}")
    else:
        yield path, np.asarray(t)


# ------------------------------------------------- against the JAX package


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_trajectory_advantages_and_batch_match_jax(seed):
    rng = np.random.RandomState(seed)
    final = {"done": True, "token_ids": rng.randint(0, 60, 5).tolist(),
             "logprobs": (-rng.rand(5)).tolist(), "weight_version": 3,
             "weight_versions": [2, 3], "stale": True, "cached_tokens": 4,
             "finish_reason": "length"}
    prompt = rng.randint(0, 60, 7).tolist()
    got = t_rl.Trajectory.from_final(prompt, final, reward=0.5,
                                     group_id=2, temperature=0.7)
    want = jax_rl.Trajectory.from_final(prompt, final, reward=0.5,
                                        group_id=2, temperature=0.7)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    with pytest.raises(ValueError, match="logprobs"):
        t_rl.Trajectory.from_final([1], {"token_ids": [2]}, reward=0,
                                   group_id=0, temperature=1.0)

    t_trajs = _trajectories(t_rl, 64, seed)
    j_trajs = _trajectories(jax_rl, 64, seed)
    adv = t_rl.group_relative_advantages(t_trajs)
    np.testing.assert_array_equal(
        adv, jax_rl.group_relative_advantages(j_trajs))
    got = t_rl.to_train_batch(t_trajs, adv, max_len=64, pad_token=3)
    want = jax_rl.to_train_batch(j_trajs, adv, max_len=64, pad_token=3)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(ValueError, match="max_len"):
        t_rl.to_train_batch(t_trajs, adv, max_len=16)


def test_reward_tasks_match_jax():
    rng = np.random.RandomState(0)
    for t_task, j_task in ((t_rl.DigitSumTask(), jax_rl.DigitSumTask()),
                           (t_rl.DigitSumTask(prefix_len=224),
                            jax_rl.DigitSumTask(prefix_len=224))):
        assert t_task.prefix == j_task.prefix
        assert t_task.min_vocab() == j_task.min_vocab()
        for _ in range(50):
            a, b = rng.randint(0, 10, 2).tolist()
            p = t_task.make_prompt(a, b)
            assert p == j_task.make_prompt(a, b)
            toks = rng.randint(0, 40, rng.randint(0, 4)).tolist()
            if rng.rand() < 0.3:
                toks = [t_task.target(p)] + toks
            assert t_task.reward(p, toks) == j_task.reward(p, toks)
    t_sort, j_sort = t_rl.SortTask(k=3), jax_rl.SortTask(k=3)
    for _ in range(50):
        digits = rng.randint(0, 10, 3).tolist()
        p = t_sort.make_prompt(digits)
        want = sorted(p[-3:])
        toks = [w if rng.rand() < 0.5 else w + 1 for w in want]
        assert t_sort.reward(p, toks) == j_sort.reward(p, toks)
    p = t_rl.DigitSumTask().make_prompt(3, 9)
    for name in ("digit_sum", "sort"):
        assert t_rl.get_reward(name)(p, [4]) == \
            jax_rl.get_reward(name)(p, [4])
    with pytest.raises(ValueError, match="unknown reward"):
        t_rl.get_reward("nope")


def _optax_case(name: str):
    """(port tx, optax tx) of a case."""
    if name == "adam":
        return optim.adam(3e-3), optax.adam(3e-3)
    clip = 0.05 if name == "chain_clipped" else 1e3
    return (optim.chain(optim.clip_by_global_norm(clip), optim.adam(3e-3)),
            optax.chain(optax.clip_by_global_norm(clip), optax.adam(3e-3)))


@pytest.mark.parametrize("name", ["adam", "chain_clipped",
                                  "chain_unclipped"])
def test_optimizers_match_optax(name):
    """5 steps on seeded grads (global norms of ~4, so a clip of 0.05
    scales every step and one of 1e3 none)."""
    rng = np.random.RandomState(7)
    # shapes as leaves: util.tree walks tuples, as jax.tree_util does
    shapes = {"a": np.empty((4, 6)),
              "b": {"c": np.empty((6,)), "d": np.empty((3, 2, 5))}}
    params = tree.tree_map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)
    grads = [tree.tree_map(
        lambda s: (0.3 * rng.normal(size=s.shape)).astype(np.float32),
        shapes) for _ in range(5)]
    tx, otx = _optax_case(name)
    p = tree.tree_map(torch.from_numpy, tree.tree_map(np.copy, params))
    state = tx.init(p)
    jp = jax.tree.map(jnp.asarray, params)
    ostate = otx.init(jp)
    for g in grads:
        p, state = tx.update(tree.tree_map(torch.from_numpy, g), state, p)
        upd, ostate = otx.update(jax.tree.map(jnp.asarray, g), ostate, jp)
        jp = optax.apply_updates(jp, upd)
    for (path, got), (_, want) in zip(_leaves(tree.tree_map(
            lambda t: t.numpy(), p)), _leaves(jp)):
        # relative to the leaf's scale: p - lr u rounds at the ulp of
        # |p| ~ 1, which near-zero elements cannot show relative to
        # themselves
        np.testing.assert_allclose(
            got, want, rtol=OPTAX_RTOL,
            atol=OPTAX_RTOL * np.abs(want).max(), err_msg=path)
    assert isinstance(state, tuple if name != "adam" else
                      optim.ScaleByAdamState)


def test_clip_by_global_norm_scales_grads_and_chain_order():
    g = {"a": torch.full((4,), 3.0), "b": torch.full((9,), 4.0 / 3.0)}
    norm = float(optim.global_norm(tree.leaves(g)))  # sqrt(36 + 16)
    assert norm == pytest.approx(52 ** 0.5)
    p = {"a": torch.zeros(4), "b": torch.zeros(9)}
    clip = optim.clip_by_global_norm(1.0)
    assert not clip.applies
    out, _ = clip.update(g, clip.init(p), p)
    assert out is p and float(p["a"].abs().max()) == 0.0
    assert float(optim.global_norm(tree.leaves(g))) == \
        pytest.approx(1.0, rel=1e-6)
    with pytest.raises(ValueError, match="last"):
        optim.chain(optim.adam(1e-3), optim.clip_by_global_norm(1.0))


def test_learner_update_matches_jax(model):
    """3 GRPO updates on one fixed trajectory list: the staleness guard
    keeps and drops the same trajectories, and losses, grad norms and
    params follow the JAX learner's."""
    name, jcfg, tcfg, params = model
    jl = jax_rl.LLMLearner(name, jcfg, params=jax.tree.map(
        jnp.asarray, params))
    tl = t_rl.LLMLearner(name, tcfg, params=interop.params_from_jax(params),
                         device="cpu")
    j_trajs = _trajectories(jax_rl, jcfg.vocab_size)
    t_trajs = _trajectories(t_rl, jcfg.vocab_size)
    drops = []
    for _ in range(UPDATES):
        want, got = jl.update(j_trajs), tl.update(t_trajs)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL,
                                       err_msg=k)
        for k in ("version", "kept", "dropped_stale", "dropped_too_old",
                  "reward_mean", "reward_std"):
            assert got[k] == pytest.approx(want[k]), k
        drops.append(got["dropped_too_old"])
    assert drops[0] == 0 and drops[-1] > 0  # the guard's lag moved
    for (path, g), (_, w) in zip(_leaves(tl.get_weights()),
                                 _leaves(jl.get_weights())):
        np.testing.assert_allclose(
            g, w, rtol=0,
            atol=max(PARAM_REL * np.abs(w).max(), ADAM_ELEMENT_ATOL),
            err_msg=path)


def test_teacher_forced_logprobs_match_jax(model):
    name, jcfg, tcfg, params = model
    jl = jax_rl.LLMLearner(name, jcfg, params=jax.tree.map(
        jnp.asarray, params))
    tl = t_rl.LLMLearner(name, tcfg, params=interop.params_from_jax(params),
                         device="cpu")
    other = _jax_params(name, jcfg, seed=5)
    for jt, tt in zip(_trajectories(jax_rl, jcfg.vocab_size),
                      _trajectories(t_rl, jcfg.vocab_size)):
        np.testing.assert_allclose(tl.teacher_forced_logprobs(tt),
                                   jl.teacher_forced_logprobs(jt),
                                   atol=TF_ATOL)
        np.testing.assert_allclose(
            tl.teacher_forced_logprobs(tt, params=other),
            jl.teacher_forced_logprobs(jt, params=other), atol=TF_ATOL)


def test_greedy_rollout_matches_jax():
    jcfg, tcfg, params = _gpt2()
    task = t_rl.DigitSumTask()
    prompts = [task.make_prompt(2, 5), task.make_prompt(9, 9),
               task.make_prompt(0, 3)]
    kw = _engine_kw()
    je = JaxEngine(JaxEngineConfig(model="gpt2", model_config=jcfg, **kw),
                   params=params)
    te = _engine(tcfg, interop.params_from_jax(params))
    conf = dict(group_size=2, max_tokens=6, temperature=0.0)
    want = jax_rl.RolloutWorker(
        engine=je, reward_fn=task.reward,
        config=jax_rl.RolloutConfig(**conf)).rollout(prompts)
    got = t_rl.RolloutWorker(
        engine=te, reward_fn=task.reward,
        config=t_rl.RolloutConfig(**conf)).rollout(prompts)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert (g.prompt, g.tokens, g.group_id, g.reward) == \
            (w.prompt, w.tokens, w.group_id, w.reward)
        assert (g.weight_version, g.stale, g.cached_tokens) == \
            (w.weight_version, w.stale, w.cached_tokens)
        np.testing.assert_allclose(g.logprobs, w.logprobs,
                                   atol=ROLLOUT_ATOL)
    assert te.stats()["prefix_hit_pages"] == je.stats()["prefix_hit_pages"]


# ------------------------------------------------ the port's own contracts


def test_rollout_logprobs_match_teacher_forced_at_tagged_version():
    """Determinism contract: a non-stale trajectory's logprobs are
    reproduced by a teacher-forced forward at the tagged version —
    before AND after a hot-swap (each at its own version's params)."""
    _, cfg, _ = _gpt2()
    task = t_rl.DigitSumTask()
    learner = _learner(cfg, temperature=1.0)
    w0 = learner.get_weights()
    eng = _engine(cfg, params=w0)
    worker = t_rl.RolloutWorker(
        engine=eng, reward_fn=task.reward,
        config=t_rl.RolloutConfig(group_size=4, max_tokens=4,
                                  temperature=1.0))
    trajs = worker.rollout([task.make_prompt(2, 5),
                            task.make_prompt(9, 9)])
    assert len(trajs) == 8
    for t in trajs:
        assert not t.stale and t.weight_version == 0
        np.testing.assert_allclose(
            learner.teacher_forced_logprobs(t, params=w0), t.logprobs,
            atol=CONTRACT_ATOL)
    assert eng.stats()["prefix_hit_pages"] > 0

    w1 = interop.params_to_numpy(t_gpt2.init_gpt2(
        torch.Generator().manual_seed(11), cfg, device="cpu"))
    eng.update_weights(1, w1)
    t1 = worker.rollout([task.make_prompt(1, 3)])[0]
    assert t1.weight_version == 1 and not t1.stale
    np.testing.assert_allclose(
        learner.teacher_forced_logprobs(t1, params=w1), t1.logprobs,
        atol=CONTRACT_ATOL)
    diff = np.abs(learner.teacher_forced_logprobs(t1, params=w0)
                  - np.asarray(t1.logprobs))
    assert diff.max() > 1e-3, "distinct params should disagree"


def test_greedy_rollout_logprobs_teacher_forced():
    _, cfg, _ = _gpt2()
    learner = _learner(cfg)
    eng = _engine(cfg, params=learner.get_weights())
    task = t_rl.DigitSumTask()
    worker = t_rl.RolloutWorker(
        engine=eng, reward_fn=task.reward,
        config=t_rl.RolloutConfig(group_size=2, max_tokens=3,
                                  temperature=0.0))
    (t, _) = worker.rollout([task.make_prompt(4, 4)])
    np.testing.assert_allclose(learner.teacher_forced_logprobs(t),
                               t.logprobs, atol=CONTRACT_ATOL)


def test_hot_swap_8_streams_mid_generation():
    """8 concurrent streams receive update_weights mid-generation: none
    drops, no swap lands inside a decode step, every stream is tagged
    stale with versions {0, 1}."""
    _, cfg, _ = _gpt2()
    eng = _engine(cfg)
    orig_decode = eng.runner.decode
    batches = []

    def spy(items):
        v_in = eng.weight_version
        out = orig_decode(items)
        assert eng.weight_version == v_in, \
            "weight swap landed inside a decode step"
        batches.append(v_in)
        return out

    eng.runner.decode = spy
    rng = np.random.RandomState(0)
    sp = SamplingParams(max_tokens=16, logprobs=True)
    streams = [eng.add_request(rng.randint(1, 60, size=6).tolist(), sp)
               for _ in range(8)]
    for _ in range(12):
        eng.step()
    new = t_gpt2.init_gpt2(torch.Generator().manual_seed(7), cfg,
                           device="cpu")
    assert eng.update_weights(1, new)["in_flight_streams"] == 8
    deadline = time.monotonic() + 120
    while any(s.final() is None for s in streams):
        eng.step()
        assert time.monotonic() < deadline, "engine stalled"
    finals = [s.final() for s in streams]
    assert all(f["done"] and f["num_generated"] == 16 for f in finals)
    for f in finals:
        assert f["stale"] and f["weight_versions"] == [0, 1]
    assert set(batches) == {0, 1}


def test_staleness_guard_drops_stale_and_old():
    _, cfg, _ = _gpt2()
    learner = _learner(cfg, max_staleness=1)
    learner.version = 3

    def tr(version, stale):
        return t_rl.Trajectory([1, 2], [3], [-1.0], 1.0, version,
                               [version], stale, 0, 1.0)

    kept, dropped = learner.filter_stale(
        [tr(3, False), tr(2, False), tr(1, False), tr(3, True)])
    assert [t.weight_version for t in kept] == [3, 2]
    assert dropped == {"stale": 1, "too_old": 1}
    m = learner.update([tr(1, False), tr(3, True)])
    assert m == {"skipped": True, "kept": 0, "dropped_stale": 1,
                 "dropped_too_old": 1}
    assert learner.version == 3


def test_learner_rejects_temperature_mismatch():
    _, cfg, _ = _gpt2()
    learner = _learner(cfg, temperature=1.0)
    bad = t_rl.Trajectory([1, 2], [3], [-1.0], 1.0, 0, [0], False, 0,
                          temperature=0.7)
    with pytest.raises(ValueError, match="temperature"):
        learner.update([bad])
    ok = t_rl.Trajectory([1, 2], [3], [-1.0], 1.0, 0, [0], False, 0,
                         temperature=0.0)
    assert learner.update([ok])["kept"] == 1


def test_learner_update_moves_policy_toward_reward():
    _, cfg, _ = _gpt2()
    learner = _learner(cfg, lr=5e-3)
    prompt = [20, 21, 22, 5, 7]
    good, bad = [9], [3]

    def lp(tokens):
        t = t_rl.Trajectory(prompt, tokens, [0.0], 0.0, 0, [0], False, 0,
                            1.0)
        return learner.teacher_forced_logprobs(t)[0]

    def mk(tokens, r):
        return t_rl.Trajectory(prompt, tokens, [lp(tokens)], r,
                               learner.version, [learner.version], False,
                               0, 1.0)

    before = lp(good) - lp(bad)
    metrics = learner.update([mk(good, 1.0), mk(bad, 0.0)])
    assert metrics["kept"] == 2 and metrics["version"] == 1
    assert lp(good) - lp(bad) > before, \
        "update did not prefer the rewarded tokens"


def test_flywheel_closed_loop_smoke():
    """Rollout → stream → GRPO update → hot-swap, four laps: versions
    advance in lockstep, probe streams survive every swap, the prefix
    cache serves the shared task prefix, and the rl_* metrics are in the
    port's registry (the JAX test reads them from prometheus_text(),
    which the port's metrics copy lacks)."""
    _, cfg, _ = _gpt2()
    task = t_rl.DigitSumTask()
    learner = _learner(cfg, lr=1e-2, temperature=1.0)
    eng = _engine(cfg, params=learner.get_weights(), num_blocks=256)
    worker = t_rl.RolloutWorker(
        engine=eng, reward_fn=task.reward,
        config=t_rl.RolloutConfig(group_size=4, max_tokens=2,
                                  temperature=1.0))
    rng = np.random.RandomState(0)

    def prompt_fn(it):
        return [task.make_prompt(rng.randint(0, 10), rng.randint(0, 10))
                for _ in range(6)]

    fly = t_rl.RLFlywheel(worker, learner, prompt_fn,
                          t_rl.FlywheelConfig(swap_during_rollout=True))
    for lap in range(4):
        m = fly.iteration()
        assert m["kept"] == m["num_trajectories"] == 24
        assert m["swap"]["version"] == m["version"] == lap + 1
        assert m["swap"]["probe_dropped"] == 0
        assert m["swap"]["probe_streams"] == 2
        assert m["swap"]["in_flight_streams"] >= 1
        assert np.isfinite(m["loss"]) and m["grad_norm"] > 0
    assert eng.stats()["weight_version"] == 4
    assert eng.stats()["prefix_hit_pages"] > 0
    names = {m.name for m in t_metrics._registry.collect()}
    assert {"rl_rollout_tokens_total", "rl_reward_mean",
            "rl_weight_swap_seconds", "rl_traj_staleness",
            "rl_traj_dropped_total"} <= names


def test_rollout_worker_refuses_handle_and_learner_defaults_to_cuda():
    _, cfg, _ = _gpt2()
    eng = _engine(cfg)
    # an engine and a handle at once, or neither, as the JAX worker
    with pytest.raises(ValueError, match="exactly one of engine="):
        t_rl.RolloutWorker(engine=eng, handle=object(),
                           reward_fn=lambda p, t: 0.0)
    with pytest.raises(ValueError, match="exactly one of engine="):
        t_rl.RolloutWorker(reward_fn=lambda p, t: 0.0)
    with pytest.raises(ValueError, match="unknown model"):
        t_rl.LLMLearner("bert", device="cpu")
    if torch.cuda.is_available():
        assert t_rl.LLMLearner("gpt2", cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            t_rl.LLMLearner("gpt2", cfg)
