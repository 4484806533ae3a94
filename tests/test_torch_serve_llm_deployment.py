"""The port's LLM deployment (ray_tpu_torch.serve.llm.deployment) and RL
for LLMs through a deployment handle, on the port's cluster runtime on
the CPU.

The JAX package's scenarios with their own inputs and assertions:
`test_llm_deployment_8_concurrent_streams` and
`test_affinity_routing_concentrates_shared_prefix`
(tests/test_serve_llm.py), `test_deployment_handle_update_weights_mid_
generation` (tests/test_rllib_llm.py) and
`test_spec_streams_survive_replica_kill` (tests/test_spec_decode.py).

Held against the JAX package directly:

- `prompt_affinity_key` and `payload_affinity_key` give JAX's keys on
  seeded prompts (equal strings);
- greedy streams through the port's deployment, its replicas given
  JAX's tiny f32 params (converted by `interop`) through
  `update_weights`, give the JAX `LLMEngine`'s tokens on the same
  prompts (equal), and its logprobs within ROLLOUT_ATOL;
- a `RolloutWorker(handle=)` lap (the flywheel's handle branch: the
  learner's weights put once in the store, `update_weights` through the
  handle) gives logprobs that teacher forcing reproduces at their
  version within CONTRACT_ATOL, before and after the update.

And the repairs: `LLMLearner.publish_weights` puts through the store
when a runtime is up and returns the tree otherwise; a card app claims
a GPU share, and a card replica that sees no card raises.

One module-scoped cluster; apps are deployed on the CPU
(``device="cpu"``). GPT-2 runs at the JAX tests' tiny config (vocab 64,
1 layer, 2 heads, E=32, f32) where they give one, else at the tiny
preset.
"""

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu.parallel.mesh  # noqa: F401 - threefry mode before any init
import ray_tpu_torch as ray
from ray_tpu.models import gpt2 as jax_gpt2
from ray_tpu.serve.api import payload_affinity_key as jax_payload_key
from ray_tpu.serve.llm import EngineConfig as JaxEngineConfig
from ray_tpu.serve.llm import LLMEngine as JaxEngine
from ray_tpu.serve.llm import SamplingParams as JaxSamplingParams
from ray_tpu.serve.llm.deployment import (
    prompt_affinity_key as jax_prompt_key,
)
from ray_tpu_torch import interop, serve
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.core.api import ObjectRef
from ray_tpu_torch.models import gpt2 as t_gpt2
from ray_tpu_torch.rllib import llm as t_rl
from ray_tpu_torch.serve.api import payload_affinity_key
from ray_tpu_torch.serve.llm import (
    EngineConfig,
    LLMServer,
    build_llm_app,
    prompt_affinity_key,
)
from ray_tpu_torch.util import chaos
from ray_tpu_torch.util import tree
from ray_tpu_torch.util.state import llm_status

ROLLOUT_ATOL = 1e-4  # streamed logprobs against the JAX engine's
CONTRACT_ATOL = 1e-4  # rollout logprobs against teacher forcing
LAPS_FOR_A_GRADIENT = 5  # GRPO laps through the handle, at most


def _tiny_cfgs():
    kw = dict(vocab_size=64, n_layer=1, n_head=2, n_embd=32,
              block_size=64, vocab_pad_multiple=64, remat=False)
    return (jax_gpt2.GPT2Config(dtype=jnp.float32, **kw),
            t_gpt2.GPT2Config(dtype=torch.float32, **kw))


def _tiny_app_config(cfg, **over):
    kw = {"model_config": cfg, "block_size": 8, "num_blocks": 96,
          "max_model_len": 64, "max_batch_size": 8}
    kw.update(over)
    return kw


def _consume_all(gens, timeout=180):
    """Drain every stream on its own thread: (events per stream, errors)."""
    results, errors = [None] * len(gens), []

    def consume(i, gen):
        try:
            results[i] = [ray.get(r, timeout=120) for r in gen]
        except Exception as e:  # noqa: BLE001
            errors.append((i, repr(e)))

    threads = [threading.Thread(target=consume, args=(i, g))
               for i, g in enumerate(gens)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    return results, errors


# ------------------------------------------------------- without a cluster


def test_affinity_keys_match_jax():
    rng = np.random.RandomState(21)
    for n in (1, 3, 15, 16, 17, 40):
        p = rng.randint(0, 50257, size=n).tolist()
        assert prompt_affinity_key(p) == jax_prompt_key(p)
        assert prompt_affinity_key(p, prefix_len=4) == \
            jax_prompt_key(p, prefix_len=4)
        payload = {"prompt": p, "max_tokens": 3}
        assert payload_affinity_key(payload) == jax_payload_key(payload)
    for payload in (None, 7, {"prompt": []}, {"prompt": "text"},
                    {"max_tokens": 3}):
        assert payload_affinity_key(payload) is None
        assert jax_payload_key(payload) is None


def test_card_app_claims_a_gpu_share_and_a_card_replica_needs_a_card():
    dep = build_llm_app().deployment  # device="cuda" by default
    assert dep.ray_actor_options == {"num_gpus": 1}
    dep = build_llm_app(num_replicas=2,
                        ray_actor_options={"num_gpus": 0.5}).deployment
    assert dep.ray_actor_options == {"num_gpus": 0.5}
    dep = build_llm_app(ray_actor_options={
        "num_cpus": 1, "resources": {"GPU": 0.25}}).deployment
    assert dep.ray_actor_options["resources"] == {"GPU": 0.25}
    for opts in ({"num_cpus": 1}, {"num_gpus": 0}):
        with pytest.raises(ValueError, match="claims no GPU"):
            build_llm_app(ray_actor_options=opts)
    app = build_llm_app(device="cpu", ray_actor_options={"num_cpus": 1})
    assert app.deployment.ray_actor_options == {"num_cpus": 1}
    assert app.init_kwargs == {"device": "cpu"}
    if not torch.cuda.is_available():
        # a card replica never runs on the CPU
        with pytest.raises(RuntimeError, match="device='cpu'"):
            LLMServer({"model": "gpt2", "preset": "tiny"}, warmup=False)


# ------------------------------------------------------------ the cluster


@pytest.fixture(scope="module")
def llm_cluster():
    # replica processes inherit this: one intra-op thread each (a
    # replica claims a tenth of a CPU), so their tiny engines do not
    # keep torch's spinning thread pool busy on every core of the host
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 8})
    try:
        c.wait_for_nodes()
        ray.init(address=c.address)
        yield c
        serve.shutdown()
    finally:
        ray.shutdown()
        c.shutdown()
        if old is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = old


def test_publish_weights_puts_through_the_store(llm_cluster, monkeypatch):
    """With a runtime up the learner's weights go into the store once
    (the JAX learner's contract); without one, callers get the tree."""
    _, cfg = _tiny_cfgs()
    learner = t_rl.LLMLearner("gpt2", cfg, device="cpu")
    version, ref = learner.publish_weights()
    assert version == 0 and isinstance(ref, ObjectRef)
    got, want = ray.get(ref, timeout=60), learner.get_weights()
    for a, b in zip(tree.leaves(got), tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), b)
    monkeypatch.setattr(ray, "is_initialized", lambda: False)
    version, w = learner.publish_weights()
    assert version == 0 and isinstance(w, dict)
    for a, b in zip(tree.leaves(w), tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


def test_llm_deployment_8_concurrent_streams(llm_cluster):
    """The serving acceptance gate: >= 8 concurrent requests stream
    token-by-token through a serve deployment with zero dropped
    requests, and engine metrics surface via the state API."""
    app = build_llm_app(
        model="gpt2", preset="tiny",
        engine_config={"block_size": 8, "num_blocks": 96,
                       "max_model_len": 64, "max_batch_size": 8},
        max_ongoing_requests=16, device="cpu")
    handle = serve.run(app, name="llm")
    try:
        sh = handle.options(stream=True, generator_backpressure=64)
        rng = np.random.RandomState(5)
        n_req, n_tok = 8, 5
        gens = [sh.remote({"prompt": rng.randint(1, 500, size=4 + i)
                           .tolist(),
                           "max_tokens": n_tok})
                for i in range(n_req)]
        results, errors = _consume_all(gens)
        assert not errors, f"dropped/errored requests: {errors}"
        for events in results:
            assert events is not None
            *toks, final = events
            assert len(toks) == n_tok  # one event per token, streamed
            assert [e["index"] for e in toks] == list(range(n_tok))
            assert final["done"] and final["finish_reason"] == "length"
            assert final["num_generated"] == n_tok

        stats = llm_status("llm")
        assert len(stats) == 1
        assert stats[0]["model"] == "gpt2"
        assert stats[0]["device"] == "cpu"
        assert stats[0]["running"] == 0 and stats[0]["waiting"] == 0
    finally:
        serve.delete("llm")


def test_affinity_routing_concentrates_shared_prefix(llm_cluster):
    """Prefix-affinity routing: requests sharing a prompt prefix carry
    the same affinity key, rendezvous onto ONE of two replicas, and
    that replica's prefix cache serves the shared pages — the hits show
    up on exactly one engine."""
    app = build_llm_app(
        model="gpt2", preset="tiny", num_replicas=2,
        engine_config={"block_size": 8, "num_blocks": 96,
                       "max_model_len": 64, "max_batch_size": 8,
                       "prefill_chunk_size": 16},
        max_ongoing_requests=16, device="cpu")
    handle = serve.run(app, name="llm-aff")
    try:
        rng = np.random.RandomState(9)
        shared = rng.randint(1, 500, size=24).tolist()  # 3 full pages
        for _ in range(4):
            p = shared + rng.randint(1, 500, size=2).tolist()
            sh = handle.options(stream=True,
                                affinity_key=prompt_affinity_key(p))
            events = [ray.get(r, timeout=120)
                      for r in sh.remote({"prompt": p, "max_tokens": 3})]
            assert events[-1]["done"]

        stats = llm_status("llm-aff")
        assert len(stats) == 2
        hits = [s.get("prefix_hit_pages", 0) for s in stats]
        # 3 warm requests x 3 shared pages, all on the SAME replica
        assert sum(hits) >= 9, stats
        assert max(hits) == sum(hits), \
            f"affinity routing scattered a shared prefix: {hits}"
    finally:
        serve.delete("llm-aff")


def test_deployment_handle_update_weights_mid_generation(llm_cluster):
    """A replica serving 8 concurrent token streams receives
    `DeploymentHandle.update_weights(version, ref)` (params through the
    object store) mid-generation — zero stream drops, the new version
    is live for subsequent requests."""
    jcfg, cfg = _tiny_cfgs()
    dep = serve.deployment(
        LLMServer, name="llm-rl", num_replicas=1,
        max_ongoing_requests=16, payload_affinity=True)
    app = dep.bind(
        EngineConfig(model="gpt2", model_config=cfg, block_size=4,
                     num_blocks=128, max_model_len=64, max_batch_size=8,
                     prefill_chunk_size=8),
        warmup=False, device="cpu")
    handle = serve.run(app, name="llm-rl")
    try:
        sh = handle.options(stream=True, generator_backpressure=128)
        rng = np.random.RandomState(3)
        n_req, n_tok = 8, 48
        gens = [sh.remote({"prompt": rng.randint(1, 60, size=4).tolist(),
                           "max_tokens": n_tok, "temperature": 1.0,
                           "logprobs": True})
                for _ in range(n_req)]
        results, errors = [None] * n_req, []
        started = threading.Barrier(n_req + 1, timeout=180)

        def consume(i, gen):
            try:
                events, waited = [], False
                for r in gen:
                    events.append(ray.get(r, timeout=120))
                    if not waited:
                        waited = True
                        started.wait()  # stream is live: swap may land
                results[i] = events
            except Exception as e:  # noqa: BLE001
                errors.append((i, repr(e)))

        threads = [threading.Thread(target=consume, args=(i, g))
                   for i, g in enumerate(gens)]
        for t in threads:
            t.start()
        started.wait()  # every stream produced >= 1 token
        w1 = interop.params_from_jax(jax.tree.map(
            np.asarray, jax_gpt2.init_gpt2(jax.random.PRNGKey(7), jcfg)))
        swap = handle.update_weights(1, ray.put(w1))
        assert len(swap) == 1 and swap[0]["version"] == 1
        for t in threads:
            t.join(timeout=180)
        assert not errors, f"streams dropped across the swap: {errors}"
        for events in results:
            *toks, final = events
            assert final["done"] and final["num_generated"] == n_tok
            assert set(final["weight_versions"]) <= {0, 1}

        stats = llm_status("llm-rl")
        assert stats[0]["weight_version"] == 1
        # a fresh request runs (and is tagged) entirely on v1
        post = [ray.get(r, timeout=120) for r in sh.remote(
            {"prompt": [5, 6, 7], "max_tokens": 4, "logprobs": True})]
        assert post[-1]["weight_version"] == 1
        assert not post[-1]["stale"]
    finally:
        serve.delete("llm-rl")


def test_spec_streams_survive_replica_kill(llm_cluster):
    """Spec x failover: concurrent speculative greedy streams, one
    replica killed mid-generation — zero client-visible failures and
    outputs bit-identical to the unkilled run (the failover replay
    re-feeds prompt+generated, so committed speculative tokens must
    replay exactly)."""
    _, cfg = _tiny_cfgs()
    n_streams, n_tok = 4, 24
    app = build_llm_app(
        model="gpt2",
        engine_config=_tiny_app_config(
            cfg, speculative={"num_draft_tokens": 4}),
        num_replicas=2, max_ongoing_requests=16, device="cpu")
    handle = serve.run(app, name="llm-spec")
    try:
        rng = np.random.RandomState(13)
        prompts = [(rng.randint(1, 64, size=4).tolist() * 3)[:10]
                   for _ in range(n_streams)]

        def run(on_second_event=None):
            sh = handle.options(stream=True, generator_backpressure=8)
            results = [None] * n_streams
            errors: list = []
            barrier = (threading.Barrier(n_streams + 1, timeout=180)
                       if on_second_event else None)
            resume = threading.Event()
            if on_second_event is None:
                resume.set()

            def consume(i, gen):
                try:
                    evs = []
                    for r in gen:
                        evs.append(ray.get(r, timeout=180))
                        if barrier is not None and len(evs) == 2:
                            barrier.wait()
                            resume.wait(timeout=180)
                    results[i] = evs
                except Exception as e:  # noqa: BLE001
                    errors.append((i, repr(e)))

            gens = [sh.remote({"prompt": p, "max_tokens": n_tok})
                    for p in prompts]
            threads = [threading.Thread(target=consume, args=(i, g))
                       for i, g in enumerate(gens)]
            for t in threads:
                t.start()
            if barrier is not None:
                barrier.wait()
                on_second_event()
                resume.set()
            for t in threads:
                t.join(timeout=300)
            return results, errors

        ref, errors = run()
        assert not errors, errors
        want = [evs[-1]["token_ids"] for evs in ref]
        assert all(len(w) == n_tok for w in want)

        results, errors = run(
            on_second_event=lambda: chaos.kill_replica(
                "llm-spec", busiest=True))
        assert not errors, f"client-visible failures: {errors}"
        failovers = 0
        for i, evs in enumerate(results):
            assert evs is not None, f"stream {i} never finished"
            final = evs[-1]
            toks = evs[:-1]
            assert [e["index"] for e in toks] == \
                list(range(len(toks)))
            assert final["token_ids"] == want[i], \
                f"speculative stream {i} diverged after failover"
            failovers += final.get("failovers", 0)
        assert failovers >= 1, "the kill never landed on a live stream"
    finally:
        serve.delete("llm-spec")


def test_greedy_streams_through_the_deployment_match_the_jax_engine(
        llm_cluster):
    """Two replicas given JAX's tiny f32 params (through
    `update_weights`) stream the JAX engine's greedy tokens."""
    jcfg, cfg = _tiny_cfgs()
    params = jax.tree.map(np.asarray,
                          jax_gpt2.init_gpt2(jax.random.PRNGKey(0), jcfg))
    kw = _tiny_app_config(cfg, prefill_chunk_size=8)
    handle = serve.run(build_llm_app(model="gpt2", engine_config=kw,
                                     num_replicas=2, device="cpu"),
                       name="llm-parity")
    try:
        swap = handle.update_weights(1, interop.params_from_jax(params))
        assert [s["version"] for s in swap] == [1, 1]
        rng = np.random.RandomState(17)
        prompts = [rng.randint(1, 64, size=3 + 4 * i).tolist()
                   for i in range(6)]
        n_tok = 12
        sh = handle.options(stream=True)
        gens = [sh.remote({"prompt": p, "max_tokens": n_tok,
                           "logprobs": True}) for p in prompts]
        results, errors = _consume_all(gens)
        assert not errors, errors

        jkw = dict(kw, model_config=jcfg)
        je = JaxEngine(JaxEngineConfig(model="gpt2", **jkw), params=params)
        for p, events in zip(prompts, results):
            want = je.generate(p, JaxSamplingParams(max_tokens=n_tok,
                                                    logprobs=True),
                               drive=True)
            final = events[-1]
            assert final["weight_version"] == 1
            assert final["token_ids"] == want["token_ids"]
            assert [e["token"] for e in events[:-1]] == want["token_ids"]
            np.testing.assert_allclose(final["logprobs"], want["logprobs"],
                                       atol=ROLLOUT_ATOL)
    finally:
        serve.delete("llm-parity")


def test_rollout_worker_handle_lap_matches_teacher_forcing(llm_cluster):
    """One GRPO lap through a deployment handle: groups come back
    through the store, the flywheel's handle branch publishes the
    learner's weights once and installs them on every replica, and
    each version's trajectories are reproduced by teacher forcing at
    that version's params."""
    _, cfg = _tiny_cfgs()
    task = t_rl.DigitSumTask()
    # the replicas and the learner init from the same seed (0)
    learner = t_rl.LLMLearner(
        "gpt2", cfg, device="cpu",
        config=t_rl.LLMLearnerConfig(temperature=1.0))
    handle = serve.run(
        build_llm_app(model="gpt2", num_replicas=2, device="cpu",
                      engine_config=_tiny_app_config(
                          cfg, block_size=4, num_blocks=128,
                          prefill_chunk_size=8)),
        name="llm-grpo")
    try:
        worker = t_rl.RolloutWorker(
            handle=handle, reward_fn=task.reward,
            config=t_rl.RolloutConfig(group_size=4, max_tokens=6,
                                      temperature=1.0))
        prompts = [task.make_prompt(2, 5), task.make_prompt(9, 9)]
        refs = list(worker.rollout_stream(prompts))
        assert len(refs) == 2 and all(isinstance(r, ObjectRef)
                                      for r in refs)
        w0 = learner.get_weights()
        for t in (t for r in refs for t in ray.get(r, timeout=60)):
            assert t.weight_version == 0 and not t.stale
            np.testing.assert_allclose(
                learner.teacher_forced_logprobs(t, params=w0), t.logprobs,
                atol=CONTRACT_ATOL)

        fly = t_rl.RLFlywheel(worker, learner, lambda i: prompts)
        # a lap whose every group drew equal rewards has zero advantages
        # and a zero gradient (the replicas' draws depend on how their
        # batches interleave): lap until one draws a reward difference
        for version in range(1, LAPS_FOR_A_GRADIENT + 1):
            m = fly.iteration()
            assert m["num_trajectories"] == 8 and m["version"] == version
            assert [s["version"] for s in m["swap"]] == [version, version]
            assert [s["weight_version"]
                    for s in llm_status("llm-grpo")] == [version, version]
            if m["grad_norm"] > 0:
                break
        assert m["grad_norm"] > 0, "no lap drew a reward difference"
        trajs = worker.rollout(prompts)
        assert len(trajs) == 8
        for t in trajs:
            assert t.weight_version == version and not t.stale
            np.testing.assert_allclose(
                learner.teacher_forced_logprobs(t), t.logprobs,
                atol=CONTRACT_ATOL)
        diff = max(np.abs(learner.teacher_forced_logprobs(t, params=w0)
                          - np.asarray(t.logprobs)).max() for t in trajs)
        assert diff > 1e-6, "the update left the policy where it was"
    finally:
        serve.delete("llm-grpo")
