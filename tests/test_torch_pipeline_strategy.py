"""The port's MPMD pipeline strategy (ray_tpu_torch.train.pipeline_strategy)
on the port's cluster runtime, on the CPU, through every cluster
scenario of tests/test_pipeline_strategy.py with its assertions:

- flat 1F1B (2 stages x 4 microbatches) and interleaved (R=2) against a
  single program, 3 SGD steps: losses and merged params within the JAX
  test's atol=1e-5 of the port's own `pipelined_train_step` (on a
  world-1 gloo mesh in this process), and within 1e-5 (losses,
  relative) and 1e-4 (params, of each leaf's largest) of the JAX
  package's single program (`_single_program_reference`), the
  tolerances tests/test_torch_pipelined.py holds this model to;
- the bubble, microbatch and virtual-stage metrics; bad shapes; the
  ZeRO composition (zero 3 over data_parallel=2: four gloo stage
  processes) with its resident bytes at ~1/D; the flat and interleaved
  runs' op spans (each stage's ops in its submission order, one at a
  time, an input's host copy ended before its consumer starts, the
  copies timed apart from the spans); the emulated bubble,
  interleaved below flat; the checkpoint round trip; `TorchTrainer`'s
  pipeline strategy and its checkpoints;
- and three of the port's own: it reads a checkpoint directory the JAX
  strategy's `save_checkpoint` wrote, ``device="cuda"`` without a GPU
  share raises, and with torch intra-op threads > 1 in the stage
  processes the measured bubble of a flat step is >= 0.

The parameters come from the JAX package's ``init_pipelined(PRNGKey(
seed))`` through ``interop.params_from_jax``. Every stage runs with
``device="cpu"``; one module-scoped cluster of 8 CPUs, whose stage
processes run two torch intra-op threads each."""

import functools
import os
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import ray_tpu_torch as ray
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.models.pipelined import PipelinedConfig
from ray_tpu_torch.parallel.pipeline import (
    interleaved_1f1b_submission_order,
    one_f_one_b_submission_order,
    theoretical_bubble,
    theoretical_bubble_interleaved,
)
from ray_tpu_torch.train.pipeline_strategy import (
    PipelineStrategy,
    _strategy_metrics,
    load_pipeline_checkpoint,
)

LOSS_TOL = 1e-5  # relative, against the JAX package
PARAM_TOL = 1e-4  # of each leaf's largest, against the JAX package
ATOL = 1e-5  # the JAX test's, against the port's single program
STAGE_THREADS = 2  # torch intra-op threads of each stage process


@pytest.fixture(scope="module")
def cluster():
    # stage processes inherit this: two intra-op threads each (more than
    # one, which the busy-clock test needs), so four stage processes of
    # tiny ops do not oversubscribe the host's cores
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = str(STAGE_THREADS)
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 8})
    try:
        c.wait_for_nodes()
        ray.init(address=c.address)
        yield c
    finally:
        ray.shutdown()
        c.shutdown()
        if old is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = old


def _toy_batch(cfg, B, seed=0):
    rs = np.random.RandomState(seed)
    return {
        "tokens": rs.randint(0, cfg.vocab_size,
                             (B, cfg.block_size)).astype(np.int32),
        "targets": rs.randint(0, cfg.vocab_size,
                              (B, cfg.block_size)).astype(np.int32),
    }


@functools.lru_cache(maxsize=None)
def _jax_params(cfg, seed=0):
    """JAX's init_pipelined(PRNGKey(seed)) as the port's CPU tensors
    (the tests only read them)."""
    import jax

    from ray_tpu.models import pipelined as jpl
    from ray_tpu_torch import interop

    jcfg = jpl.PipelinedConfig(**vars(cfg))
    return interop.params_from_jax(jax.tree.map(
        np.asarray, jpl.init_pipelined(jax.random.PRNGKey(seed), jcfg)))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, np.asarray(tree)


def _port_reference(cfg, params, batch, steps, lr=1e-2):
    """The port's `pipelined_train_step` on a (pipe=1, fsdp=1) mesh of a
    world-1 gloo group in this process: (params, losses)."""
    import socket

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.models.pipelined import pipelined_train_step
    from ray_tpu_torch.parallel.mesh import build_mesh
    from ray_tpu_torch.util import tree

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        mesh = build_mesh({"pipe": 1, "fsdp": 1}, device="cpu")
        step = pipelined_train_step(cfg, mesh, lr=lr)
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}

        def whole(t):
            return t.full_tensor() if isinstance(t, DTensor) else t

        p, losses = params, []
        for _ in range(steps):
            p, loss = step(p, tb)
            losses.append(float(whole(loss)))
        return tree.tree_map(whole, p), losses
    finally:
        dist.destroy_process_group()


def _jax_reference(cfg, batch, steps, lr=1e-2, seed=0):
    """JAX's `_single_program_reference` (tests/test_pipeline_strategy.py)
    at the same config, computed on a thread of its own while the test
    drives the strategy: a future of (numpy params, losses)."""
    import jax

    from ray_tpu.models import pipelined as jpl
    from tests.test_pipeline_strategy import _single_program_reference

    def run():
        p, losses = _single_program_reference(
            jpl.PipelinedConfig(**vars(cfg)), batch, steps, lr=lr,
            seed=seed)
        return jax.tree.map(np.asarray, p), losses

    pool = ThreadPoolExecutor(1)
    try:
        return pool.submit(run)
    finally:
        pool.shutdown(wait=False)


def _assert_params(got, want, *, atol=None, rel=None):
    pairs = list(zip(_leaves(got), _leaves(want)))
    assert len(pairs) == len(list(_leaves(want))) == 8
    for (pg, g), (pw, w) in pairs:
        assert pg == pw and g.shape == w.shape, pg
        tol = atol if atol is not None else rel * np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=pg)


def _strategy(cfg, **kw):
    kw.setdefault("device", "cpu")
    return PipelineStrategy(cfg, **kw)


def _strategies(cfg, *kws):
    """One strategy per kwargs, their stage processes started at once
    (a stage process takes seconds to import torch); each runs alone
    afterwards."""
    with ThreadPoolExecutor(len(kws)) as pool:
        futs = [pool.submit(_strategy, cfg, **kw) for kw in kws]
    made = [f for f in futs if f.exception() is None]
    if len(made) < len(futs):
        for f in made:
            f.result().shutdown()
        raise next(f.exception() for f in futs if f.exception())
    return [f.result() for f in futs]


def _assert_spans_follow_the_schedule(stats, S, M, R=1):
    """Each stage's op spans (compute only, its host copies' seconds
    beside) ran in the stage's submission order, one at a time with
    their copies; an op that takes another stage's output started after
    that output's copy to the host ended; the busy wall time is the sum
    of the spans; the host copies were timed."""
    order = (interleaved_1f1b_submission_order(S, M, R) if R > 1
             else one_f_one_b_submission_order(S, M))
    V, ops = S * R, {}
    for st in stats:
        spans = sorted(st["op_spans"], key=lambda o: o[3])
        assert [tuple(o[:3]) for o in spans] == \
            [op for op in order if op[1] % S == st["stage"]]
        for o in spans:
            assert o[3] <= o[4] and o[5] >= 0.0 and o[6] >= 0.0, o
            ops[tuple(o[:3])] = o
        for a, b in zip(spans, spans[1:]):
            assert a[4] + a[6] <= b[3] - b[5] + 1e-6, (a, b)
        assert st["busy_wall_s"] == pytest.approx(
            sum(o[4] - o[3] for o in spans))
        assert st["copy_s"] == pytest.approx(
            sum(o[5] + o[6] for o in spans))
        assert st["copy_s"] > 0.0
    for (kind, v, m), o in ops.items():
        src = (("fwd", v - 1, m) if kind == "fwd" and v > 0 else
               ("bwd", v + 1, m) if kind == "bwd" and v < V - 1 else None)
        if src is not None and src[1] % S != v % S:
            assert o[3] >= ops[src][4] + ops[src][6] - 1e-6, (o, ops[src])


def test_pipeline_strategy_matches_single_program(cluster):
    """2 stage workers x 4 microbatches vs pipelined_train_step on a
    one-device mesh: same init, same lr, 3 SGD steps — losses and the
    merged params must track (the port's single program and JAX's)."""
    cfg = PipelinedConfig()
    batch = _toy_batch(cfg, B=8)
    params = _jax_params(cfg)
    ref_params, ref_losses = _port_reference(cfg, params, batch, 3)
    jax_ref = _jax_reference(cfg, batch, 3)

    ps = _strategy(cfg, num_stages=2, num_microbatches=4, lr=1e-2,
                   params=params)
    try:
        metrics = [ps.train_step(batch) for _ in range(3)]
        pipe_losses = [m["loss"] for m in metrics]
        np.testing.assert_allclose(ref_losses, pipe_losses, atol=ATOL)
        jax_params, jax_losses = jax_ref.result(timeout=120)
        np.testing.assert_allclose(pipe_losses, jax_losses, rtol=LOSS_TOL)
        assert pipe_losses[0] > pipe_losses[-1]  # it trains
        merged = ps.full_params()
        _assert_params(merged, ref_params, atol=ATOL)
        _assert_params(merged, jax_params, rel=PARAM_TOL)
        for m in metrics:
            assert 0.0 <= m["bubble_ratio"] < 1.0
            assert m["bubble_theoretical"] == pytest.approx(
                theoretical_bubble(2, 4))
            assert m["microbatches"] == 4
        _assert_spans_follow_the_schedule(ps.last_stage_stats, 2, 4)
    finally:
        ps.shutdown()


def test_pipeline_metrics_surface(cluster):
    """bubble gauge + microbatch counter reach the metric registry."""
    cfg = PipelinedConfig(n_virtual_stages=2, d_model=32, d_ff=64,
                          block_size=16)
    ps = _strategy(cfg, num_stages=2, num_microbatches=2, lr=1e-2)
    try:
        m_bubble, m_micro, m_virtual = _strategy_metrics()
        before = m_micro._values.get((), 0.0)
        out = ps.train_step(_toy_batch(cfg, B=4))
        assert m_micro._values.get((), 0.0) == before + 2
        exposed = "\n".join(m_bubble.expose())
        assert "train_pipeline_bubble_ratio" in exposed
        exposed_v = "\n".join(m_virtual.expose())
        assert "train_pipeline_virtual_stages" in exposed_v
        assert m_virtual._values.get((), 0.0) == 2.0  # flat: V == S
        assert out["loss"] > 0
    finally:
        ps.shutdown()


def test_torch_trainer_pipeline_strategy(cluster, tmp_path):
    """TorchTrainer(strategy='pipeline') drives the strategy end-to-end
    and returns a Result with per-step history."""
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    cfg_kwargs = dict(n_virtual_stages=2, d_model=32, d_ff=64,
                      block_size=16, num_microbatches=2)
    batch = _toy_batch(PipelinedConfig(**cfg_kwargs), B=4)
    result = TorchTrainer(
        strategy="pipeline",
        train_loop_config={"model": cfg_kwargs, "batch": batch,
                           "steps": 2, "num_stages": 2, "lr": 1e-2},
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False),
        run_config=RunConfig(name="pipe_t", storage_path=str(tmp_path)),
    ).fit()
    assert len(result.metrics_history) == 2
    assert result.metrics["loss"] > 0
    assert "bubble_ratio" in result.metrics
    # the port's Result also carries the last step's stage stats
    assert [st["stage"] for st in result.stage_stats] == [0, 1]
    assert len({st["pid"] for st in result.stage_stats} | {os.getpid()}) \
        == 3


def test_pipeline_strategy_rejects_bad_shapes(cluster):
    cfg = PipelinedConfig(n_virtual_stages=2, d_model=32, d_ff=64,
                          block_size=16)
    with pytest.raises(ValueError):
        # more stages than blocks
        _strategy(cfg, num_stages=3, num_microbatches=2)
    ps = _strategy(cfg, num_stages=2, num_microbatches=3)
    try:
        with pytest.raises(ValueError):
            ps.train_step(_toy_batch(cfg, B=4))  # 4 % 3 != 0
    finally:
        ps.shutdown()


def test_interleaved_strategy_matches_single_program(cluster):
    """num_repeats=2 (V=4 virtual stages on 2 workers): the circular
    schedule must be numerically invisible — same losses and merged
    params as the single-program oracles, and the metrics surface the
    interleaved theoretical floor."""
    cfg = PipelinedConfig()
    batch = _toy_batch(cfg, B=8, seed=2)
    params = _jax_params(cfg)
    ref_params, ref_losses = _port_reference(cfg, params, batch, 3)
    jax_ref = _jax_reference(cfg, batch, 3)

    ps = _strategy(cfg, num_stages=2, num_microbatches=4, lr=1e-2,
                   params=params, num_repeats=2)
    try:
        metrics = [ps.train_step(batch) for _ in range(3)]
        losses = [m["loss"] for m in metrics]
        np.testing.assert_allclose(ref_losses, losses, atol=ATOL)
        jax_params, jax_losses = jax_ref.result(timeout=120)
        np.testing.assert_allclose(losses, jax_losses, rtol=LOSS_TOL)
        merged = ps.full_params()
        _assert_params(merged, ref_params, atol=ATOL)
        _assert_params(merged, jax_params, rel=PARAM_TOL)
        for m in metrics:
            assert m["num_repeats"] == 2
            assert m["virtual_stages"] == 4
            assert m["bubble_theoretical"] == pytest.approx(
                theoretical_bubble_interleaved(2, 4, 2))
        _assert_spans_follow_the_schedule(ps.last_stage_stats, 2, 4, R=2)
    finally:
        ps.shutdown()


def test_pipeline_zero_composition_parity_and_bytes(cluster):
    """One config, every axis: interleaved (R=2) pipeline with
    intra-stage ZeRO over data_parallel=2 (each stage two gloo
    processes). Losses must still match the single-program oracles
    (ZeRO is a memory layout, not an algorithm change), and the
    per-stage resident grad/param bytes must land at ~1/D of the
    undistributed run's."""
    cfg = PipelinedConfig()
    batch = _toy_batch(cfg, B=8, seed=4)
    params = _jax_params(cfg)
    _, ref_losses = _port_reference(cfg, params, batch, 1)
    jax_ref = _jax_reference(cfg, batch, 1)

    def run(ps):
        try:
            losses = [ps.train_step(batch)["loss"] for _ in range(3)]
            return losses, ps.last_stage_stats
        finally:
            ps.shutdown()

    base, zero = _strategies(
        cfg, *(dict(num_stages=2, num_microbatches=4, lr=1e-2,
                    params=params, num_repeats=2, zero_stage=z,
                    data_parallel=d, momentum=0.9)
               for z, d in ((0, 1), (3, 2))))
    try:
        base_losses, base_stats = run(base)
        z_losses, z_stats = run(zero)
    finally:
        zero.shutdown()
    # momentum=0.9 diverges from the momentum-0 oracle — compare the
    # two momentum runs to each other, and the first (pre-update) loss
    # to the oracles'
    assert z_losses[0] == pytest.approx(ref_losses[0], abs=ATOL)
    _, jax_losses = jax_ref.result(timeout=120)
    assert z_losses[0] == pytest.approx(jax_losses[0], rel=LOSS_TOL)
    np.testing.assert_allclose(base_losses, z_losses, atol=ATOL)
    assert len(base_stats) == len(z_stats) == 2  # one per stage
    D, bound = 2, 1.25 / 2
    for b, z in zip(base_stats, z_stats):
        assert z["grad_state_bytes"] / b["grad_state_bytes"] <= bound
        assert z["param_state_bytes"] / b["param_state_bytes"] <= bound
        assert z["velocity_state_bytes"] / b["velocity_state_bytes"] \
            <= bound


def test_emulated_bubble_interleaved_below_flat(cluster):
    """The measured-bubble gate: in schedule-emulation mode (modeled op
    latency through the real submission/actor/accounting path — immune
    to single-core contention), interleaved R=2 must measure a strictly
    smaller bubble than flat at equal S and M."""
    cfg = PipelinedConfig(d_model=32, d_ff=64, block_size=16)
    batch = _toy_batch(cfg, B=8)

    def measure(ps):
        try:
            ps.train_step(batch)  # warm the dispatch path
            return np.mean([ps.train_step(batch)["bubble_ratio"]
                            for _ in range(3)])
        finally:
            ps.shutdown()

    # op times large vs dispatch overhead so a loaded CI box can't blur
    # the schedule-shape difference into the noise
    ps_flat, ps_inter = _strategies(
        cfg, *(dict(num_stages=2, num_microbatches=4, lr=1e-2,
                    num_repeats=R, emulate_ms=(60.0, 120.0))
               for R in (1, 2)))
    try:
        flat = measure(ps_flat)
        inter = measure(ps_inter)
    finally:
        ps_inter.shutdown()
    assert inter < flat, (inter, flat)
    # both sit at/above their theoretical floors (sanity on the lane)
    assert flat > theoretical_bubble(2, 4) - 1e-6
    assert inter > theoretical_bubble_interleaved(2, 4, 2) - 1e-6


def test_pipeline_checkpoint_round_trip(cluster, tmp_path):
    """save_checkpoint writes per-stage shards + manifest;
    load_pipeline_checkpoint reassembles the exact full param tree."""
    cfg = PipelinedConfig(d_model=32, d_ff=64, block_size=16)
    ps = _strategy(cfg, num_stages=2, num_microbatches=2, lr=1e-2,
                   num_repeats=2)
    try:
        ps.train_step(_toy_batch(cfg, B=4))
        ckpt = ps.save_checkpoint(str(tmp_path / "ck"))
        want = ps.full_params()
    finally:
        ps.shutdown()
    got, meta = load_pipeline_checkpoint(ckpt.path)
    assert meta["format"] == "pipeline-stage-shards-v1"
    assert meta["num_stages"] == 2 and meta["num_repeats"] == 2
    for (_, a), (_, b) in zip(_leaves(want), _leaves(got)):
        np.testing.assert_array_equal(a, b)
    # restore path: a fresh strategy seeded from the checkpoint params
    # continues from the same weights
    ps2 = _strategy(cfg, num_stages=2, num_microbatches=2, lr=1e-2,
                    params=got)
    try:
        for (_, a), (_, b) in zip(_leaves(got),
                                  _leaves(ps2.full_params())):
            np.testing.assert_array_equal(a, b)
    finally:
        ps2.shutdown()


def test_torch_trainer_pipeline_checkpoints(cluster, tmp_path):
    """TorchTrainer(strategy='pipeline') registers stage-shard
    checkpoints through CheckpointManager and hands back the latest."""
    from ray_tpu_torch.train import (
        CheckpointConfig,
        RunConfig,
        ScalingConfig,
        TorchTrainer,
    )

    cfg_kwargs = dict(n_virtual_stages=4, d_model=32, d_ff=64,
                      block_size=16, num_microbatches=2)
    batch = _toy_batch(PipelinedConfig(**cfg_kwargs), B=4)
    result = TorchTrainer(
        strategy="pipeline",
        train_loop_config={"model": cfg_kwargs, "batch": batch,
                           "steps": 2, "num_stages": 2,
                           "num_repeats": 2, "lr": 1e-2},
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False),
        run_config=RunConfig(
            name="pipe_ck", storage_path=str(tmp_path),
            checkpoint_config=CheckpointConfig(num_to_keep=1)),
    ).fit()
    assert result.checkpoint is not None
    params, meta = load_pipeline_checkpoint(result.checkpoint.path)
    assert meta["num_repeats"] == 2
    assert len(list(_leaves(params))) > 0


# ------------------------------------------------------ the port's own


def test_reads_a_checkpoint_the_jax_strategy_wrote(tmp_path):
    """The JAX strategy's own `save_checkpoint` (over its stage workers'
    `get_params`, cloudpickled numpy trees) writes a directory; the
    port's `load_pipeline_checkpoint` reads it with the same meta and
    the leaves of JAX's own `load_pipeline_checkpoint`."""
    import jax

    from ray_tpu.models import pipelined as jpl
    from ray_tpu.train import pipeline_strategy as jps

    jcfg = jpl.PipelinedConfig(d_model=32, d_ff=64, block_size=16)
    S, R = 2, 2
    stages = jpl.split_pipeline_stages_interleaved(
        jpl.init_pipelined(jax.random.PRNGKey(3), jcfg), jcfg, S, R)
    workers = []
    for s in range(S):
        w = jps.PipelineStageWorker(s, S)
        w.params = stages[s]
        workers.append(w)
    fake = types.SimpleNamespace(
        wg=types.SimpleNamespace(
            execute=lambda method: [getattr(w, method)() for w in workers]),
        num_stages=S, num_repeats=R, zero_stage=0, data_parallel=1,
        cfg=jcfg)
    jps.PipelineStrategy.save_checkpoint(fake, str(tmp_path / "jax_ck"))

    want, want_meta = jps.load_pipeline_checkpoint(str(tmp_path / "jax_ck"))
    got, meta = load_pipeline_checkpoint(str(tmp_path / "jax_ck"))
    assert meta == want_meta
    assert meta["format"] == "pipeline-stage-shards-v1"
    pairs = list(zip(_leaves(got), _leaves(jax.tree.map(np.asarray,
                                                        want))))
    assert len(pairs) == 8
    for (pg, g), (pw, w) in pairs:
        assert pg == pw
        np.testing.assert_array_equal(g, w)


def test_cuda_device_without_a_gpu_share_raises():
    cfg = PipelinedConfig(n_virtual_stages=2, d_model=32, d_ff=64,
                          block_size=16)
    with pytest.raises(ValueError, match="claims no GPU"):
        PipelineStrategy(cfg, num_stages=2, num_microbatches=2,
                         resources_per_worker={"CPU": 1.0},
                         device="cuda")


def test_busy_clock_keeps_bubble_non_negative(cluster):
    """On the CPU, with torch running several intra-op threads in each
    stage process, process CPU time can exceed an op's wall span; the
    busy clock bounds it by the span, so a flat step's measured bubble
    stays in [0, 1)."""
    cfg = PipelinedConfig(d_model=256, d_ff=1024, block_size=64)
    batch = _toy_batch(cfg, B=8)
    ps = _strategy(cfg, num_stages=2, num_microbatches=4, lr=1e-2)
    try:
        for _ in range(3):
            m = ps.train_step(batch)
            assert 0.0 <= m["bubble_ratio"] < 1.0, m
            for st in ps.last_stage_stats:
                assert st["intra_op_threads"] == STAGE_THREADS > 1, st
                assert 0.0 < st["busy_s"] <= st["busy_wall_s"] \
                    <= st["window_s"] + 1e-9, st
    finally:
        ps.shutdown()

