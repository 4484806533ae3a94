"""The port's pipeline schedules (ray_tpu_torch.parallel.pipeline)
against the JAX package's: the 1F1B and interleaved schedule math (the
per-stage orders, the submission orders and the simulated and
theoretical bubbles) at the parametrisations of
tests/test_pipeline_strategy.py, and the in-program `pipeline_apply`
and `pipeline_apply_interleaved` on four gloo ranks of the CPU, at
pipe=4 and at (data=2, pipe=2), against the JAX functions under the
JAX ``shard_map`` on four CPU devices of the same mesh shape: the
output within 1e-5, the gradients of the stacked params and of the
input within atol 1e-4, rtol 1e-3 (tests/test_pipeline.py).

The ranks run in one spawn for the module (test_torch_collectives.py's
`run_ranks`); jax is imported only inside functions of this module,
never on the ranks' import path."""

import numpy as np
import pytest

from tests.test_torch_collectives import run_ranks

FWD_TOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-3
D = 8
# (name, mesh, kind, S*R stacked stages, batch, microbatches, repeats)
CASES = (
    ("gpipe_pipe4", {"pipe": 4}, "gpipe", 4, 16, None, 1),
    ("gpipe_pipe4_m8", {"pipe": 4}, "gpipe", 4, 32, 8, 1),
    ("interleaved_pipe4", {"pipe": 4}, "interleaved", 8, 16, 8, 2),
    ("gpipe_data2_pipe2", {"data": 2, "pipe": 2}, "gpipe", 2, 16, 4, 1),
    ("interleaved_data2_pipe2", {"data": 2, "pipe": 2}, "interleaved", 4,
     16, 4, 2),
)


def _inputs(V, B, seed):
    rng = np.random.RandomState(seed)
    return {"w": (rng.normal(size=(V, D, D)) * 0.5).astype(np.float32),
            "b": (rng.normal(size=(V, D)) * 0.1).astype(np.float32)}, \
        rng.normal(size=(B, D)).astype(np.float32)


def _order(V, S):
    """Round-robin placement: virtual stage v at rank v % S, slot v // S."""
    return np.argsort(np.arange(V) % S, kind="stable")


def _stacked(params, kind, S):
    if kind == "gpipe":
        return params
    order = _order(params["w"].shape[0], S)
    return {k: v[order] for k, v in params.items()}


def _pipe_body(rank):
    """Every case on this rank: {case: (out, grads)} as numpy, whole."""
    import torch

    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu_torch.parallel.ops import shard_map
    from ray_tpu_torch.parallel.pipeline import (
        pipeline_apply,
        pipeline_apply_interleaved,
    )
    from ray_tpu_torch.parallel.sharding import PartitionSpec as P
    from ray_tpu_torch.parallel.sharding import placements
    from torch.distributed.tensor import distribute_tensor

    def stage_fn(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    out = {}
    for seed, (name, shape, kind, V, B, M, R) in enumerate(CASES):
        mesh = build_mesh(MeshSpec(**shape), device="cpu")
        S = shape["pipe"]
        params, x = _inputs(V, B, seed)
        params = _stacked(params, kind, S)
        xspec = P("data") if "data" in shape else P()
        wspec = P("pipe")

        def body(w, b, xx):
            if kind == "gpipe":
                return pipeline_apply(
                    lambda q, h: stage_fn({k: v[0] for k, v in q.items()},
                                          h),
                    {"w": w, "b": b}, xx, "pipe", num_microbatches=M)
            return pipeline_apply_interleaved(
                stage_fn, {"w": w, "b": b}, xx, "pipe",
                num_microbatches=M, num_repeats=R)

        leaves = [distribute_tensor(torch.from_numpy(params[k]), mesh,
                                    placements(wspec, mesh))
                  .requires_grad_(True) for k in ("w", "b")]
        xd = distribute_tensor(torch.from_numpy(x), mesh,
                               placements(xspec, mesh)).requires_grad_(True)
        y = shard_map(body, mesh, in_specs=(wspec, wspec, xspec),
                      out_specs=xspec)(*leaves, xd)
        (y ** 2).sum().backward()
        out[name] = (y.full_tensor().detach().numpy(),
                     [t.grad.full_tensor().numpy() for t in leaves + [xd]])
    return out if rank == 0 else None


def _jax_cases():
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from ray_tpu.parallel import ops
    from ray_tpu.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu.parallel.pipeline import (
        pipeline_apply,
        pipeline_apply_interleaved,
    )

    def stage_fn(p, h):
        return jnp.tanh(h @ p["w"] + p["b"])

    out = {}
    for seed, (name, shape, kind, V, B, M, R) in enumerate(CASES):
        mesh = build_mesh(MeshSpec(**{"data": 1, "tensor": 1, **shape}),
                          devices=jax.devices()[:4])
        S = shape["pipe"]
        params, x = _inputs(V, B, seed)
        params = jax.tree.map(jnp.asarray, _stacked(params, kind, S))
        xspec = P("data") if "data" in shape else P()

        def body(p, xx):
            if kind == "gpipe":
                return pipeline_apply(
                    lambda q, h: stage_fn(jax.tree.map(lambda a: a[0], q),
                                          h), p, xx, "pipe",
                    num_microbatches=M)
            return pipeline_apply_interleaved(
                stage_fn, p, xx, "pipe", num_microbatches=M,
                num_repeats=R)

        f = ops.shard_map(body, mesh, in_specs=(P("pipe"), xspec),
                          out_specs=xspec)
        y = f(params, jnp.asarray(x))
        gp, gx = jax.grad(lambda p, xx: jnp.sum(f(p, xx) ** 2),
                          argnums=(0, 1))(params, jnp.asarray(x))
        out[name] = (np.asarray(y), [np.asarray(gp["w"]),
                                     np.asarray(gp["b"]), np.asarray(gx)])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ranks, want = run_ranks(_pipe_body, tmp_path_factory.mktemp("pipe"),
                            meanwhile=_jax_cases)
    return ranks[0], want


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_pipeline_forward_matches_jax(runs, name):
    got, want = runs
    np.testing.assert_allclose(got[name][0], want[name][0], atol=FWD_TOL,
                               rtol=FWD_TOL)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_pipeline_gradients_match_jax(runs, name):
    got, want = runs
    for g, w, what in zip(got[name][1], want[name][1], ("w", "b", "x")):
        np.testing.assert_allclose(g, w, atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=f"{name} d{what}")
        assert np.abs(w).max() > 0


def test_pipeline_matches_sequential_stages(runs):
    """The pipe=4 GPipe output is the four stages applied in order."""
    got, _ = runs
    params, x = _inputs(4, 16, 0)
    h = x
    for i in range(4):
        h = np.tanh(h @ params["w"][i] + params["b"][i])
    np.testing.assert_allclose(got["gpipe_pipe4"][0], h, atol=FWD_TOL,
                               rtol=FWD_TOL)


# ------------------------------------------------------------- schedule

SCHEDULES = [(1, 1), (1, 4), (2, 4), (3, 5), (4, 8), (4, 2), (5, 3),
             (1, 2), (3, 6), (4, 4), (2, 1)]
INTERLEAVED = [(2, 4, 2), (2, 2, 3), (3, 6, 2), (4, 8, 2), (2, 8, 4),
               (2, 4, 3), (4, 4, 4)]


def _both():
    from ray_tpu.parallel import pipeline as jp

    from ray_tpu_torch.parallel import pipeline as tp

    return jp, tp


@pytest.mark.parametrize("S,M", SCHEDULES)
def test_1f1b_schedule_and_order_match_jax(S, M):
    jp, tp = _both()
    assert tp.one_f_one_b_schedule(S, M) == jp.one_f_one_b_schedule(S, M)
    assert tp.one_f_one_b_submission_order(S, M) == \
        jp.one_f_one_b_submission_order(S, M)
    for costs in ((1.0, 1.0), (1.0, 2.0)):
        assert tp.simulate_1f1b(S, M, *costs) == jp.simulate_1f1b(S, M,
                                                                  *costs)
    assert tp.theoretical_bubble(S, M) == jp.theoretical_bubble(S, M)


@pytest.mark.parametrize("S,M,R", INTERLEAVED)
def test_interleaved_schedule_matches_jax(S, M, R):
    jp, tp = _both()
    assert tp.interleaved_1f1b_submission_order(S, M, R) == \
        jp.interleaved_1f1b_submission_order(S, M, R)
    assert tp.simulate_interleaved_1f1b(S, M, R) == \
        jp.simulate_interleaved_1f1b(S, M, R)
    assert tp.theoretical_bubble_interleaved(S, M, R) == \
        jp.theoretical_bubble_interleaved(S, M, R)


def test_schedule_errors_match_jax():
    jp, tp = _both()
    for mod in (jp, tp):
        with pytest.raises(ValueError):
            mod.interleaved_1f1b_submission_order(4, 3, 2)
        with pytest.raises(ValueError):
            mod.interleaved_1f1b_submission_order(2, 4, 0)
        with pytest.raises(ValueError):
            mod.one_f_one_b_schedule(0, 4)
