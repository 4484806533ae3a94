"""The port's ring and Ulysses attention
(ray_tpu_torch.parallel.ring_attention) on four gloo ranks of the CPU,
sequence-sharded over a seq=4 mesh, against the JAX package's functions
under the JAX ``shard_map`` on four CPU devices: ring attention causal
and full, Ulysses with its default plain attention and with
``ops.attention.causal_attention`` (the flash kernels' entry point,
whose plain versions run on the CPU), outputs within 2e-5 and the
gradients of sum(sin(out)) with respect to q, k and v within atol 1e-4,
rtol 1e-3 (tests/test_ring_attention.py); Ulysses through
`causal_attention` equals its default.

The ranks run in one spawn for the module (test_torch_collectives.py's
`run_ranks`); jax is imported only inside functions of this module."""

import numpy as np
import pytest

from tests.test_torch_collectives import run_ranks

OUT_TOL = 2e-5
GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-3
SAME_TOL = 1e-5  # the flash plain versions against the einsum reference
N = 4
# (name, jax function, causal, the port's attn_fn for Ulysses, seed)
CASES = (("ring_causal", "ring", True, None, 0),
         ("ring_full", "ring", False, None, 1),
         ("ulysses", "ulysses", True, None, 2),
         ("ulysses_flash", "ulysses", True, "flash", 2))


def _qkv(seed, B=2, T=64, H=4, D=16):
    rng = np.random.RandomState(seed)
    return [rng.normal(size=(B, T, H, D)).astype(np.float32)
            for _ in range(3)]


def _ring_body(rank):
    import torch

    from ray_tpu_torch.ops.attention import causal_attention
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu_torch.parallel.ops import shard_map
    from ray_tpu_torch.parallel.ring_attention import (
        ring_attention,
        ulysses_attention,
    )
    from ray_tpu_torch.parallel.sharding import PartitionSpec as P

    mesh = build_mesh(MeshSpec(seq=N, data=1), device="cpu")
    spec = P(None, "seq")
    out = {}
    for name, fn, causal, attn, seed in CASES:
        if fn == "ring":
            def body(a, b, c, causal=causal):
                return ring_attention(a, b, c, "seq", causal=causal)
        else:
            def body(a, b, c, attn=attn):
                return ulysses_attention(
                    a, b, c, "seq",
                    attn_fn=causal_attention if attn else None)
        qkv = [torch.from_numpy(a).requires_grad_(True)
               for a in _qkv(seed)]
        y = shard_map(body, mesh, in_specs=spec, out_specs=spec)(*qkv)
        torch.sin(y).sum().backward()
        out[name] = (y.full_tensor().detach().numpy(),
                     [t.grad.numpy() for t in qkv])
    return out if rank == 0 else None


def _jax_cases():
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from ray_tpu.parallel import ops
    from ray_tpu.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu.parallel.ring_attention import (
        ring_attention,
        ulysses_attention,
    )

    mesh = build_mesh(MeshSpec(data=1, seq=N, tensor=1),
                      devices=jax.devices()[:N])
    out = {}
    for name, fn, causal, _, seed in CASES:
        if fn == "ring":
            def body(a, b, c, causal=causal):
                return ring_attention(a, b, c, "seq", causal=causal)
        else:
            def body(a, b, c):
                return ulysses_attention(a, b, c, "seq")
        f = ops.shard_map(body, mesh, in_specs=P(None, "seq"),
                          out_specs=P(None, "seq"))
        q, k, v = (jnp.asarray(a) for a in _qkv(seed))
        grads = jax.grad(lambda *a: jnp.sum(jnp.sin(f(*a))),
                         argnums=(0, 1, 2))(q, k, v)
        out[name] = (np.asarray(f(q, k, v)), [np.asarray(g) for g in grads])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ranks, want = run_ranks(_ring_body, tmp_path_factory.mktemp("ring"),
                            meanwhile=_jax_cases)
    return ranks[0], want


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_output_matches_jax(runs, name):
    got, want = runs
    np.testing.assert_allclose(got[name][0], want[name][0], atol=OUT_TOL,
                               rtol=OUT_TOL)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_gradients_match_jax(runs, name):
    got, want = runs
    for g, w, what in zip(got[name][1], want[name][1], "qkv"):
        np.testing.assert_allclose(g, w, atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=f"{name} d{what}")


def test_ulysses_through_causal_attention_equals_default(runs):
    got, _ = runs
    np.testing.assert_allclose(got["ulysses_flash"][0], got["ulysses"][0],
                               atol=SAME_TOL, rtol=SAME_TOL)
    for g, w in zip(got["ulysses_flash"][1], got["ulysses"][1]):
        np.testing.assert_allclose(g, w, atol=SAME_TOL, rtol=SAME_TOL)


def test_ring_matches_numpy(runs):
    """The causal and the full ring against softmax attention in numpy
    on the same inputs."""
    got, _ = runs
    for name, causal, seed in (("ring_causal", True, 0),
                               ("ring_full", False, 1)):
        q, k, v = _qkv(seed)
        s = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(q.shape[-1])
        if causal:
            T = q.shape[1]
            s = np.where(np.tril(np.ones((T, T), bool)), s, -1e30)
        p = np.exp(s - s.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        np.testing.assert_allclose(got[name][0],
                                   np.einsum("bhqk,bkhd->bqhd", p, v),
                                   atol=OUT_TOL, rtol=OUT_TOL)
