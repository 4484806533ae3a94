"""The port's core API in local mode (ray_tpu_torch.core: api.py on
`LocalRuntime`) against the JAX package's, scenario by scenario: every
scenario of tests/test_core_api_local.py, plus streaming generators and
the timeline, runs through ``ray_tpu.init(local_mode=True)`` and
``ray_tpu_torch.init(local_mode=True)`` in turn. The results must be
equal, and where a scenario raises, the exception's type and the chain
of its causes (a `TaskError`'s ``cause``, then ``__cause__``) must be
the same, by name, with the same root message. Then what the port does
differently: ``num_gpus`` and the "GPU" resource, ``init()`` without
local mode booting the cluster runtime, `ActorMethod.bind` raising until
dag/ is ported, and objects passed by reference."""

import time

import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu.core import exceptions as jax_exc
from ray_tpu_torch.core import exceptions as port_exc

PACKAGES = {"jax": (ray_tpu, jax_exc), "port": (ray_tpu_torch, port_exc)}


def _chain(e: BaseException) -> list[str]:
    out = []
    while e is not None:
        out.append(type(e).__name__)
        e = getattr(e, "cause", None) or e.__cause__
    return out


def _root(e: BaseException) -> str:
    while (getattr(e, "cause", None) or e.__cause__) is not None:
        e = getattr(e, "cause", None) or e.__cause__
    return str(e)


def _outcome(fn):
    """("value", result) or ("raised", exception chain, root message)."""
    try:
        return ("value", fn())
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        return ("raised", _chain(e), _root(e))


# ------------------------------------------------------------ scenarios
# each takes the package and its exceptions module, and returns what the
# JAX test asserts on


def task_roundtrip(ray, exc):
    @ray.remote
    def add(a, b):
        return a + b

    return ray.get(add.remote(1, 2))


def put_get(ray, exc):
    return ray.get(ray.put({"x": [1, 2, 3]}))


def objectref_args_resolved(ray, exc):
    @ray.remote
    def double(x):
        return 2 * x

    ref = ray.put(21)
    return ray.get(double.remote(ref)), ray.get(double.remote(
        double.remote(ref)))


def num_returns(ray, exc):
    @ray.remote(num_returns=3)
    def three():
        return 1, 2, 3

    a, b, c = three.remote()
    return ray.get([a, b, c])


def task_error_propagates(ray, exc):
    @ray.remote
    def boom():
        raise ValueError("nope")

    return _outcome(lambda: ray.get(boom.remote()))


def retry_exceptions(ray, exc):
    state = {"n": 0}

    @ray.remote(max_retries=3, retry_exceptions=True)
    def flaky():
        state["n"] += 1
        if state["n"] < 3:
            raise RuntimeError("transient")
        return state["n"]

    return ray.get(flaky.remote())


def wait(ray, exc):
    @ray.remote
    def fast():
        return "fast"

    @ray.remote
    def slow():
        time.sleep(5)
        return "slow"

    f, s = fast.remote(), slow.remote()
    ready, not_ready = ray.wait([f, s], num_returns=1, timeout=2)
    return ready == [f], not_ready == [s]


def get_timeout(ray, exc):
    @ray.remote
    def slow():
        time.sleep(10)

    # the message names the ref, which differs run to run
    out = _outcome(lambda: ray.get(slow.remote(), timeout=0.1))[:2]
    try:
        ray.get(slow.remote(), timeout=0.1)
    except exc.GetTimeoutError as e:
        return out, isinstance(e, TimeoutError)
    return out, None


def actor_state_and_order(ray, exc):
    @ray.remote
    class Counter:
        def __init__(self, start=0):
            self.n = start

        def inc(self, k=1):
            self.n += k
            return self.n

        def value(self):
            return self.n

    c = Counter.remote(10)
    refs = [c.inc.remote() for _ in range(5)]
    return ray.get(refs), ray.get(c.value.remote())


def named_actor(ray, exc):
    @ray.remote
    class Store:
        def __init__(self):
            self.d = {}

        def set(self, k, v):
            self.d[k] = v

        def get(self, k):
            return self.d.get(k)

    Store.options(name="kv").remote()
    h = ray.get_actor("kv")
    ray.get(h.set.remote("a", 1))
    first = ray.get(h.get.remote("a"))
    taken = _outcome(lambda: Store.options(name="kv").remote())
    h2 = Store.options(name="kv", get_if_exists=True).remote()
    return first, taken, ray.get(h2.get.remote("a"))


def kill_actor(ray, exc):
    @ray.remote
    class A:
        def ping(self):
            return "pong"

    a = A.remote()
    pong = ray.get(a.ping.remote())
    ray.kill(a)
    # the message names the package's kill()
    return pong, _outcome(lambda: ray.get(a.ping.remote()))[:2]


def actor_error_propagates(ray, exc):
    @ray.remote
    class B:
        def bad(self):
            raise KeyError("missing")

    b = B.remote()
    return _outcome(lambda: ray.get(b.bad.remote()))


def nested_tasks(ray, exc):
    @ray.remote
    def inner(x):
        return x * 2

    @ray.remote
    def outer(x):
        return ray.get(inner.remote(x)) + 1

    return ray.get(outer.remote(10))


def actor_handle_passing(ray, exc):
    @ray.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def inc(self):
            self.n += 1
            return self.n

    @ray.remote
    def bump(counter):
        return ray.get(counter.inc.remote())

    c = Counter.remote()
    return ray.get(bump.remote(c)), ray.get(bump.remote(c))


def runtime_context(ray, exc):
    return len(ray.get_runtime_context().get_node_id())


def options_validation(ray, exc):
    def make():
        @ray.remote(bogus_option=1)
        def f():
            pass

    return _outcome(make)


def streaming_generator(ray, exc):
    @ray.remote(num_returns="streaming")
    def gen(n):
        for i in range(n):
            yield i * i

    @ray.remote(num_returns="streaming")
    def broken():
        yield 1
        raise RuntimeError("half way")

    it = broken.remote()
    first = ray.get(next(it))
    return ([ray.get(r) for r in gen.remote(5)], first,
            _outcome(lambda: next(it)))


def timeline(ray, exc):
    @ray.remote
    def f():
        return 1

    ray.get([f.remote() for _ in range(3)])
    return sorted((e["name"], e["cat"]) for e in ray.timeline())


SCENARIOS = [task_roundtrip, put_get, objectref_args_resolved, num_returns,
             task_error_propagates, retry_exceptions, wait, get_timeout,
             actor_state_and_order, named_actor, kill_actor,
             actor_error_propagates, nested_tasks, actor_handle_passing,
             runtime_context, options_validation, streaming_generator,
             timeline]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda s: s.__name__)
def test_local_mode_matches_jax(scenario):
    got = {}
    for name, (ray, exc) in PACKAGES.items():
        ray.init(local_mode=True, num_cpus=8)
        try:
            got[name] = scenario(ray, exc)
        finally:
            ray.shutdown()
    assert got["port"] == got["jax"]


def test_expected_outcomes():
    """The JAX test's own assertions hold on the port (the parity test
    above would also pass if both packages were wrong the same way)."""
    ray = ray_tpu_torch
    ray.init(local_mode=True, num_cpus=8)
    try:
        assert task_error_propagates(ray, port_exc) == (
            "raised", ["TaskError", "ValueError"], "nope")
        assert actor_error_propagates(ray, port_exc)[1] == [
            "TaskError", "KeyError"]
        assert kill_actor(ray, port_exc)[1][1] == ["ActorDiedError"]
        timed_out, is_timeout_error = get_timeout(ray, port_exc)
        assert timed_out == ("raised", ["GetTimeoutError"])
        assert is_timeout_error
        assert named_actor(ray, port_exc) == (
            1, ("raised", ["ValueError"], "actor name 'kv' already taken"),
            1)
        assert options_validation(ray, port_exc)[1] == ["ValueError"]
        assert actor_state_and_order(ray, port_exc) == (
            [11, 12, 13, 14, 15], 15)
        assert nested_tasks(ray, port_exc) == 21
        assert wait(ray, port_exc) == (True, True)
    finally:
        ray.shutdown()


def test_num_gpus_is_the_accelerator():
    """The port counts GPUs where the JAX package counts TPUs: the
    option and init argument are num_gpus, the resource "GPU";
    num_tpus is no option of the port."""
    from ray_tpu_torch.core import options

    ray = ray_tpu_torch
    ray.init(local_mode=True, num_cpus=4, num_gpus=1)
    try:
        assert ray.cluster_resources() == {"CPU": 4, "GPU": 1}

        @ray.remote(num_gpus=1)
        def where():
            return "ran"

        assert ray.get(where.remote()) == "ran"
    finally:
        ray.shutdown()
    assert options.task_options({"num_gpus": 1}).resource_request() == {
        "CPU": 1.0, "GPU": 1}
    assert options.actor_options({"num_gpus": 0.5, "num_cpus": 0}
                                 ).resource_request() == {"GPU": 0.5}
    with pytest.raises(ValueError, match="invalid task option"):
        options.task_options({"num_tpus": 1})


def test_init_without_local_mode_boots_the_cluster():
    """init() without local_mode=True boots a head, a nodelet and worker
    processes (the cluster runtime), and put/get work on it."""
    from ray_tpu_torch.core.cluster_runtime import ClusterRuntime

    assert not ray_tpu_torch.is_initialized()
    ray_tpu_torch.init(num_cpus=1)
    try:
        rt = ray_tpu_torch.core.api._global_runtime()
        assert isinstance(rt, ClusterRuntime)
        assert ray_tpu_torch.cluster_resources()["CPU"] == 1.0
        big = torch.arange(1 << 16, dtype=torch.float32)
        refs = [ray_tpu_torch.put(1), ray_tpu_torch.put(big)]
        assert ray_tpu_torch.get(refs[0], timeout=30) == 1
        assert torch.equal(ray_tpu_torch.get(refs[1], timeout=30), big)
    finally:
        ray_tpu_torch.shutdown()
    assert not ray_tpu_torch.is_initialized()


def test_bind_raises_until_dag_is_ported():
    """`dag/` is ported: `bind` builds a graph node in local mode too,
    and raises, as JAX's does, on an argument that is no graph node."""
    from ray_tpu_torch.dag import ClassMethodNode, InputNode

    ray = ray_tpu_torch
    ray.init(local_mode=True)
    try:
        @ray.remote
        class A:
            def f(self, x):
                return x

        a = A.remote()
        with InputNode() as inp:
            node = a.f.bind(inp)
        assert isinstance(node, ClassMethodNode)
        assert node.method_name == "f" and node.upstream == [inp]
        with pytest.raises(TypeError, match="DAG nodes"):
            a.f.bind(1)
    finally:
        ray.shutdown()


def test_objects_pass_by_reference():
    """Local mode keeps objects in the process: get returns the object a
    task returned or put stored, so a tensor's storage is shared (on the
    card, a CUDA tensor is not copied)."""
    ray = ray_tpu_torch
    ray.init(local_mode=True)
    try:
        t = torch.arange(4.0)
        assert ray.get(ray.put(t)) is t

        @ray.remote
        def make():
            return torch.ones(3)

        @ray.remote
        def same(x, y):
            return x.data_ptr() == y.data_ptr()

        ref = make.remote()
        assert ray.get(same.remote(ref, ref))
    finally:
        ray.shutdown()


def test_no_auto_init_refuses_to_boot_a_runtime():
    """The port's own case: a background path wrapped in `no_auto_init`
    raises where the module API would boot a new runtime after
    ``shutdown()``; outside it, the API still boots one on demand."""
    from ray_tpu_torch.core.api import no_auto_init

    assert not ray_tpu_torch.is_initialized()
    with no_auto_init():
        with pytest.raises(RuntimeError, match="shut down"):
            ray_tpu_torch.put(1)
    assert not ray_tpu_torch.is_initialized()

