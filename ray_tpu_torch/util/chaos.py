"""Deterministic fault injection for tests and game-days: the port of
``ray_tpu/util/chaos.py``.

Two planes compose here:

- RPC chaos (``ray_tpu_torch.core.rpc.set_chaos``): drop or delay the first N
  sends of a method in this process — exercises retry/timeout paths.
- Replica chaos (this module): abruptly kill a live serve replica —
  exercises the serve control plane's heal path (health loop, routing
  removal, replacement, handle failover) end to end.

``kill_replica`` is the injector the self-healing acceptance gate runs
on: it makes the replica's worker PROCESS exit immediately
(``os._exit`` — no finally blocks, no drain), which is what a real
OOM-kill, segfault, or node loss looks like to the rest of the
cluster. In ``local_mode`` there is no process to kill, so it falls
back to ``ray_tpu_torch.kill`` (the closest local-semantics equivalent).
"""

from __future__ import annotations


def set_chaos(spec: str) -> None:
    """Re-export of :func:`ray_tpu_torch.core.rpc.set_chaos` so test code has
    one chaos namespace (``"method=N"`` drops, ``"method=delayN"``
    delays)."""
    from ray_tpu_torch.core import rpc

    rpc.set_chaos(spec)


def list_replicas(app_name: str) -> list:
    """Live replica handles of a serve app, straight from the
    controller's routing set."""
    import ray_tpu_torch as ray
    from ray_tpu_torch.serve.api import _CONTROLLER_NAME

    ctrl = ray.get_actor(_CONTROLLER_NAME)
    r = ray.get(ctrl.get_replicas.remote(app_name), timeout=30)
    return list(r["replicas"])


def kill_replica(app_name: str, index: int | None = None,
                 busiest: bool = False) -> str:
    """Abruptly kill one replica of `app_name`; returns the killed
    replica's ident (the id handles/controllers route by).

    `index` picks a specific replica from the current routing set;
    `busiest=True` picks the one with the most ongoing requests (so a
    mid-stream kill provably lands on in-flight work); default is the
    first replica. The kill is a process exit injected over the
    replica's CONTROL concurrency group, so it fires even while every
    request lane is busy streaming. It returns once this process has
    seen the death (at most 30 s later)."""
    import ray_tpu_torch as ray
    from ray_tpu_torch.core.api import _global_runtime
    from ray_tpu_torch.serve.api import _replica_ident

    replicas = list_replicas(app_name)
    if not replicas:
        raise ValueError(f"no live replicas for app {app_name!r}")
    victim = replicas[index if index is not None else 0]
    if busiest and index is None and len(replicas) > 1:
        try:
            loads = ray.get(
                [r.ongoing.options(concurrency_group="control").remote()
                 for r in replicas], timeout=10)
            victim = replicas[max(range(len(loads)),
                                  key=lambda i: loads[i])]
        except Exception:  # noqa: BLE001
            pass  # probe raced a death: the default victim still dies
    ident = _replica_ident(victim)
    rt = _global_runtime()
    if rt.context_info().get("local_mode"):
        # local mode: replicas are threads in THIS process — os._exit
        # would kill the test itself. ray.kill is the local
        # equivalent of abrupt death (pending calls fail ActorDied).
        ray.kill(victim)
        return ident
    # the process exits before any reply can be sent, so the ref
    # resolves to ActorDiedError once the death is known here: waiting
    # for it means a call made after this returns cannot still reach
    # the dying process (JAX's kill fires and forgets). The wait goes to
    # this runtime, not the module's, so a kill fired from a thread that
    # outlives shutdown() boots no new runtime.
    ref = victim.chaos_exit.options(concurrency_group="control").remote()
    try:
        rt.get([ref], timeout=30)
    except Exception:  # noqa: BLE001  # the death, or a slow report of it
        pass
    return ident
