"""The state API's serve part: the port of ``serve_status`` and
``llm_status`` of ``ray_tpu/util/state.py``.

The rest of the JAX module (the cluster listings, `summarize`,
`cluster_metrics` and its history, alerts, `debug_dump`) is not ported
yet (ROADMAP.md, queue 1).
"""

from __future__ import annotations


def serve_status(address: str | None = None) -> dict:
    """Serve apps + per-replica health + per-proxy request metrics
    (reference: `ray serve status` / the serve state surface). The
    ``health`` key carries the self-healing plane's per-app view —
    live replicas with probe-miss counts, restart totals, degraded
    flags, and the bounded replica lifecycle history (deaths with
    reasons, replacements, restart-cap events) — so a post-mortem can
    reconstruct WHEN each replica died and why. The serve control
    plane lives in actors, so this needs a runtime: with `address`
    given it connects to that head when no runtime exists, and refuses
    to silently answer from a DIFFERENT cluster than the one asked
    about."""
    import ray_tpu_torch as ray
    from ray_tpu_torch import serve

    if address is not None:
        if not ray.is_initialized():
            ray.init(address=address)
        else:
            from ray_tpu_torch.core.api import _global_runtime

            current = getattr(_global_runtime(), "head_address", None)
            if current is not None and current != address:
                raise ValueError(
                    f"runtime is connected to {current!r}, not "
                    f"{address!r}; serve status reflects the connected "
                    "cluster")
    return serve.status()


def llm_status(app_name: str, timeout: float = 30) -> list[dict]:
    """Per-replica LLM engine stats for a `serve.llm` app: queue depth,
    running lanes, cache utilization, preemptions, weight version,
    cumulative request-phase seconds. One dict per replica (the handle
    routes to a single replica; this asks the controller for the full
    set). Probes ride the replicas' control concurrency group, so they
    answer even while every request lane is mid-stream. `timeout`
    bounds EACH of the two round trips (controller, then replicas)."""
    import ray_tpu_torch as ray
    from ray_tpu_torch.serve.api import _CONTROLLER_NAME

    ctrl = ray.get_actor(_CONTROLLER_NAME)
    r = ray.get(ctrl.get_replicas.remote(app_name), timeout=timeout)
    if not r["replicas"]:
        raise ValueError(f"no serve application named {app_name!r}")
    refs = [rep.handle_request.options(
        concurrency_group="control").remote("engine_stats", (), {})
        for rep in r["replicas"]]
    return ray.get(refs, timeout=timeout)
