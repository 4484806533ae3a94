"""The metric catalog — the single machine-readable registry of every
metric the port can emit: the port's copy of
``ray_tpu/util/metrics_catalog.py``.

Three consumers keep each other honest through it (the drift gate in
tests/test_torch_observability4.py):

- the SOURCE: every ``Counter/Gauge/Histogram("name", ...)`` literal in
  ``ray_tpu_torch/`` (extracted by `source_metrics()`, an AST scan)
  must have a catalog entry, and vice versa;
- the DOCS: OBSERVABILITY.md's catalog table names the JAX package's
  metrics; the port's catalog equals those rows less `DEVIATIONS`;
- the DASHBOARD: the timeseries panels of the committed
  dashboards/ray_tpu.json, less `DEVIATIONS`, are the catalog's names.

`DEVIATIONS` names the JAX metrics the port does not register, each
with why: the four XLA compile metrics (the port compiles no program).
"""

from __future__ import annotations

import ast
import os

# (name, type, where, what) — grouped/ordered like OBSERVABILITY.md
CATALOG: list[dict] = [
    # train
    {"name": "train_step_seconds", "type": "histogram",
     "where": "ray_tpu_torch/train/spmd.py",
     "what": "host-side train-step dispatch time"},
    {"name": "train_step_phase_seconds", "type": "histogram",
     "where": "ray_tpu_torch/train/spmd.py",
     "what": "per-step waterfall phases incl. collective.<op> buckets "
             "(attribution runs only)"},
    {"name": "train_optimizer_state_bytes", "type": "gauge",
     "where": "ray_tpu_torch/train/spmd.py",
     "what": "per-chip optimizer-state bytes, by layout "
             "(replicated|zero1) — the ZeRO-1 memory win"},
    {"name": "train_grad_state_bytes", "type": "gauge",
     "where": "ray_tpu_torch/train/spmd.py",
     "what": "per-chip resident grad-accum bytes, by layout "
             "(replicated|zero2) — the ZeRO-2 memory win"},
    {"name": "train_param_state_bytes", "type": "gauge",
     "where": "ray_tpu_torch/train/spmd.py",
     "what": "per-chip resident param bytes, by layout "
             "(replicated|zero3) — the ZeRO-3 memory win"},
    {"name": "train_zero_gather_share", "type": "gauge",
     "where": "ray_tpu_torch/train/spmd.py",
     "what": "all-gather share of train step time at zero_stage >= 3 "
             "(attribution runs) — the JIT param-gather cost"},
    {"name": "train_pipeline_bubble_ratio", "type": "gauge",
     "where": "ray_tpu_torch/train/pipeline_strategy.py",
     "what": "measured 1F1B bubble fraction of the last pipeline step"},
    {"name": "train_pipeline_virtual_stages", "type": "gauge",
     "where": "ray_tpu_torch/train/pipeline_strategy.py",
     "what": "virtual stages (stages x repeats) of the running "
             "pipeline — > stages means interleaved 1F1B is active"},
    {"name": "train_microbatches_total", "type": "counter",
     "where": "ray_tpu_torch/train/pipeline_strategy.py",
     "what": "microbatches executed by the pipeline train strategy"},
    # collectives
    {"name": "collective_seconds", "type": "histogram",
     "where": "ray_tpu_torch/util/collective.py",
     "what": "host-side collective wall time (offer -> ready)"},
    # object plane
    {"name": "object_store_pull_bytes_total", "type": "counter",
     "where": "ray_tpu_torch/core/nodelet.py",
     "what": "inbound node-to-node object transfer bytes"},
    {"name": "object_store_pull_seconds", "type": "histogram",
     "where": "ray_tpu_torch/core/nodelet.py",
     "what": "inbound node-to-node object transfer latency"},
    {"name": "object_store_push_bytes_total", "type": "counter",
     "where": "ray_tpu_torch/core/nodelet.py",
     "what": "bytes served to other nodes"},
    {"name": "object_store_bytes_allocated", "type": "gauge",
     "where": "ray_tpu_torch/core/nodelet.py",
     "what": "store occupancy in bytes (refreshed at scrape)"},
    {"name": "object_store_num_objects", "type": "gauge",
     "where": "ray_tpu_torch/core/nodelet.py", "what": "objects resident"},
    {"name": "object_store_evictions", "type": "gauge",
     "where": "ray_tpu_torch/core/nodelet.py", "what": "objects evicted"},
    {"name": "object_store_created_objects_total", "type": "counter",
     "where": "ray_tpu_torch/core/object_store.py",
     "what": "per-process store writes (count)"},
    {"name": "object_store_created_bytes_total", "type": "counter",
     "where": "ray_tpu_torch/core/object_store.py",
     "what": "per-process store writes (bytes)"},
    {"name": "object_store_stranded_bytes", "type": "gauge",
     "where": "ray_tpu_torch/core/cluster_runtime.py",
     "what": "bytes held by owned refs past the stranded-age threshold "
             "with no consumer progress (refreshed at scrape)"},
    # serve.llm engine
    {"name": "serve_llm_tokens_generated_total", "type": "counter",
     "where": "ray_tpu_torch/serve/llm/engine.py", "what": "tokens generated"},
    {"name": "serve_llm_requests_total", "type": "counter",
     "where": "ray_tpu_torch/serve/llm/engine.py",
     "what": "requests finished, by outcome"},
    {"name": "serve_llm_preemptions_total", "type": "counter",
     "where": "ray_tpu_torch/serve/llm/engine.py",
     "what": "sequences preempted on cache exhaustion"},
    {"name": "serve_llm_queue_depth", "type": "gauge",
     "where": "ray_tpu_torch/serve/llm/engine.py", "what": "waiting requests"},
    {"name": "serve_llm_running", "type": "gauge",
     "where": "ray_tpu_torch/serve/llm/engine.py",
     "what": "sequences in the decode set"},
    {"name": "serve_llm_cache_utilization", "type": "gauge",
     "where": "ray_tpu_torch/serve/llm/engine.py",
     "what": "KV pool pages in use / usable"},
    {"name": "serve_llm_tokens_per_sec", "type": "gauge",
     "where": "ray_tpu_torch/serve/llm/engine.py",
     "what": "generation throughput (~5s window)"},
    {"name": "serve_llm_ttft_ms", "type": "histogram",
     "where": "ray_tpu_torch/serve/llm/engine.py",
     "what": "time to first token"},
    {"name": "serve_llm_step_ms", "type": "histogram",
     "where": "ray_tpu_torch/serve/llm/engine.py",
     "what": "engine step latency, by kind"},
    {"name": "serve_llm_prefix_cache_hits_total", "type": "counter",
     "where": "ray_tpu_torch/serve/llm/engine.py",
     "what": "KV pages served from the prefix cache at admission"},
    {"name": "serve_llm_prefix_cache_misses_total", "type": "counter",
     "where": "ray_tpu_torch/serve/llm/engine.py",
     "what": "KV pages prefilled at admission"},
    {"name": "serve_llm_prefix_cache_evictions_total", "type": "counter",
     "where": "ray_tpu_torch/serve/llm/engine.py",
     "what": "cached refcount-0 pages evicted for reuse"},
    {"name": "serve_llm_prefix_cached_blocks", "type": "gauge",
     "where": "ray_tpu_torch/serve/llm/engine.py",
     "what": "refcount-0 pages retained for prefix reuse"},
    {"name": "serve_llm_prefill_chunks_total", "type": "counter",
     "where": "ray_tpu_torch/serve/llm/engine.py",
     "what": "prefill chunks run"},
    {"name": "serve_llm_prefill_stall_ms", "type": "histogram",
     "where": "ray_tpu_torch/serve/llm/engine.py",
     "what": "decode stall imposed by a prefill step"},
    {"name": "serve_llm_weight_swaps_total", "type": "counter",
     "where": "ray_tpu_torch/serve/llm/engine.py",
     "what": "weight hot-swaps installed at a step boundary"},
    {"name": "serve_llm_spec_proposed_total", "type": "counter",
     "where": "ray_tpu_torch/serve/llm/engine.py",
     "what": "draft tokens proposed to the speculative verify program"},
    {"name": "serve_llm_spec_accepted_total", "type": "counter",
     "where": "ray_tpu_torch/serve/llm/engine.py",
     "what": "draft tokens accepted by the verify program"},
    {"name": "serve_llm_spec_rejected_total", "type": "counter",
     "where": "ray_tpu_torch/serve/llm/engine.py",
     "what": "draft tokens rejected by the verify program (the "
             "spec-accept-collapse rule's miss side)"},
    {"name": "serve_llm_spec_accept_ratio", "type": "gauge",
     "where": "ray_tpu_torch/serve/llm/engine.py",
     "what": "cumulative accepted / proposed draft tokens"},
    {"name": "serve_llm_verify_step_ms", "type": "histogram",
     "where": "ray_tpu_torch/serve/llm/engine.py",
     "what": "speculative verify step latency (K+1-wide program)"},
    {"name": "serve_llm_paged_attn_enabled", "type": "gauge",
     "where": "ray_tpu_torch/serve/llm/engine.py",
     "what": "1 when decode/verify run the pallas paged-attention "
             "kernel, 0 on the dense gather fallback"},
    # serve SLO attribution (the per-request waterfall's metric face)
    {"name": "serve_slo_ttft_ms", "type": "histogram",
     "where": "ray_tpu_torch/serve/llm/engine.py",
     "what": "TTFT decomposed: phase=queue|prefill|total"},
    {"name": "serve_slo_tpot_ms", "type": "histogram",
     "where": "ray_tpu_torch/serve/llm/engine.py",
     "what": "decode seconds per output token after the first"},
    # serve proxy
    {"name": "serve_num_http_requests", "type": "counter",
     "where": "ray_tpu_torch/serve/api.py", "what": "HTTP ingress, by status"},
    {"name": "serve_http_request_latency_ms", "type": "histogram",
     "where": "ray_tpu_torch/serve/api.py", "what": "HTTP ingress latency"},
    # serve self-healing
    {"name": "serve_replica_health_checks_total", "type": "counter",
     "where": "ray_tpu_torch/serve/api.py",
     "what": "controller health probes, by result (ok|miss|dead)"},
    {"name": "serve_replica_restarts_total", "type": "counter",
     "where": "ray_tpu_torch/serve/api.py",
     "what": "replica replacements started by the self-healing loop"},
    {"name": "serve_replicas_healthy", "type": "gauge",
     "where": "ray_tpu_torch/serve/api.py",
     "what": "replicas passing their latest health probe round"},
    {"name": "serve_request_failovers_total", "type": "counter",
     "where": "ray_tpu_torch/serve/api.py",
     "what": "requests re-submitted after replica death (unary "
             "retries + mid-stream resumes)"},
    # RL flywheel
    {"name": "rl_rollout_tokens_total", "type": "counter",
     "where": "ray_tpu_torch/rllib/llm/rollout.py",
     "what": "tokens generated by RL rollouts"},
    {"name": "rl_reward_mean", "type": "gauge",
     "where": "ray_tpu_torch/rllib/llm/rollout.py",
     "what": "mean reward of the latest rollout batch"},
    {"name": "rl_traj_staleness", "type": "histogram",
     "where": "ray_tpu_torch/rllib/llm/learner.py",
     "what": "weight-version lag of offered trajectories"},
    {"name": "rl_traj_dropped_total", "type": "counter",
     "where": "ray_tpu_torch/rllib/llm/learner.py",
     "what": "trajectories refused by the staleness guard"},
    {"name": "rl_weight_swap_seconds", "type": "histogram",
     "where": "ray_tpu_torch/serve/llm/engine.py",
     "what": "drain-free weight hot-swap wall time"},
    # core fast path (coalesced submission + compiled DAGs)
    {"name": "rpc_oneway_batch_size", "type": "histogram",
     "where": "ray_tpu_torch/core/rpc.py",
     "what": "messages coalesced per flushed batch frame"},
    {"name": "core_submit_coalesced_total", "type": "counter",
     "where": "ray_tpu_torch/core/cluster_runtime.py",
     "what": "submissions/returns that rode a coalesced frame, by kind"},
    {"name": "dag_executions_total", "type": "counter",
     "where": "ray_tpu_torch/dag/__init__.py",
     "what": "compiled-DAG executions, by path (compiled|eager_fallback)"},
    # task flight recorder (lifecycle ledger)
    {"name": "task_queue_wait_seconds", "type": "histogram",
     "where": "ray_tpu_torch/core/nodelet.py",
     "what": "time tasks spend in a nodelet's dispatch queue (enqueue "
             "to dispatch) — the task-queue-stall rule's input"},
    {"name": "task_ledger_events_total", "type": "counter",
     "where": "ray_tpu_torch/core/task_ledger.py",
     "what": "lifecycle transitions ingested by the head task ledger"},
    {"name": "task_ledger_dropped_total", "type": "counter",
     "where": "ray_tpu_torch/core/task_ledger.py",
     "what": "lifecycle transitions dropped by the per-record "
             "transition cap — drops counted, never silent"},
    # profiler plane
    {"name": "core_task_cpu_seconds_total", "type": "counter",
     "where": "ray_tpu_torch/core/cluster_runtime.py",
     "what": "CPU seconds consumed executing tasks and actor methods, "
             "by kind (fed by the worker exec loop)"},
    {"name": "profile_captures_total", "type": "counter",
     "where": "ray_tpu_torch/util/profiler.py",
     "what": "sampling-profiler capture windows completed"},
    {"name": "profile_samples_total", "type": "counter",
     "where": "ray_tpu_torch/util/profiler.py",
     "what": "stack sample ticks taken across capture windows"},
    {"name": "profile_stacks_dropped_total", "type": "counter",
     "where": "ray_tpu_torch/util/profiler.py",
     "what": "thread-samples rejected by the unique-stack cap"},
    # log plane
    {"name": "log_records_total", "type": "counter",
     "where": "ray_tpu_torch/utils/logging.py",
     "what": "structured log records emitted, by level (the "
             "error-rate-spike rule's input)"},
    {"name": "log_bytes_total", "type": "counter",
     "where": "ray_tpu_torch/utils/logging.py",
     "what": "structured JSONL log bytes written"},
    {"name": "log_records_dropped_total", "type": "counter",
     "where": "ray_tpu_torch/utils/logging.py",
     "what": "log records lost to serialization/disk failure "
             "(drops counted, never silent)"},
    # span plane
    {"name": "spans_sampled_total", "type": "counter",
     "where": "ray_tpu_torch/utils/events.py",
     "what": "spans admitted into the local buffer, by category"},
    {"name": "spans_dropped_total", "type": "counter",
     "where": "ray_tpu_torch/utils/events.py",
     "what": "spans rejected (sampling policy or full buffer)"},
    # watchtower (alerting plane)
    {"name": "watchtower_alerts_firing", "type": "gauge",
     "where": "ray_tpu_torch/util/watchtower.py",
     "what": "alerts currently firing, by severity"},
    {"name": "watchtower_alerts_total", "type": "counter",
     "where": "ray_tpu_torch/util/watchtower.py",
     "what": "pending->firing transitions, by rule"},
    {"name": "watchtower_samples_total", "type": "counter",
     "where": "ray_tpu_torch/util/watchtower.py",
     "what": "metric-history sample ticks completed"},
    {"name": "watchtower_series", "type": "gauge",
     "where": "ray_tpu_torch/util/watchtower.py",
     "what": "metric-history series retained"},
    {"name": "watchtower_series_dropped_total", "type": "counter",
     "where": "ray_tpu_torch/util/watchtower.py",
     "what": "new series rejected by the history series cap"},
    {"name": "watchtower_autodumps_total", "type": "counter",
     "where": "ray_tpu_torch/util/watchtower.py",
     "what": "debug dumps auto-triggered by critical alerts"},
]


# JAX metrics with no port counterpart, and why
DEVIATIONS: dict[str, str] = {
    name: "counts XLA compiles; the port compiles no program"
    for name in ("train_compile_misses_total", "train_compile_seconds",
                 "serve_llm_compile_misses_total",
                 "serve_llm_compile_seconds")
}


def catalog_names() -> set[str]:
    return {m["name"] for m in CATALOG}


def source_metrics(package_root: str | None = None) -> dict[str, str]:
    """{metric name: type} for every Counter/Gauge/Histogram construction
    with a literal name in the package source — the 'registered at
    runtime' side of the drift gate, extracted statically so the gate
    covers paths no test instantiates."""
    if package_root is None:
        package_root = os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))
    found: dict[str, str] = {}
    for dirpath, dirnames, filenames in os.walk(package_root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in filenames:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            try:
                with open(path, encoding="utf-8") as f:
                    tree = ast.parse(f.read())
            except (OSError, SyntaxError):
                continue
            for node in ast.walk(tree):
                if not isinstance(node, ast.Call):
                    continue
                f_ = node.func
                ctor = (f_.id if isinstance(f_, ast.Name)
                        else f_.attr if isinstance(f_, ast.Attribute)
                        else None)
                if ctor in ("Counter", "Gauge", "Histogram") \
                        and node.args \
                        and isinstance(node.args[0], ast.Constant) \
                        and isinstance(node.args[0].value, str):
                    found[node.args[0].value] = ctor.lower()
    return found
