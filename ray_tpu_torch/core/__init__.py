"""ray_tpu_torch.core — the task/actor/object API, the port of
``ray_tpu.core``.

So far its in-process runtime: `LocalRuntime` (``runtime.py``) runs
tasks on threads and each actor on its own ordered thread, with the
JAX package's semantics for object refs, streams, retries, named
actors and kill. ``init(local_mode=True)`` starts it. The cluster
runtime (controller, nodelets, worker processes, the object store and
its serialization) is not ported yet, and ``init()`` without
``local_mode`` raises.
"""
