"""ray_tpu_torch.serve — model serving on the port's cluster runtime,
the port of ``ray_tpu.serve``: deployments, the controller with its
health loop, handles with failover, the HTTP (and, where grpcio is
installed, gRPC) proxy, and the LLM engine and its deployment
(``serve.llm``).

Reference parity: ray.serve (python/ray/serve/) — `@serve.deployment`
classes become groups of replica actors managed by a controller actor
(_private/controller.py:84); requests route through a DeploymentHandle
with least-queue replica choice (power-of-two-choices router,
_private/router.py:318); an optional HTTP proxy exposes apps over REST
(_private/proxy.py — here a dedicated proxy ACTOR bound on the node
IP); load-driven replica autoscaling tracks mean ongoing requests
(autoscaling_state.py); app graphs compose deployments by binding
Applications into init args (build_app.py:68).
"""

from ray_tpu_torch.serve.api import (
    Application,
    AutoscalingConfig,
    Deployment,
    DeploymentHandle,
    delete,
    deployment,
    get_app_handle,
    grpc_proxy_address,
    proxy_address,
    run,
    shutdown,
    start_proxy,
    start_proxy_fleet,
    status,
)

__all__ = [
    "Application",
    "AutoscalingConfig",
    "Deployment",
    "DeploymentHandle",
    "delete",
    "deployment",
    "get_app_handle",
    "grpc_proxy_address",
    "proxy_address",
    "run",
    "shutdown",
    "start_proxy",
    "start_proxy_fleet",
    "status",
]
