"""ray_tpu_torch.serve: online model serving (counterpart of
``ray_tpu/serve``).

Upstream Ray Serve's shape (python/ray/serve/): a controller reconciling
deployments to replica actors, power-of-two-choices routing, deployment
handles with dataflow composition, queue-depth autoscaling, and an HTTP
proxy on the standard library's ``ThreadingHTTPServer``, all on the
in-process runtime (``ray_tpu_torch.core``). ``llm.build_openai_app``
serves a model through it.

Not ported: the gRPC and RPC ingresses (``start_grpc_ingress``,
``start_rpc_ingress`` raise) and ``serve/disagg.py``; ROADMAP.md Queue 1,
item 6 (a later part).
"""

from ray_tpu_torch.serve.api import (
    Application,
    Deployment,
    delete,
    deployment,
    get_app_handle,
    get_deployment_handle,
    run,
    shutdown,
    start,
    start_grpc_ingress,
    start_rpc_ingress,
    status,
)
from ray_tpu_torch.serve.config import AutoscalingConfig, DeploymentConfig, HTTPOptions
from ray_tpu_torch.serve.handle import DeploymentHandle, DeploymentResponse
from ray_tpu_torch.serve.proxy import Request

__all__ = [
    "Application",
    "AutoscalingConfig",
    "Deployment",
    "DeploymentConfig",
    "DeploymentHandle",
    "DeploymentResponse",
    "HTTPOptions",
    "Request",
    "delete",
    "deployment",
    "get_app_handle",
    "get_deployment_handle",
    "run",
    "shutdown",
    "start",
    "start_grpc_ingress",
    "start_rpc_ingress",
    "status",
]
