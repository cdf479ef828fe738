"""ray_tpu_torch.serve: online model serving (counterpart of
``ray_tpu/serve``).

Upstream Ray Serve's shape (python/ray/serve/): a controller reconciling
deployments to replica actors, power-of-two-choices routing, deployment
handles with dataflow composition, queue-depth autoscaling, and an HTTP
proxy on the standard library's ``ThreadingHTTPServer``, all on the
in-process runtime (``ray_tpu_torch.core``) or, with the driver attached to
a cluster, on its worker processes. ``llm.build_openai_app`` serves a model
through it, and ``build_disagg_openai_app`` (``serve/disagg.py``) serves one
as a prefill pool, a decode pool and an ingress that pins each decode wait
to the replica holding the request's KV.

Not ported: the gRPC and RPC ingresses (``start_grpc_ingress``,
``start_rpc_ingress`` raise); ROADMAP.md Queue 1, item 6, part 5.
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
from ray_tpu_torch.serve.disagg import (
    DecodeServer,
    DisaggIngress,
    PrefillServer,
    build_disagg_openai_app,
)
from ray_tpu_torch.serve.handle import DeploymentHandle, DeploymentResponse
from ray_tpu_torch.serve.proxy import Request
from ray_tpu_torch.serve.router import ReplicaPinError

__all__ = [
    "Application",
    "AutoscalingConfig",
    "Deployment",
    "DeploymentConfig",
    "DeploymentHandle",
    "DeploymentResponse",
    "DecodeServer",
    "DisaggIngress",
    "HTTPOptions",
    "PrefillServer",
    "ReplicaPinError",
    "Request",
    "build_disagg_openai_app",
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
