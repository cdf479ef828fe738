"""Serve public API: @deployment, bind, run, status, shutdown (counterpart
of ``ray_tpu/serve/api.py``).

Upstream analog: python/ray/serve/api.py (serve.run :591,
@serve.deployment, serve.start, serve.status, serve.delete) and
deployment graph binding (Deployment.bind -> Application). The controller
is a detached named actor (CONTROLLER_NAME) of the in-process runtime,
found or created on demand. ``ray_actor_options`` takes ``num_gpus``.
Beside the HTTP proxy, ``start_rpc_ingress`` and ``start_grpc_ingress``
open the framed-RPC and gRPC front doors: one of each kind, stopped by
``shutdown`` before the controller.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, replace
from typing import Any, Callable, Optional, Union

from ray_tpu_torch.serve.config import (
    AutoscalingConfig,
    DeploymentConfig,
    HTTPOptions,
    ReplicaConfig,
)
from ray_tpu_torch.serve.controller import CONTROLLER_NAME, ServeController
from ray_tpu_torch.serve.handle import DeploymentHandle

_lock = threading.Lock()
_controller_handle = None
_proxy = None


# ---------------------------------------------------------------------------
# deployment + application graph
# ---------------------------------------------------------------------------


@dataclass
class Deployment:
    """The decorated, configurable unit (reference: serve.Deployment)."""

    func_or_class: Union[type, Callable]
    name: str
    deployment_config: DeploymentConfig
    num_cpus: float = 1.0
    num_gpus: float = 0.0
    resources: Optional[dict] = None

    def options(self, **kwargs) -> "Deployment":
        dc_fields = {
            "num_replicas",
            "max_ongoing_requests",
            "max_queued_requests",
            "user_config",
            "autoscaling_config",
            "health_check_period_s",
            "health_check_timeout_s",
            "graceful_shutdown_timeout_s",
            "role",
        }
        dc_updates = {k: v for k, v in kwargs.items() if k in dc_fields}
        rest = {k: v for k, v in kwargs.items() if k not in dc_fields}
        actor_opts = rest.pop("ray_actor_options", None)
        if isinstance(dc_updates.get("autoscaling_config"), dict):
            dc_updates["autoscaling_config"] = AutoscalingConfig(
                **dc_updates["autoscaling_config"]
            )
        if dc_updates.get("num_replicas") == "auto":
            dc_updates["num_replicas"] = 1
            dc_updates.setdefault(
                "autoscaling_config", AutoscalingConfig(min_replicas=1, max_replicas=100)
            )
        new = replace(self, deployment_config=replace(self.deployment_config, **dc_updates))
        if actor_opts:
            new.num_cpus = actor_opts.get("num_cpus", new.num_cpus)
            new.num_gpus = actor_opts.get("num_gpus", new.num_gpus)
            new.resources = actor_opts.get("resources", new.resources)
        for k, v in rest.items():
            if not hasattr(new, k):
                raise TypeError(f"unknown deployment option {k!r}")
            setattr(new, k, v)
        return new

    def bind(self, *args, **kwargs) -> "Application":
        return Application(self, args, kwargs)

    def __call__(self, *a, **k):
        raise TypeError(
            f"deployment {self.name} cannot be called directly; deploy it with "
            f"serve.run(dep.bind(...)) and call the returned handle"
        )


class Application:
    """A bound deployment node; init args may contain other Applications
    (composition DAG, reference: serve built-app graph)."""

    def __init__(self, deployment: Deployment, args: tuple, kwargs: dict):
        self._deployment = deployment
        self._args = args
        self._kwargs = kwargs


def deployment(
    _func_or_class=None,
    *,
    name: Optional[str] = None,
    num_replicas: Union[int, str, None] = None,
    max_ongoing_requests: int = 100,
    max_queued_requests: int = -1,
    user_config: Any = None,
    autoscaling_config: Union[AutoscalingConfig, dict, None] = None,
    health_check_period_s: float = 2.0,
    health_check_timeout_s: float = 30.0,
    graceful_shutdown_timeout_s: float = 10.0,
    role: str = "",
    ray_actor_options: Optional[dict] = None,
):
    """@serve.deployment decorator."""

    def build(target) -> Deployment:
        nonlocal autoscaling_config, num_replicas
        if isinstance(autoscaling_config, dict):
            autoscaling_config = AutoscalingConfig(**autoscaling_config)
        if num_replicas == "auto":
            num_replicas = 1
            if autoscaling_config is None:
                autoscaling_config = AutoscalingConfig(min_replicas=1, max_replicas=100)
        dcfg = DeploymentConfig(
            num_replicas=int(num_replicas or 1),
            max_ongoing_requests=max_ongoing_requests,
            max_queued_requests=max_queued_requests,
            user_config=user_config,
            autoscaling_config=autoscaling_config,
            health_check_period_s=health_check_period_s,
            health_check_timeout_s=health_check_timeout_s,
            graceful_shutdown_timeout_s=graceful_shutdown_timeout_s,
            role=role,
        )
        opts = ray_actor_options or {}
        return Deployment(
            func_or_class=target,
            name=name or target.__name__,
            deployment_config=dcfg,
            num_cpus=opts.get("num_cpus", 1.0),
            num_gpus=opts.get("num_gpus", 0.0),
            resources=opts.get("resources"),
        )

    if _func_or_class is not None:
        return build(_func_or_class)
    return build


# ---------------------------------------------------------------------------
# controller / proxy lifecycle
# ---------------------------------------------------------------------------


def _get_controller_handle():
    global _controller_handle
    import ray_tpu_torch

    with _lock:
        if _controller_handle is not None:
            from ray_tpu_torch.core.actor_runtime import ActorState

            if _controller_handle.state != ActorState.DEAD:
                return _controller_handle
            _controller_handle = None
        try:
            _controller_handle = ray_tpu_torch.get_actor(CONTROLLER_NAME)
        except ValueError:
            _controller_handle = (
                ray_tpu_torch.remote(ServeController)
                .options(name=CONTROLLER_NAME, lifetime="detached", num_cpus=0)
                .remote()
            )
        return _controller_handle


def start(http_options: Optional[HTTPOptions] = None, **kwargs) -> None:
    """Start the Serve control plane + HTTP proxy (reference: serve.start)."""
    global _proxy
    if http_options is None:
        http_options = HTTPOptions(**kwargs) if kwargs else HTTPOptions()
    controller = _get_controller_handle()
    with _lock:
        if _proxy is None:
            from ray_tpu_torch.serve.proxy import HTTPProxy

            _proxy = HTTPProxy(http_options.host, http_options.port, controller)


_rpc_ingress = None
_grpc_ingress = None


def _get_or_create_ingress(kind: str, factory, host: str, port: int):
    """One ingress of each kind. Asking for another address than the live
    one's raises: handing back an ingress elsewhere would leave external
    clients on a dead port."""
    global _rpc_ingress, _grpc_ingress
    controller = _get_controller_handle()
    with _lock:
        current = _grpc_ingress if kind == "grpc" else _rpc_ingress
        if current is None:
            current = factory(host, port, controller)
            if kind == "grpc":
                _grpc_ingress = current
            else:
                _rpc_ingress = current
        elif (host, port) != ("127.0.0.1", 0) and (
                current.addr[0] != host or (port != 0 and current.addr[1] != port)):
            raise RuntimeError(f"{kind} ingress already bound at {current.addr}; cannot rebind "
                               f"to ({host}, {port}); serve.shutdown() first")
        return current


def start_grpc_ingress(host: str = "127.0.0.1", port: int = 0):
    """Start the standards-based gRPC front door: any generated client stub
    works, deployments exchange serialized protobuf bytes. Returns the
    ingress; its ``.addr`` is the bound address."""
    from ray_tpu_torch.serve.grpc_ingress import GrpcIngress

    return _get_or_create_ingress("grpc", GrpcIngress, host, port)


def start_rpc_ingress(host: str = "127.0.0.1", port: int = 0):
    """Start the binary front door over the framed-RPC plane; returns the
    ingress with its bound ``.addr``."""
    from ray_tpu_torch.serve.rpc_ingress import RpcIngress

    return _get_or_create_ingress("rpc", RpcIngress, host, port)


def _collect_deployments(app: Application):
    """Walk the bound-argument DAG; return ({name: (Deployment, args, kwargs)},
    ingress_name) with nested Applications replaced by handle placeholders."""
    seen: dict[str, tuple] = {}

    def visit(node: Application) -> "_HandlePlaceholder":
        dep = node._deployment
        args = tuple(visit(a) if isinstance(a, Application) else a for a in node._args)
        kwargs = {
            k: visit(v) if isinstance(v, Application) else v
            for k, v in node._kwargs.items()
        }
        if dep.name in seen and seen[dep.name][0].func_or_class is not dep.func_or_class:
            raise ValueError(f"duplicate deployment name {dep.name!r} in application")
        seen[dep.name] = (dep, args, kwargs)
        return _HandlePlaceholder(dep.name)

    ingress = visit(app).name
    return seen, ingress


@dataclass
class _HandlePlaceholder:
    name: str


def _materialize(value, app_name: str):
    if isinstance(value, _HandlePlaceholder):
        return DeploymentHandle(value.name, app_name)
    return value


def run(
    target: Application,
    *,
    name: str = "default",
    route_prefix: Optional[str] = "/",
    blocking: bool = False,
    _start_proxy: bool = True,
    wait_for_ingress_timeout_s: float = 60.0,
) -> DeploymentHandle:
    """Deploy an application; returns a handle to its ingress deployment."""
    import ray_tpu_torch

    if isinstance(target, Deployment):
        target = target.bind()
    if not isinstance(target, Application):
        raise TypeError(f"serve.run expects an Application, got {type(target)}")

    controller = _get_controller_handle()
    if _start_proxy and route_prefix is not None:
        start()

    deployments, ingress = _collect_deployments(target)
    payload = []
    for dep_name, (dep, args, kwargs) in deployments.items():
        import inspect

        is_function = not inspect.isclass(dep.func_or_class)
        args = tuple(_materialize(a, name) for a in args)
        kwargs = {k: _materialize(v, name) for k, v in kwargs.items()}
        rcfg = ReplicaConfig(
            callable_factory=dep.func_or_class,
            init_args=args,
            init_kwargs=kwargs,
            num_cpus=dep.num_cpus,
            num_gpus=dep.num_gpus,
            resources=dep.resources or {},
            is_function=is_function,
        )
        payload.append((dep_name, dep.deployment_config, rcfg))

    ray_tpu_torch.get(
        controller.deploy_application.remote(name, route_prefix, ingress, payload),
        timeout=wait_for_ingress_timeout_s,
    )
    _wait_healthy(controller, name, wait_for_ingress_timeout_s)
    handle = DeploymentHandle(ingress, name)
    if blocking:
        try:
            while True:
                time.sleep(1)
        except KeyboardInterrupt:
            pass
    return handle


def _wait_healthy(controller, app_name: str, timeout_s: float) -> None:
    import ray_tpu_torch

    deadline = time.time() + timeout_s
    while time.time() < deadline:
        st = ray_tpu_torch.get(controller.status.remote())
        app = st["applications"].get(app_name)
        if app and app["status"] == "RUNNING":
            return
        if app and app["status"] in ("DEPLOY_FAILED", "UNHEALTHY"):
            raise RuntimeError(f"application {app_name} failed to deploy: {app}")
        time.sleep(0.05)
    raise TimeoutError(f"application {app_name} not healthy after {timeout_s}s")


# ---------------------------------------------------------------------------
# status / handles / teardown
# ---------------------------------------------------------------------------


def status() -> dict:
    import ray_tpu_torch

    return ray_tpu_torch.get(_get_controller_handle().status.remote())


def get_app_handle(name: str = "default") -> DeploymentHandle:
    import ray_tpu_torch

    controller = _get_controller_handle()
    ingress = ray_tpu_torch.get(controller.get_ingress.remote(name))
    if ingress is None:
        raise ValueError(f"application {name!r} not found")
    return DeploymentHandle(ingress, name)


def get_deployment_handle(deployment_name: str, app_name: str = "default") -> DeploymentHandle:
    return DeploymentHandle(deployment_name, app_name)


def delete(name: str) -> None:
    import ray_tpu_torch
    from ray_tpu_torch.serve import handle as _handle_mod

    ray_tpu_torch.get(_get_controller_handle().delete_application.remote(name))
    with _handle_mod._ROUTERS_LOCK:
        for key in [k for k in _handle_mod._ROUTERS if k[0] == name]:
            del _handle_mod._ROUTERS[key]


def shutdown() -> None:
    global _controller_handle, _proxy, _rpc_ingress, _grpc_ingress
    import ray_tpu_torch
    from ray_tpu_torch.serve.handle import _drop_routers

    _drop_routers()
    with _lock:
        proxy, _proxy = _proxy, None
        ingress, _rpc_ingress = _rpc_ingress, None
        gingress, _grpc_ingress = _grpc_ingress, None
        controller, _controller_handle = _controller_handle, None
    if gingress is not None:
        gingress.shutdown()
    if ingress is not None:
        ingress.shutdown()
    if proxy is not None:
        proxy.shutdown()
    if controller is not None:
        try:
            # the controller waits for its replicas' drains (bounded by their
            # graceful_shutdown_timeout_s)
            ray_tpu_torch.get(controller.shutdown.remote(), timeout=60)
            ray_tpu_torch.kill(controller)
        except Exception:
            pass
