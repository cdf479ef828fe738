"""gRPC ingress: the standards-based front door beside HTTP and the
framed-RPC ingress (counterpart of ``ray_tpu/serve/grpc_ingress.py``).

No protoc step on the server side: a ``grpc.GenericRpcHandler`` accepts
any ``/package.Service/Method`` call, routes it through the controller's
route table, and hands the request's serialized bytes to the deployment:

  * the ``application`` request metadata selects the app (a single
    deployed app is the default);
  * the gRPC method name is the deployment method (``Predict`` for
    ``/user.Inference/Predict``); ``Call`` and ``__call__`` go to the
    ingress deployment's ``__call__``;
  * deployments take the request message's bytes and return bytes (or a
    protobuf message), so clients use their generated stubs unchanged.

Status codes: ``NOT_FOUND`` for routing errors only (an unknown or
ambiguous app), ``DEADLINE_EXCEEDED`` when the call times out (the core
runtime's and the cluster's timeout types; the client's deadline caps the
wait), ``INTERNAL`` for any other failure and for a result that is not
bytes. ``grpc`` is imported in ``GrpcIngress.__init__`` only, so
``ray_tpu_torch.serve`` imports without it.
"""

from __future__ import annotations

from ray_tpu_torch.serve.routes import AppResolver
from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("ray_tpu_torch.serve.grpc_ingress")


class GrpcIngress:
    def __init__(self, host: str, port: int, controller_handle, max_workers: int = 16):
        from concurrent import futures

        import grpc

        self._resolver = AppResolver(controller_handle, error_cls=KeyError)
        outer = self

        class _Handler(grpc.GenericRpcHandler):
            def service(self, handler_call_details):
                method = handler_call_details.method
                md = dict(handler_call_details.invocation_metadata or ())
                # no (de)serializers: raw message bytes in and out
                return grpc.unary_unary_rpc_method_handler(
                    lambda request, ctx: outer._dispatch(method, md, request, ctx))

        self._grpc = grpc
        self._server = grpc.server(futures.ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="serve-grpc"))
        self._server.add_generic_rpc_handlers((_Handler(),))
        bound = self._server.add_insecure_port(f"{host}:{port}")
        if bound == 0:
            raise RuntimeError(f"gRPC ingress failed to bind {host}:{port}")
        self.addr = (host, bound)
        self._server.start()

    def _dispatch(self, method: str, metadata: dict, request: bytes, ctx):
        grpc = self._grpc
        try:
            # routing errors only: a deployment's own KeyError must not read
            # as NOT_FOUND (clients re-resolve on that status)
            app, ingress = self._resolver.resolve(metadata.get("application"))
            handle = self._resolver.handle_for(app, ingress)
        except KeyError as e:
            ctx.abort(grpc.StatusCode.NOT_FOUND, str(e))
        try:
            mname = method.rsplit("/", 1)[-1]
            if mname not in ("Call", "__call__"):
                handle = getattr(handle, mname)
            timeout = float(metadata.get("request_timeout_s", 120.0))
            # the client's deadline caps the wait: an abandoned call must not
            # hold a pool thread for the rest of the server's budget
            remaining = ctx.time_remaining()
            if remaining is not None:
                timeout = min(timeout, max(0.1, remaining))
            out = handle.remote(request).result(timeout_s=timeout)
        except Exception as e:  # noqa: BLE001 — a deployment-level failure
            from ray_tpu_torch.cluster.client import GetTimeoutError as ClusterTimeout

            # the core runtime's GetTimeoutError is a TimeoutError; the
            # cluster's is a plain Exception
            if isinstance(e, (TimeoutError, ClusterTimeout)):
                ctx.abort(grpc.StatusCode.DEADLINE_EXCEEDED, str(e))
            logger.exception("gRPC ingress call failed")
            ctx.abort(grpc.StatusCode.INTERNAL, repr(e))
        if out is None:
            return b""
        if isinstance(out, (bytes, bytearray, memoryview)):
            return bytes(out)
        serialize = getattr(out, "SerializeToString", None)
        if serialize is not None:  # a protobuf message
            return serialize()
        ctx.abort(grpc.StatusCode.INTERNAL,
                  f"deployment returned {type(out).__name__}; gRPC responses must be bytes "
                  "or protobuf messages")

    def shutdown(self) -> None:
        # wait out the grace window: serve.shutdown() stops the controller
        # next, and draining calls must finish against a live control plane
        self._server.stop(grace=1.0).wait()
