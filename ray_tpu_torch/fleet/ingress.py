"""FleetServer: the multi-tenant OpenAI-compatible ingress (counterpart of
``ray_tpu/fleet/ingress.py``; its payloads are the reference's).

One HTTP surface in front of a FleetManager. Differences from the
single-model ``llm.openai_api.LLMServer``:

 * **model refs** — ``"model"`` selects ``base`` or ``base:adapter``
   (the multiplex convention); the adapter loads on the routed replica
   on demand, LRU-evicting an idle one when the slot budget is full;
 * **tenant identity** — the ``x-tenant-id`` header (or the OpenAI
   ``user`` field as the fallback) binds the request to a TenantSpec;
   unknown tenants are refused up front unless the spec opts into a
   default tenant;
 * **admission** — per-tenant weighted-fair QoS (fleet.qos) replaces the
   single engine-wide controller: a batch tenant flooding its own queue
   share never prices a paying tenant's admission, and the tenant's
   priority rides into the engine to arm priority preemption.

Handlers are async (``await server(request)`` with any object that has
``method``, ``path``, ``json()`` and ``headers``), but the engine path is
the runner's thread + queue machinery — blocking drains run in the
default executor, mirroring LLMServer. Replicas run on ``device`` (the card
unless the caller asks for the CPU).
"""

from __future__ import annotations

import asyncio
import logging
import time
import uuid
from typing import Any, Optional

from ray_tpu_torch.fleet.config import (
    FleetError,
    FleetSpec,
    UnknownModelError,
    UnknownTenantError,
)
from ray_tpu_torch.fleet.manager import FleetAdmissionRejected, FleetManager
from ray_tpu_torch.llm.engine import AdapterSlotsExhausted
from ray_tpu_torch.llm.openai_api import (
    ByteTokenizer,
    _sse_transcript,
    default_chat_template,
)
from ray_tpu_torch.llm.sampling import SamplingParams

logger = logging.getLogger("ray_tpu_torch.fleet.ingress")

TENANT_HEADER = "x-tenant-id"


def _error(message: str, code: int, type_: str = "invalid_request_error",
           **extra) -> dict:
    return {"error": {"message": message, "type": type_, "code": code,
                      **extra}}


class FleetServer:
    """The fleet's OpenAI surface (serve ingress callable)."""

    def __init__(self, spec: FleetSpec, engine_config: Any = None,
                 params: Any = None, tokenizer: Any = None, seed: int = 0,
                 thresholds: Any = None, device: Any = "cuda"):
        self.spec = spec
        self.manager = FleetManager(
            spec, engine_config=engine_config, params=params, seed=seed,
            thresholds=thresholds, device=device,
        )
        first = self.manager.replicas(spec.models[0].model_id)[0]
        self.tokenizer = tokenizer or ByteTokenizer(
            first.engine.config.model.vocab_size
        )
        eos = getattr(self.tokenizer, "eos_token_id", 2)
        for m in spec.models:
            for r in self.manager.replicas(m.model_id):
                r.engine.config.eos_token_id = eos

    # -- identity -------------------------------------------------------------

    def _tenant_id(self, body: dict, headers: Optional[dict]) -> str:
        for k, v in (headers or {}).items():
            if k.lower() == TENANT_HEADER:
                return str(v)
        return str(body.get("user", "") or "")

    def _sampling_from_body(self, body: dict) -> SamplingParams:
        return SamplingParams(
            max_tokens=int(body.get("max_tokens", 64)),
            temperature=float(body.get("temperature", 1.0)),
            top_k=int(body.get("top_k", 0)),
            top_p=float(body.get("top_p", 1.0)),
            seed=body.get("seed"),
            logprobs=bool(body.get("logprobs", False)),
        )

    # -- request path ---------------------------------------------------------

    async def _generate(self, tenant_id: str, model_ref: str,
                        prompt_ids: list, sp: SamplingParams,
                        request_id: Optional[str] = None,
                        timeout_s: float = 120.0):
        """Submit + collect one request through the fleet (QoS admission,
        routing, adapter residency all inside manager.submit). Returns
        (text_tokens, finish_reason)."""
        loop = asyncio.get_running_loop()
        ticket = self.manager.submit(
            tenant_id, model_ref, prompt_ids, sampling_params=sp,
            request_id=request_id,
        )
        try:
            out = await loop.run_in_executor(
                None, lambda: self.manager.collect(ticket, timeout_s)
            )
        except BaseException:
            self.manager.abort(ticket)
            raise
        toks = list(out.output_token_ids)
        eos = ticket.replica.engine.config.eos_token_id
        if toks and toks[-1] == eos:
            toks = toks[:-1]
        return toks, out.finish_reason

    async def completions(self, body: dict,
                          headers: Optional[dict] = None) -> Any:
        tenant_id = self._tenant_id(body, headers)
        model_ref = str(body.get("model") or self.spec.models[0].model_id)
        try:
            sp = self._sampling_from_body(body)
        except (ValueError, TypeError) as e:
            return _error(str(e), 400)
        prompts = body.get("prompt", "")
        if not isinstance(prompts, list):
            prompts = [prompts]
        rid = f"cmpl-{uuid.uuid4().hex[:24]}"
        try:
            id_lists = [self.tokenizer.encode(str(p)) for p in prompts]
            results = await asyncio.gather(*[
                self._generate(
                    tenant_id, model_ref, ids, sp,
                    request_id=rid if len(id_lists) == 1 else f"{rid}-{i}",
                )
                for i, ids in enumerate(id_lists)
            ])
        except FleetAdmissionRejected as e:
            return e.payload
        except UnknownTenantError as e:
            return _error(str(e), 401, type_="invalid_tenant")
        except (UnknownModelError, FleetError) as e:
            return _error(str(e), 404, type_="model_not_found")
        except AdapterSlotsExhausted as e:
            return _error(str(e), 503, type_="overloaded", retry_after=1)
        n_prompt = sum(len(ids) for ids in id_lists)
        n_out = sum(len(toks) for toks, _ in results)
        payload = {
            "id": rid,
            "object": "text_completion",
            "created": int(time.time()),
            "model": model_ref,
            "choices": [
                {
                    "index": i,
                    "text": self.tokenizer.decode(toks),
                    "finish_reason": reason,
                    "logprobs": None,
                }
                for i, (toks, reason) in enumerate(results)
            ],
            "usage": {
                "prompt_tokens": n_prompt,
                "completion_tokens": n_out,
                "total_tokens": n_prompt + n_out,
            },
        }
        if body.get("stream"):
            return _sse_transcript(payload, "text_completion")
        return payload

    async def chat_completions(self, body: dict,
                               headers: Optional[dict] = None) -> Any:
        chat_body = dict(body)
        chat_body["prompt"] = default_chat_template(
            body.get("messages", [])
        )
        out = await self.completions(chat_body, headers=headers)
        if isinstance(out, str) or "error" in out:
            return out
        choice = out["choices"][0]
        payload = dict(out)
        payload["id"] = f"chatcmpl-{uuid.uuid4().hex[:24]}"
        payload["object"] = "chat.completion"
        payload["choices"] = [{
            "index": 0,
            "message": {"role": "assistant",
                        "content": choice["text"]},
            "finish_reason": choice["finish_reason"],
        }]
        if body.get("stream"):
            return _sse_transcript(payload, "chat.completion.chunk")
        return payload

    # -- operator surface -----------------------------------------------------

    def models(self) -> dict:
        data = []
        for m in self.spec.models:
            data.append({"id": m.model_id, "object": "model",
                         "owned_by": "ray_tpu"})
            for a in m.adapters:
                data.append({
                    "id": f"{m.model_id}:{a.adapter_id}", "object": "model",
                    "owned_by": "ray_tpu", "parent": m.model_id,
                })
        return {"object": "list", "data": data}

    def stats(self) -> dict:
        return self.manager.stats()

    def drain(self, timeout_s: float = 30.0) -> dict:
        self.manager.drain()
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            busy = any(
                r.runner.busy()
                for m in self.spec.models
                for r in self.manager.replicas(m.model_id)
            )
            if not busy:
                break
            time.sleep(0.05)
        inflight = sum(
            r.load()
            for m in self.spec.models
            for r in self.manager.replicas(m.model_id)
        )
        return {"drained": inflight == 0, "inflight": inflight}

    async def __call__(self, request) -> Any:
        path, method = request.path, request.method
        headers = dict(getattr(request, "headers", {}) or {})
        if path.rstrip("/") == "/v1/models" and method == "GET":
            return self.models()
        if path.rstrip("/") == "/v1/stats" and method == "GET":
            return self.stats()
        if path.rstrip("/") == "/v1/completions" and method == "POST":
            return await self.completions(request.json(), headers=headers)
        if path.rstrip("/") == "/v1/chat/completions" and method == "POST":
            return await self.chat_completions(request.json(),
                                               headers=headers)
        if path.rstrip("/") == "/v1/drain" and method == "POST":
            body = request.json() or {}
            timeout_s = float(body.get("timeout_s", 30.0))
            return await asyncio.get_running_loop().run_in_executor(
                None, lambda: self.drain(timeout_s=timeout_s)
            )
        return _error(f"no route {method} {path}", 404,
                      type_="not_found_error")

    def shutdown(self) -> None:
        self.manager.close()

    def __del__(self):
        try:
            self.manager.close()
        except Exception:  # noqa: BLE001
            pass
