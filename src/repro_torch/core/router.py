"""SemanticRouter: the end-to-end request pipeline (§12.2).
The port of ``repro.core.router``: a copy, except that a router owns a
``device`` ("cuda" by default) that holds its programs' decision gates,
trains the ``mlp`` selector and builds a default ``"encoder"``
classifier backend.

The request path is the staged batch-first pipeline in
``repro_torch.core.pipeline``: translate -> signals -> decide ->
request-plugins -> select -> dispatch -> response-plugins -> wrap.
``route()`` runs one request through the stages (a batch of one);
``route_batch()`` runs N requests stage-by-stage, sharing one embedding
plan per batch and micro-batching same-model upstream calls.

Response path: token accounting -> HaluGate -> cache/memory writes ->
Responses-API re-wrap.
"""

from __future__ import annotations

import uuid
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import repro_torch.core.plugins.builtin  # noqa: F401  (registers plugins)
import repro_torch.core.halugate        # noqa: F401
import repro_torch.core.memory          # noqa: F401
import repro_torch.core.rag             # noqa: F401
from repro_torch.classifiers.backend import get_backend
from repro_torch.core.halugate import HaluGate
from repro_torch.core.memory import MemoryStore
from repro_torch.core.pipeline import EmbeddingPlan, _domain_z, run_pipeline
from repro_torch.core.plugins.builtin import SemanticCache
from repro_torch.core.policy import PolicyRegistry
from repro_torch.core.program import RouterProgram
from repro_torch.core.providers import EndpointRouter
from repro_torch.core.rag import HybridRetriever, VectorStoreBackend
from repro_torch.core.selection import ReMoM, SelectionContext, get_algorithm
from repro_torch.core.selection.algorithms import RoutingRecord
from repro_torch.core.signals import SignalEngine
from repro_torch.core.types import (Message, Request, Response, RouterConfig,
                                    RoutingOutcome)
from repro_torch.device import DeviceLike, resolve_device


class SemanticRouter:
    # LRU bound on stored Responses-API conversations (plugs unbounded
    # per-call growth; oldest conversations are evicted first).
    MAX_RESPONSES_STATE = 512

    def __init__(self, config: RouterConfig,
                 call_fn: Optional[Callable] = None,
                 device: DeviceLike = "cuda"):
        """``call_fn(endpoint, payload, headers) -> provider payload`` is the
        transport; defaults to an echo stub (tests) — examples inject the
        fleet-serving transport.  A transport exposing a ``batch_call``
        attribute gets same-model requests micro-batched into one call.
        ``device`` ("cuda" by default; raises without a GPU unless
        ``device="cpu"``) holds the decision gates, trains the ``mlp``
        selector and builds the ``"encoder"`` backend if none is
        registered yet."""
        self.config = config
        self.device = resolve_device(device)
        self.backend = get_backend(config.embedding_backend,
                                   device=self.device)
        # classification may run on a different substrate than embeddings
        # (e.g. hash embeddings + fused MoM encoder classifier heads);
        # empty classifier_backend means one backend serves both.
        self.classifier = (get_backend(config.classifier_backend,
                                       device=self.device)
                           if config.classifier_backend else self.backend)
        self.signals = SignalEngine(config.signals, self.backend,
                                    classifier=self.classifier)
        from repro_torch.core.types import Endpoint
        endpoints = config.endpoints or [Endpoint("default", "vllm")]
        self.endpoint_router = EndpointRouter(endpoints)
        # copy: tenant registrations merge into the live profile table and
        # must not mutate the default program's (immutable) config through
        # dict aliasing
        self.selection_ctx = SelectionContext(
            profiles=dict(config.model_profiles), device=self.device)
        # router-side optimistic prefix index: which model / endpoint most
        # recently served each chained prompt-prefix (text-level hashes —
        # the engine-side BlockPool owns the exact token-level truth).
        # Consulted by stage_select/stage_dispatch when the program's
        # ``prefix_affinity`` knob is > 0.
        from repro_torch.core.prefix import PrefixIndex
        self.prefix_index = PrefixIndex()
        self.cache = SemanticCache(self.backend.embed)
        self.memory = MemoryStore(self.backend.embed)
        self.rag_store = VectorStoreBackend(self.backend.embed)
        self.rag = HybridRetriever(self.rag_store)
        self.halugate = HaluGate(self.classifier,
                                 embed_backend=self.backend)
        self.call_fn = call_fn or self._echo_call
        # compiled control plane: the construction config becomes the
        # default policy; further named policies share this substrate
        # (backends, fleet transport, caches, endpoint router).
        self.policies = PolicyRegistry(
            RouterProgram(config, name="default", device=self.device),
            on_register=self._bind_program)
        # escape hatch / benchmark baseline: False forces the sequential
        # per-request engine loop instead of the one-gate DecisionPlan
        self.use_decision_plan = True
        # QoS: the serving layer attaches an OverloadDetector here
        # (core never imports serving); None disables admission control
        self.overload = None
        self.responses_state: "OrderedDict[str, Dict[str, Any]]" = \
            OrderedDict()

    # live views of the default policy's compiled program — properties so
    # a hot-reload of "default" is reflected here, not a stale pointer
    @property
    def program(self) -> RouterProgram:
        return self.policies.get()

    @property
    def engine(self):
        """Sequential decision oracle of the current default program."""
        return self.policies.get().engine

    @property
    def used_types(self):
        return self.policies.get().used_types

    def _bind_program(self, program: RouterProgram):
        """Attach a (re)compiled policy to the shared substrate: exemplar
        reference texts embed once up front, and its model profiles merge
        into the shared selection context (last registration wins, so a
        hot-reload that retunes a model's quality/cost actually lands)."""
        self.signals.learned.preload(program.config.signals)
        self.selection_ctx.profiles.update(program.config.model_profiles)

    # -- policies ------------------------------------------------------------
    def add_policy(self, name: str, dsl_text: str) -> RouterProgram:
        """Compile + register (or hot-reload) a named policy.  Atomic:
        in-flight batches finish on the program they started with."""
        return self.policies.reload(name, dsl_text)

    # -- lifecycle -----------------------------------------------------------
    def close(self):
        """Release owned resources (the signal engine's thread pool)."""
        self.signals.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- default transport ---------------------------------------------------
    @staticmethod
    def _echo_call(ep, payload, headers):
        msgs = payload.get("messages") or payload.get("body", {}).get(
            "messages") or []
        last = msgs[-1]["content"] if msgs else ""
        return {"choices": [{"message": {
                    "content": f"[{payload.get('model', 'model')}] echo: "
                               f"{last[:200]}"},
                "finish_reason": "stop"}],
                "model": payload.get("model", ""),
                "usage": {"prompt_tokens": sum(len(m['content']) // 4
                                               for m in msgs),
                          "completion_tokens": 16}}

    # -- Responses API translation (§12.4) ------------------------------------
    def _inbound_translate(self, req: Request) -> Request:
        if req.api != "responses":
            return req
        if req.previous_response_id:
            state = self.responses_state.get(req.previous_response_id)
            if state:
                self.responses_state.move_to_end(req.previous_response_id)
                req.messages = [Message(**m) for m in state["messages"]] + \
                    req.messages
                req.metadata["pinned_model"] = state.get("model")
        return req

    def _outbound_translate(self, req: Request, resp: Response) -> Response:
        if req.api != "responses":
            return resp
        rid = "resp_" + uuid.uuid4().hex[:16]
        resp.response_id = rid
        history = [dict(role=m.role, content=m.content)
                   for m in req.messages] + \
            [dict(role="assistant", content=resp.content)]
        self.responses_state[rid] = {"messages": history,
                                     "model": resp.model}
        while len(self.responses_state) > self.MAX_RESPONSES_STATE:
            self.responses_state.popitem(last=False)
        resp.annotations["output"] = [{"type": "message",
                                       "content": resp.content}]
        return resp

    # -- main entries ----------------------------------------------------------
    def route(self, req: Request) -> Tuple[Response, RoutingOutcome]:
        """One request through the staged pipeline (a batch of one);
        dispatch failures raise, as the monolithic route() always did."""
        return run_pipeline(self, [req], program=self.policies.resolve(req),
                            raise_dispatch_errors=True)[0]

    def route_batch(self, reqs: Sequence[Request]
                    ) -> List[Tuple[Response, RoutingOutcome]]:
        """N requests stage-by-stage: one shared embedding plan (a single
        ``backend.embed()`` call covers all query texts), ONE jitted
        decision-gate call per batch (DecisionPlan), and same-model
        upstream calls micro-batched into the fleet's batch slots.
        Requests resolve their policy (``metadata['policy']`` /
        ``X-VSR-Policy``) and run as one sub-batch per compiled program;
        each sub-batch snapshots its program pointer, so concurrent
        hot-reloads never change rules mid-batch.  Dispatch failures are
        isolated per request (an error Response with
        ``finish_reason='error'``), never aborting the batch."""
        reqs = list(reqs)
        groups: "OrderedDict[int, Tuple[RouterProgram, List[int]]]" = \
            OrderedDict()
        for i, r in enumerate(reqs):
            prog = self.policies.resolve(r)
            groups.setdefault(id(prog), (prog, []))[1].append(i)
        out: List[Optional[Tuple[Response, RoutingOutcome]]] = \
            [None] * len(reqs)
        for prog, idxs in groups.values():
            pairs = run_pipeline(self, [reqs[i] for i in idxs],
                                 program=prog)
            for i, p in zip(idxs, pairs):
                out[i] = p
        return out

    # ------------------------------------------------------------------
    def _select(self, req: Request, res, sig,
                plan: Optional[EmbeddingPlan] = None) -> Tuple[str, float]:
        if res.decision is None or not res.decision.model_refs:
            return self.config.default_model, 0.0
        cands = [m.name for m in res.decision.model_refs]
        if len(cands) == 1:
            return cands[0], res.confidence
        algo_name = res.decision.algorithm or "static"
        embed = plan.embed if plan is not None else self.backend.embed
        e_q = embed([req.latest_user_text])[0]
        z = _domain_z(sig)
        cfg = dict(res.decision.algorithm_config)
        cfg.setdefault("user", req.user or "anon")
        if algo_name == "remom":
            weights = [m.weight for m in res.decision.model_refs]
            remom = ReMoM(
                call_fn=lambda m, p, s: self._remom_call(req, m, p),
                breadth=cfg.get("breadth", [2]),
                distribution=cfg.get("distribution", "equal"))
            content = remom.run(req.latest_user_text, cands, weights)
            req.metadata["remom_content"] = content
            return cands[0], 1.0
        algo = get_algorithm(algo_name)
        return algo(e_q, z, cands, self.selection_ctx, cfg)

    def _remom_call(self, req: Request, model: str, prompt: str) -> str:
        r2 = Request(messages=[Message("user", prompt)], user=req.user)
        resp, _ep = self.endpoint_router.dispatch(r2, model, self.call_fn)
        return resp.content

    @staticmethod
    def _signal_headers(sig, res) -> Dict[str, str]:
        out = {}
        for k, m in sig.matches.items():
            if m.matched and k.startswith(("jailbreak:", "pii:")):
                typ = k.split(":", 1)[0]
                out[f"x-vsr-matched-{typ}"] = k.split(":", 1)[1]
        if res is not None and res.decision:
            out["x-vsr-decision"] = res.decision.name
        return out

    # -- feedback ingestion: closes the loop (§2.4) -------------------------
    def record_feedback(self, req: Request, model: str, quality: float):
        e = self.backend.embed([req.latest_user_text])[0]
        self.selection_ctx.add_record(
            RoutingRecord(e, 0, model, quality, req.user or "anon"))
        self.selection_ctx.update_feedback(model, quality >= 0.5)
