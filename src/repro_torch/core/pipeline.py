"""Batch-first staged routing pipeline (§12.2, batched execution).
A copy of ``repro.core.pipeline``.

The request path is an explicit sequence of named stages:

    translate -> signals -> decide -> request-plugins -> select ->
    dispatch -> response-plugins -> wrap

Each stage operates on a *batch* of ``RequestContext`` objects, so N
requests move through the pipeline stage-by-stage instead of one request
running the whole monolith at a time.  Two batch-level optimisations fall
out of this shape:

* **Shared embedding plan** — at most one ``backend.embed()`` call
  covers every query text in the batch, issued lazily by the first
  consumer; the vectors are memoized on the contexts' shared
  :class:`EmbeddingPlan` and reused by signal extraction, the semantic
  cache, selection algorithms, and the memory store instead of each
  issuing its own embed call (the monolith re-embedded the same text up
  to four times per request; batches with no embedding consumers stay
  embed-free).
* **Micro-batched dispatch** — the dispatch stage groups same-model
  requests and hands them to the endpoint router as one batched upstream
  call, filling the fleet's fixed batch slots instead of padding them.

``SemanticRouter.route()`` is a batch of one; ``route_batch()`` is the
same code path with N contexts.  Per-stage spans and
``stage_latency_ms`` metrics make the batched path traceable.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.observability import METRICS, Span, stage_scope
from repro_torch.core.plugins.base import PluginChain
from repro_torch.core.program import DecisionPlan, RouterProgram
from repro_torch.core.selection import select_many
from repro_torch.core.signals.plan import SignalPlan
from repro_torch.core.types import (Request, Response, RouterOverloadError,
                                    RoutingOutcome, SignalResult, SLOSpec)
from repro_torch.classifiers.backend import DOMAIN_LABELS


# ---------------------------------------------------------------------------
# shared embedding plan
# ---------------------------------------------------------------------------

class EmbeddingPlan:
    """Per-batch memo of text embeddings over a base ``embed`` callable.

    Demand-driven: ``register(texts)`` only records the batch's query
    texts; no base call happens until some consumer actually embeds.
    The first ``embed()`` miss then issues ONE base call covering the
    registered texts plus the request — so a batch with no embedding
    consumers costs zero embed calls, and a batch with k consumers
    costs one.  ``prime(texts)`` is the eager variant.  Thread-safe:
    learned-signal evaluators call ``embed`` from the signal thread pool.
    """

    def __init__(self, base_embed: Callable[[Sequence[str]], np.ndarray]):
        self.base = base_embed
        self.memo: Dict[str, np.ndarray] = {}
        self.base_calls = 0
        self._pending: List[str] = []
        self._lock = threading.Lock()

    def _fill(self, texts: Sequence[str]):
        """One base call covering ``texts`` plus anything pending.  Any
        fill clears ``_pending``: once a text has been embedded (by this
        call or an earlier ``prime``) it must never ride along in a later
        base call again."""
        missing = [t for t in dict.fromkeys([*self._pending, *texts])
                   if t not in self.memo]
        self._pending = []
        if not missing:
            return
        embs = self.base(missing)
        self.base_calls += 1
        for t, e in zip(missing, embs):
            self.memo[t] = e

    def register(self, texts: Sequence[str]):
        """Record texts to piggyback on the first miss-triggered call.
        Deduplicated against both the memo and already-pending texts, so
        repeated registration cannot grow the base call."""
        with self._lock:
            pending = set(self._pending)
            self._pending.extend(
                t for t in dict.fromkeys(texts)
                if t not in self.memo and t not in pending)

    def prime(self, texts: Sequence[str]):
        """One batched base call for every not-yet-seen text."""
        with self._lock:
            self._fill(texts)

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        """Drop-in replacement for ``backend.embed`` backed by the memo."""
        with self._lock:
            if any(t not in self.memo for t in texts):
                self._fill(texts)
            return np.stack([self.memo[t] for t in texts])


# ---------------------------------------------------------------------------
# per-request state
# ---------------------------------------------------------------------------

@dataclass
class RequestContext:
    """Everything one request carries through the staged pipeline."""
    req: Request
    plan: EmbeddingPlan
    root: Span
    t0: float
    program: Optional[RouterProgram] = None  # compiled policy for this batch
    sig_plan: Optional[SignalPlan] = None   # shared fused-classifier plan
    dec_plan: Optional[DecisionPlan] = None  # shared batch decision plan
    sig: Optional[SignalResult] = None
    decision: Any = None                    # DecisionEngine EvalResult
    outcome: Optional[RoutingOutcome] = None
    chain: Optional[PluginChain] = None
    plugin_ctx: Dict[str, Any] = field(default_factory=dict)
    model: Optional[str] = None
    response: Optional[Response] = None
    upstream_ms: float = 0.0                # this request's dispatch time
    short: bool = False                     # request plugin short-circuited
    joined: bool = False                    # rides an in-flight duplicate
    error: Optional[Exception] = None       # dispatch failed for THIS request
    wrapped: Optional[Tuple[Response, RoutingOutcome]] = None
    slo: Optional[SLOSpec] = None           # resolved QoS class (admission)
    skip_signals: bool = False              # degraded: skip encoder FLOPs
    degraded: str = ""                      # model this request degraded to


# ---------------------------------------------------------------------------
# stages — each takes (router, active_contexts) and mutates the contexts
# ---------------------------------------------------------------------------

def stage_translate(router, ctxs: List[RequestContext]):
    for c in ctxs:
        c.req = router._inbound_translate(c.req)


def stage_admission(router, ctxs: List[RequestContext]):
    """SLO-aware admission control, BEFORE signal extraction spends any
    encoder FLOPs.  A no-op unless the program declares a GLOBAL overload
    policy AND the router has an overload detector attached — legacy
    policies keep today's FIFO path byte-identically.

    Under load, best-effort requests (SLO priority below ``shed_below``)
    are degraded to their class's cheaper ``degrade_to`` model (at
    ``busy`` and above) or shed with a typed ``RouterOverloadError``
    carrying a retry-after hint (at ``overload``); premium passes."""
    program = ctxs[0].program
    detector = getattr(router, "overload", None)
    policy = program.overload
    if detector is None or policy is None:
        return
    state = detector.sample(policy)
    for c in ctxs:
        c.slo = program.request_slo(c.req)
    if state == "ok":
        return
    for c in ctxs:
        spec = c.slo
        if spec.priority >= policy.shed_below:
            METRICS.inc("admission_passed_total", slo=spec.cls)
            continue
        if spec.degrade_to:
            # cascade to the cheaper model instead of queueing: the
            # pinned model wins selection, and skip_signals spares the
            # fused encoder pass for this row
            c.skip_signals = True
            c.degraded = spec.degrade_to
            c.req.metadata["pinned_model"] = spec.degrade_to
            c.root.child("admission:degrade").finish(
                slo=spec.cls, to=spec.degrade_to, state=state)
            METRICS.inc("admission_degraded_total", slo=spec.cls)
        elif state == "overload":
            err = RouterOverloadError(
                f"router overloaded: {spec.cls} request shed",
                retry_after_s=policy.retry_after_s, slo_class=spec.cls)
            c.error = err
            c.short = True
            c.sig = SignalResult()
            c.outcome = RoutingOutcome(
                decision=None, model="", endpoint=None,
                confidence=0.0, signals=c.sig)
            c.response = Response(
                str(err), model="", finish_reason="error",
                headers={"x-vsr-error": "overload",
                         "x-vsr-slo": spec.cls,
                         "retry-after": f"{policy.retry_after_s:g}"})
            c.root.child("admission:shed").finish(slo=spec.cls, state=state)
            METRICS.inc("admission_rejected_total", slo=spec.cls,
                        reason="overload")
        else:
            METRICS.inc("admission_passed_total", slo=spec.cls)


def stage_signals(router, ctxs: List[RequestContext]):
    # the embedding plan: at most ONE backend.embed() call for the whole
    # batch's query texts, issued lazily when the first consumer (signals
    # / cache / selection / memory) embeds — zero calls if none do.  The
    # signal plan is its classifier twin: every learned (task, text) job
    # in the batch is served by ONE fused classify_all on the classifier
    # backend (plus one batched token_classify for PII).
    program = ctxs[0].program
    plan = ctxs[0].plan
    # shed and degraded requests are exempt from the encoder wave: the
    # whole point of admission running first is that overload shedding
    # costs zero signal FLOPs.  They still carry an (empty) SignalResult
    # so downstream stages and headers stay total.
    live = [c for c in ctxs if not (c.short or c.skip_signals)]
    for c in ctxs:
        if (c.short or c.skip_signals) and c.sig is None:
            c.sig = SignalResult()
    if live:
        plan.register([c.req.latest_user_text for c in live])
        # open the per-request spans BEFORE extraction so their duration
        # covers the batched signal wave (child spans carry each
        # evaluator's own measured latency)
        spans = [c.root.child("signals") for c in live]
        sigs = router.signals.extract_many(
            [c.req for c in live],
            program.used_types or None,
            embed_fn=plan.embed,
            plan=ctxs[0].sig_plan,
            signals_cfg=program.config.signals)
        for c, sig_span, sig in zip(live, spans, sigs):
            c.sig = sig
            for k, m in sig.matches.items():
                sig_span.child(f"signal:{k}").finish(
                    matched=m.matched, conf=round(m.confidence, 3),
                    eval_ms=round(m.latency_ms, 3))
                METRICS.inc("signal_evaluations_total", type=m.key.type)
                if m.matched:
                    METRICS.inc("signal_matches_total", type=m.key.type)
            sig_span.finish()
    # the DecisionPlan: project the batch's signal results onto the
    # program's frozen vocabulary as (B, N) match/conf tensors, ready for
    # stage_decide's single jitted gate call.  The row list MUST match
    # stage_decide's deciding list (everything not shed) exactly —
    # degraded rows ride along as all-zero signal rows.
    if ctxs[0].dec_plan is not None:
        ctxs[0].dec_plan.set_signals([c.sig for c in ctxs if not c.short])


def stage_decide(router, ctxs: List[RequestContext]):
    # shared across the batch: cache entries begun within it, so the
    # cache plugin only joins in-flight duplicates it can trust to
    # complete (a stale pending entry from a dead request is replaced)
    program = ctxs[0].program
    pending_begun: set = set()
    dplan = ctxs[0].dec_plan
    # shed requests never decide; degraded ones do (their empty signal
    # rows resolve to the default decision, then admission's pinned
    # model wins selection)
    deciding = [c for c in ctxs if not c.short]
    if dplan is not None and dplan.ready:
        # the whole batch decides in ONE jitted gate call against the
        # compiled program (EmbeddingPlan -> SignalPlan -> DecisionPlan)
        results = dplan.evaluate()
    else:
        results = [program.engine.evaluate(c.sig) for c in deciding]
    for c, res in zip(deciding, results):
        dec_span = c.root.child("decision")
        dec_span.finish(
            decision=res.decision.name if res.decision else None,
            confidence=round(res.confidence, 3))
        c.decision = res
        c.outcome = RoutingOutcome(
            decision=res.decision.name if res.decision else None,
            model=program.config.default_model, endpoint=None,
            confidence=res.confidence, signals=c.sig)

        if res.decision:
            METRICS.inc("decision_matches_total", decision=res.decision.name)
        # compiled per-decision plugin template (implied response-side
        # halves already resolved at program compile time)
        plugins = program.plugins_for(res.decision)

        c.plugin_ctx = {"cache": router.cache, "memory": router.memory,
                        "rag": router.rag, "halugate": router.halugate,
                        "signals": c.sig, "embed": c.plan.embed,
                        "pending_begun": pending_begun, "outcome": {}}
        c.chain = PluginChain(plugins, c.plugin_ctx)


def stage_request_plugins(router, ctxs: List[RequestContext]):
    for c in ctxs:
        if c.short:          # shed by admission: no chain was built
            continue
        c.req, short, ptrace = c.chain.run_request(c.req)
        for t in ptrace:
            c.root.child(f"plugin:{t['plugin']}").finish(**t)
        if short is not None:
            c.short = True
            c.response = short
            c.outcome.fast_response = short
            c.outcome.cache_hit = c.plugin_ctx.get("outcome", {}).get(
                "cache_hit", False)
        elif c.plugin_ctx.get("cache_join_entry") is not None:
            # an identical query in this batch is already in flight:
            # defer — stage_wrap back-fills from its completed cache entry
            c.joined = True


# modality-signal label -> backend lane type (Endpoint.modality values)
LANE_OF_LABEL = {"diffusion": "image", "both": "image", "audio": "audio",
                 "autoregressive": "text"}


def request_lane(c: RequestContext) -> str:
    """Backend lane for one request: the modality plugin's annotation when
    a route ran it, else the matched modality signal's label — so the
    ``modality`` signal alone is enough to steer endpoint selection onto
    lane-typed endpoints.  Default: the text lane."""
    label = c.req.metadata.get("modality")
    if label is None and c.sig is not None:
        for k, m in c.sig.matches.items():
            if k.startswith("modality:") and m.matched:
                label = m.detail.get("label")
                break
    return LANE_OF_LABEL.get(label, "text")


def _domain_z(sig) -> int:
    for k, m in sig.matches.items():
        lab = m.detail.get("label") if m.detail else None
        if k.startswith("domain:") and lab in DOMAIN_LABELS:
            return DOMAIN_LABELS.index(lab)
    return 0


def _lane_serves(router, model: str, lane: str) -> bool:
    """Topology-only lane check: does ANY endpoint (healthy or not) of a
    compatible modality serve this model?  Health is deliberately ignored
    — a circuit-broken endpoint is a transient condition the dispatch
    failover owns, not a reason to unpin a conversation."""
    return bool(router.endpoint_router.serving(model, lane,
                                               healthy_only=False))


def _lane_fallback(router, program, lane: str,
                   exclude: str) -> Optional[str]:
    """Deterministic lane-compatible substitute: profile models by
    quality (best first), then endpoint model lists."""
    cands = [p.name for p in sorted(program.config.model_profiles.values(),
                                    key=lambda p: -p.quality)]
    for ep in router.endpoint_router.endpoints:
        cands.extend(ep.models)
    for m in cands:
        if m != exclude and _lane_serves(router, m, lane):
            return m
    return None


def _request_prefix_hashes(c: RequestContext):
    """Chained block hashes of the request's full message text, computed
    once per request and cached on the context (selection and dispatch
    both consult them)."""
    ph = c.plugin_ctx.get("prefix_hashes")
    if ph is None:
        from repro_torch.core.prefix import text_block_hashes
        text = "\n".join(m.content for m in c.req.messages)
        ph = c.plugin_ctx["prefix_hashes"] = text_block_hashes(text)
    return ph


def _apply_prefix_affinity(router, c: RequestContext, cands, w: float,
                           conf: float):
    """Blend the algorithm's pick with the prefix-cache affinity term:
    ``score(m) = (1-w)*(conf if m == pick else 0) + w*depth(m)/blocks``.
    A candidate holding enough of the conversation's cached prefix can
    override the pick — prefilling only the suffix is usually worth more
    than a marginal selection-score edge.  Composable with every
    selection algorithm because it rescores AFTER the pick."""
    hashes = _request_prefix_hashes(c)
    if not hashes:
        return
    depth = router.prefix_index.match(hashes, holders=cands)
    if not depth:
        return
    pick = c.model
    nb = len(hashes)
    best, best_s = pick, (1 - w) * conf + w * depth.get(pick, 0) / nb
    for m in cands:
        s = w * depth.get(m, 0) / nb + ((1 - w) * conf if m == pick else 0.0)
        if s > best_s:
            best, best_s = m, s
    if best != pick:
        METRICS.inc("prefix_affinity_overrides_total", model=best)
        c.root.child("select:prefix_affinity").finish(
            overridden=pick, selected=best,
            depth=depth.get(best, 0), blocks=nb)
        c.model = best


def stage_select(router, ctxs: List[RequestContext]):
    # selection runs per DECISION group, not per request: every request
    # sharing a decision shares the compiled SelectionBinding (candidate
    # pool + algorithm + config), so the trainable algorithms featurize
    # and score the whole group in one vectorized select_many call.
    program = ctxs[0].program
    default_model = program.config.default_model
    affinity = getattr(program.config, "prefix_affinity", 0.0)
    groups: Dict[int, List[RequestContext]] = {}
    used_default: set = set()
    for c in ctxs:
        res = c.decision
        if res.decision is None or not res.decision.model_refs:
            c.model = default_model
            used_default.add(id(c))
        else:
            groups.setdefault(program.index_of(res.decision), []).append(c)
    for di, group in groups.items():
        binding = program.selection[di]
        cands = list(binding.cands)
        if len(cands) == 1:
            for c in group:
                c.model = cands[0]
        elif binding.algorithm == "remom":
            # multi-round reasoning dispatches upstream per request
            for c in group:
                c.model, _ = router._select(c.req, c.decision, c.sig,
                                            plan=c.plan)
        else:
            plan = group[0].plan
            E = plan.embed([c.req.latest_user_text for c in group])
            zs = [_domain_z(c.sig) for c in group]
            picks = select_many(binding.algorithm, E, zs, cands,
                                router.selection_ctx, binding.config,
                                users=[c.req.user for c in group])
            for c, (m, cf) in zip(group, picks):
                c.model = m
                if affinity > 0:
                    _apply_prefix_affinity(router, c, cands, affinity, cf)
    # lane validation: a pinned (or default-fallback) text model must not
    # receive an image/audio request and die in stage_dispatch's
    # (model, lane) grouping — pin only when lane-compatible, and swap a
    # lane-incompatible default for a compatible model, each under a
    # warning span.
    for c in ctxs:
        lane = request_lane(c)
        pinned = c.req.metadata.get("pinned_model")
        if pinned:
            if _lane_serves(router, pinned, lane):
                c.model = pinned             # conversation pinning
            else:
                c.root.child("select:lane_pin_override").finish(
                    warning="pinned model lane-incompatible",
                    pinned=pinned, lane=lane, kept=c.model)
                METRICS.inc("lane_pin_overrides_total", lane=lane)
        if id(c) in used_default and not _lane_serves(router, c.model, lane):
            fb = _lane_fallback(router, program, lane, c.model)
            if fb is not None:
                c.root.child("select:lane_fallback").finish(
                    warning="default model lane-incompatible",
                    dropped=c.model, lane=lane, selected=fb)
                METRICS.inc("lane_default_fallbacks_total", lane=lane)
                c.model = fb
        c.outcome.model = c.model
    # QoS: thread the resolved SLO priority down to the serving engine as
    # payload metadata (a decision's own SLO block outranks the request's
    # class).  Gated on has_slo so legacy programs never touch metadata.
    if program.has_slo:
        for c in ctxs:
            spec = None
            if c.decision is not None and c.decision.decision is not None:
                spec = c.decision.decision.slo
            if spec is None:
                spec = c.slo or program.request_slo(c.req)
            c.slo = spec
            c.req.metadata["slo_priority"] = spec.priority
            c.req.metadata["slo_class"] = spec.cls


def stage_dispatch(router, ctxs: List[RequestContext]):
    # micro-batching: same-model same-lane requests become ONE upstream
    # call when the transport supports it (LocalFleet fills its batch
    # slots); the lane key restricts endpoint selection to lane-typed
    # endpoints (Endpoint.modality), so a mixed text/image/audio batch
    # forms one sub-batch per backend lane.
    groups: Dict[Tuple[str, str], List[RequestContext]] = {}
    affinity = getattr(ctxs[0].program.config, "prefix_affinity", 0.0)
    for c in ctxs:
        groups.setdefault((c.model, request_lane(c)), []).append(c)
    for (model, lane), group in groups.items():
        spans = [c.root.child("upstream", model=model, lane=lane,
                              batched=len(group) > 1) for c in group]
        # prefix affinity, endpoint level: prefer the endpoint whose KV
        # pool holds the longest cached prefix of each request (holders
        # tagged "ep:<name>" in the index); resolve() arbitrates against
        # sticky sessions and health.
        prefer = None
        if affinity > 0:
            ep_tags = {f"ep:{e.name}": e.name
                       for e in router.endpoint_router.serving(model, lane)}
            prefer = []
            for c in group:
                hashes = _request_prefix_hashes(c)
                depth = (router.prefix_index.match(hashes, holders=ep_tags)
                         if hashes and ep_tags else {})
                prefer.append(
                    ep_tags[max(depth, key=depth.get)] if depth else None)
        t0 = time.perf_counter()
        # return_errors isolates failures to the requests they belong to:
        # a poisoned request comes back as an Exception entry instead of
        # aborting the batch or re-dispatching already-answered requests.
        pairs = router.endpoint_router.dispatch_many(
            [c.req for c in group], model, router.call_fn,
            sessions=[c.req.user for c in group], return_errors=True,
            modality=lane, prefer=prefer)
        group_ms = (time.perf_counter() - t0) * 1e3
        for c, span, out in zip(group, spans, pairs):
            if isinstance(out, Exception):
                c.error = out
                c.response = Response(
                    f"upstream dispatch failed: {out}", model=model,
                    finish_reason="error",
                    headers={"x-vsr-error": "dispatch"})
                span.finish(error=str(out))
                METRICS.inc("dispatch_errors_total", model=model)
                continue
            resp, ep = out
            span.finish(endpoint=ep.name, provider=ep.provider)
            c.response = resp
            if affinity > 0:
                # the serving engine now caches this conversation's
                # prefix blocks: future turns score toward this model
                # and this endpoint
                hashes = _request_prefix_hashes(c)
                if hashes:
                    router.prefix_index.insert(model, hashes)
                    router.prefix_index.insert(f"ep:{ep.name}", hashes)
            # per-request service time straight from the transport when it
            # reports one (LocalFleet: scheduler submit->finish, compile
            # excluded); otherwise the group's dispatch wall clock — an
            # UPPER bound on this request's own service time when the
            # group spans several transport chunks
            c.upstream_ms = float(resp.usage.get("vsr_service_ms",
                                                 group_ms))
            c.outcome.endpoint = ep.name
            METRICS.inc("model_requests_total", model=model)
            METRICS.inc("tokens_total",
                        resp.usage.get("completion_tokens", 0), model=model)


def stage_response_plugins(router, ctxs: List[RequestContext]):
    for c in ctxs:
        if c.error is not None:      # never cache/memorize error responses
            entry = c.plugin_ctx.pop("cache_entry", None)
            if entry is not None:    # don't leave a forever-pending entry
                router.cache.abandon(entry)
            continue
        c.response, rtrace = c.chain.run_response(c.req, c.response)
        for t in rtrace:
            c.root.child(f"plugin:{t['plugin']}").finish(**t)


def _resolve_join(router, c: RequestContext):
    """Back-fill a deferred duplicate from its owner's completed cache
    entry — the batched equivalent of the sequential cache hit the
    second identical route() call would have gotten."""
    entry = c.plugin_ctx.get("cache_join_entry")
    if entry is not None and not entry.pending and entry.response is not None:
        r = entry.response
        c.response = Response(r.content, r.model, usage=dict(r.usage),
                              headers={"x-vsr-cache-hit": "true"})
        c.outcome.fast_response = c.response
        c.outcome.cache_hit = True
        entry.hits += 1                 # stat parity with a sequential hit
        router.cache.hits += 1
    else:
        # the owner's upstream call failed; an identical call would have
        # failed identically — surface the same error outcome
        c.error = RuntimeError("in-flight identical query failed upstream")
        c.response = Response(
            "upstream dispatch failed for joined duplicate query",
            model=c.outcome.model, finish_reason="error",
            headers={"x-vsr-error": "dispatch"})


def stage_wrap(router, ctxs: List[RequestContext]):
    for c in ctxs:
        if c.joined:
            _resolve_join(router, c)
        c.response.headers.update(router._signal_headers(c.sig, c.decision))
        if c.degraded:
            c.response.headers.setdefault("x-vsr-degraded", c.degraded)
        latency = (time.perf_counter() - c.t0) * 1e3
        METRICS.observe("routing_latency_ms", latency)
        if not c.short and not c.joined and c.error is None:
            # per-model latency is the request's model-group dispatch time
            # (not the whole batch's wall clock) — a slow model in the
            # batch must not poison latency-aware selection for fast ones.
            METRICS.observe("model_latency_ms", c.upstream_ms, model=c.model)
            router.selection_ctx.observe_latency(c.model, c.upstream_ms)
        c.root.finish()
        c.outcome.trace = [dict(span=s.name, ms=round(s.duration_ms, 3))
                           for _, s in c.root.flatten()]
        # error responses are never persisted as Responses-API history:
        # storing them would pin follow-ups to the model that just failed
        final = c.response if c.error is not None else \
            router._outbound_translate(c.req, c.response)
        c.wrapped = (final, c.outcome)


# (name, fn, runs_on_short): stages with runs_on_short=False skip contexts
# already answered by a request-plugin short-circuit (Equation 13's bottom)
# or deferred onto an in-flight duplicate's cache entry.
STAGES: List[Tuple[str, Callable, bool]] = [
    ("translate", stage_translate, True),
    ("admission", stage_admission, True),
    ("signals", stage_signals, True),
    ("decide", stage_decide, True),
    ("request_plugins", stage_request_plugins, True),
    ("select", stage_select, False),
    ("dispatch", stage_dispatch, False),
    ("response_plugins", stage_response_plugins, False),
    ("wrap", stage_wrap, True),
]


def run_pipeline(router, reqs: Sequence[Request], *,
                 program: Optional[RouterProgram] = None,
                 raise_dispatch_errors: bool = False
                 ) -> List[Tuple[Response, RoutingOutcome]]:
    """Run N requests through the staged pipeline as one batch under ONE
    compiled RouterProgram (callers group per-policy batches; a batch
    never mixes policies, so a hot-reload mid-flight cannot change the
    rules under a running batch).

    ``raise_dispatch_errors`` is set by ``route()`` to keep its raising
    contract; ``route_batch()`` instead returns a per-request error
    Response for failed dispatches, regardless of batch size."""
    if not reqs:
        return []
    if program is None:
        program = router.policies.get()
    plan = EmbeddingPlan(router.backend.embed)
    sig_plan = SignalPlan(router.classifier)
    # a batch of one decides faster on the sequential Python engine than
    # on a jitted gate dispatch + host transfer; the plan pays off from
    # the first real batch
    dec_plan = (DecisionPlan(program)
                if len(reqs) > 1 and program._gate is not None and
                getattr(router, "use_decision_plan", True) else None)
    ctxs = [RequestContext(req=r, plan=plan, sig_plan=sig_plan,
                           dec_plan=dec_plan, program=program,
                           root=Span("request"),
                           t0=time.perf_counter()) for r in reqs]
    METRICS.inc("pipeline_batches_total")
    METRICS.observe("pipeline_batch_size", len(ctxs))
    batch_root = Span("pipeline", attributes={"batch": len(ctxs),
                                              "policy": program.name})
    for name, fn, on_short in STAGES:
        active = ctxs if on_short else \
            [c for c in ctxs if not (c.short or c.joined)]
        if not active:
            continue
        with stage_scope(batch_root, f"stage:{name}", batch=len(active)):
            fn(router, active)
    batch_root.finish()
    if raise_dispatch_errors:
        for c in ctxs:
            if c.error is not None:
                raise c.error
    # batch-level stage timings appended to every request's trace so the
    # batched path stays observable per-request.
    stage_trace = [dict(span=s.name, ms=round(s.duration_ms, 3))
                   for _, s in batch_root.flatten() if s is not batch_root]
    for c in ctxs:
        c.outcome.trace.extend(stage_trace)
    return [c.wrapped for c in ctxs]
