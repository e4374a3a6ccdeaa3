"""Multi-provider / multi-endpoint routing (§12.3-§12.5).
A copy of ``repro.core.providers``.

* Endpoint topology with weighted selection, sticky sessions, failover.
* Provider-specific protocol translation (OpenAI/Anthropic/Bedrock/Gemini/
  Vertex/vLLM) over the internal Request/Response types.
* Pluggable outbound authorization factory (API key, OAuth2, cloud IAM,
  passthrough, custom) — invoked after selection, keeping routing
  auth-agnostic.
"""

from __future__ import annotations

import hashlib
import itertools
import time
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.observability import METRICS
from repro_torch.core.types import Endpoint, Request, Response


# ---------------------------------------------------------------------------
# auth factory (Definition 8)
# ---------------------------------------------------------------------------

class AuthProvider:
    name = "passthrough"

    def headers(self, req: Request, ep: Endpoint) -> Dict[str, str]:
        return {}


class ApiKeyAuth(AuthProvider):
    name = "api_key"

    def headers(self, req, ep):
        hdr = ep.auth_config.get("header", "Authorization")
        key = ep.auth_config.get("key", "")
        val = f"Bearer {key}" if hdr.lower() == "authorization" else key
        return {hdr: val}


class OAuth2Auth(AuthProvider):
    """Client-credentials token acquisition with expiry-based refresh."""
    name = "oauth2"

    def __init__(self):
        self._tok: Dict[str, Tuple[str, float]] = {}

    def _fetch(self, ep: Endpoint) -> Tuple[str, float]:
        basis = f"{ep.name}:{ep.auth_config.get('client_id', '')}:{time.time()//300}"
        tok = hashlib.sha256(basis.encode()).hexdigest()[:32]
        return tok, time.time() + 300
    def headers(self, req, ep):
        tok, exp = self._tok.get(ep.name, ("", 0.0))
        if time.time() >= exp:
            tok, exp = self._fetch(ep)
            self._tok[ep.name] = (tok, exp)
        return {"Authorization": f"Bearer {tok}"}


class CloudIAMAuth(AuthProvider):
    """SigV4 (bedrock) / service-account token (vertex) / AAD (azure)."""
    name = "cloud_iam"

    def headers(self, req, ep):
        scheme = {"bedrock": "AWS4-HMAC-SHA256",
                  "vertex": "Bearer", "azure": "Bearer"}.get(ep.provider,
                                                             "Bearer")
        sig = hashlib.sha256(f"{ep.provider}:{ep.name}".encode()) \
            .hexdigest()[:24]
        if scheme == "AWS4-HMAC-SHA256":
            return {"Authorization":
                    f"AWS4-HMAC-SHA256 Credential=..., Signature={sig}"}
        return {"Authorization": f"Bearer {sig}"}


class PassthroughAuth(AuthProvider):
    name = "passthrough"

    def headers(self, req, ep):
        if "authorization" in req.headers:
            return {"Authorization": req.headers["authorization"]}
        return {}


class AuthFactory:
    def __init__(self):
        self._providers: Dict[str, AuthProvider] = {
            "api_key": ApiKeyAuth(), "oauth2": OAuth2Auth(),
            "cloud_iam": CloudIAMAuth(), "passthrough": PassthroughAuth(),
        }

    def register(self, name: str, provider: AuthProvider):
        self._providers[name] = provider

    def outbound_headers(self, req: Request, ep: Endpoint) -> Dict[str, str]:
        return self._providers[ep.auth].headers(req, ep)


# ---------------------------------------------------------------------------
# protocol translation (§12.3)
# ---------------------------------------------------------------------------

def to_provider_payload(req: Request, ep: Endpoint, model: str) -> dict:
    payload = _provider_payload(req, ep, model)
    # QoS sidecar fields: the local fleet transport reads these to order
    # scheduler admission / arm preemption; remote providers ignore them
    if req.metadata.get("slo_priority") is not None:
        payload["vsr_priority"] = int(req.metadata["slo_priority"])
        payload["vsr_slo"] = str(req.metadata.get("slo_class", ""))
    return payload


def _provider_payload(req: Request, ep: Endpoint, model: str) -> dict:
    msgs = [{"role": m.role, "content": m.content} for m in req.messages]
    if ep.provider in ("openai", "azure", "vllm", "ollama"):
        return {"model": model, "messages": msgs, "stream": req.stream}
    if ep.provider == "anthropic":
        system = "\n".join(m["content"] for m in msgs
                           if m["role"] == "system")
        rest = [m for m in msgs if m["role"] != "system"]
        return {"model": model, "system": system, "messages": rest,
                "max_tokens": 1024}
    if ep.provider == "bedrock":
        return {"modelId": model, "body": {"messages": msgs}}
    if ep.provider in ("gemini", "vertex"):
        return {"contents": [{"role": "model" if m["role"] == "assistant"
                              else "user", "parts": [{"text": m["content"]}]}
                             for m in msgs if m["role"] != "system"],
                "systemInstruction": {"parts": [
                    {"text": "\n".join(m["content"] for m in msgs
                                       if m["role"] == "system")}]}}
    raise ValueError(f"unknown provider {ep.provider!r}")


def from_provider_payload(payload: dict, ep: Endpoint) -> Response:
    if ep.provider in ("openai", "azure", "vllm", "ollama"):
        ch = payload["choices"][0]
        return Response(ch["message"]["content"], payload.get("model", ""),
                        ch.get("finish_reason", "stop"),
                        payload.get("usage", {}))
    if ep.provider == "anthropic":
        return Response(payload["content"][0]["text"],
                        payload.get("model", ""),
                        payload.get("stop_reason", "end_turn"),
                        payload.get("usage", {}))
    if ep.provider == "bedrock":
        body = payload["body"]
        return Response(body["messages"][-1]["content"],
                        payload.get("modelId", ""))
    if ep.provider in ("gemini", "vertex"):
        cand = payload["candidates"][0]
        return Response(cand["content"]["parts"][0]["text"],
                        payload.get("model", ""))
    raise ValueError(ep.provider)


# ---------------------------------------------------------------------------
# endpoint router: weighted selection + sticky sessions + failover
# ---------------------------------------------------------------------------

class EndpointRouter:
    def __init__(self, endpoints: List[Endpoint],
                 auth: Optional[AuthFactory] = None,
                 cooldown_s: float = 30.0):
        self.endpoints = endpoints
        self.auth = auth or AuthFactory()
        self.health: Dict[str, bool] = {e.name: True for e in endpoints}
        self.failures: Dict[str, int] = {}
        self.cooldown_s = cooldown_s
        self.blacklisted_at: Dict[str, float] = {}
        self._draws = itertools.count()

    def serving(self, model: str, modality: Optional[str] = None, *,
                healthy_only: bool = True) -> List[Endpoint]:
        """Endpoints able to serve ``model`` (and, when given, the request's
        backend lane ``modality`` — endpoints with an empty modality serve
        any lane).  A circuit-broken endpoint is excluded only while its
        cooldown runs; afterwards it is re-admitted half-open for a probe
        (``mark_success`` fully restores it, another failure re-arms the
        cooldown) — without this, blacklisting was permanent: ``serving``
        filtered the endpoint out, so ``mark_success`` could never fire.
        ``healthy_only=False`` is the pure topology view (lane-validation
        checks use it: a transient circuit-break is dispatch's problem,
        not a reason to unpin a conversation)."""
        now = time.monotonic()
        eps = []
        for e in self.endpoints:
            if e.models and model not in e.models:
                continue
            if modality and e.modality and e.modality != modality:
                continue
            if healthy_only and not self.health.get(e.name, True):
                since = now - self.blacklisted_at.get(e.name, 0.0)
                if since < self.cooldown_s:
                    continue
            eps.append(e)
        return eps

    def resolve(self, model: str, session: Optional[str] = None,
                modality: Optional[str] = None,
                prefer: Optional[str] = None) -> Optional[Endpoint]:
        """``prefer`` names the endpoint holding the longest cached prefix
        of this request (prefix affinity).  A healthy, serving preferred
        endpoint wins even over the sticky-session mapping — re-prefilling
        a cached conversation elsewhere costs more than breaking
        stickiness — but a conflict between the two affinities is
        recorded (``affinity_conflict_total``) so operators can see when
        sessions migrate for cache locality."""
        eps = self.serving(model, modality)
        if not eps:
            return None
        if prefer:
            pref = next((e for e in eps if e.name == prefer), None)
            if pref is not None:
                if session:
                    sticky = self._weighted_pick(eps, session)
                    if sticky is not None and sticky.name != prefer:
                        METRICS.inc("affinity_conflict_total", model=model,
                                    endpoint=prefer)
                return pref
        return self._weighted_pick(eps, session)

    def _weighted_pick(self, eps: List[Endpoint],
                       session: Optional[str]) -> Optional[Endpoint]:
        weights = [max(1e-6, e.weight) for e in eps]
        total = sum(weights)
        if session:  # sticky affinity
            h = int(hashlib.sha256(session.encode()).hexdigest(), 16)
            x = (h % 10_000) / 10_000 * total
        else:
            # golden-ratio low-discrepancy sequence: equidistributed, so
            # endpoint weights are actually respected (a time_ns modulo
            # draw aliases with caller timing and skews the distribution)
            x = (next(self._draws) * 0.6180339887498949) % 1.0 * total
        acc = 0.0
        for e, w in zip(eps, weights):
            acc += w
            if x <= acc:
                return e
        return eps[-1]

    def mark_failure(self, ep: Endpoint, threshold: int = 3):
        n = self.failures.get(ep.name, 0) + 1
        self.failures[ep.name] = n
        if n >= threshold:
            # circuit opens with a timestamp: ``serving`` re-admits the
            # endpoint half-open once ``cooldown_s`` elapses; a failed
            # probe lands back here and re-arms the cooldown from now
            self.health[ep.name] = False
            self.blacklisted_at[ep.name] = time.monotonic()

    def mark_success(self, ep: Endpoint):
        self.failures[ep.name] = 0
        self.health[ep.name] = True
        self.blacklisted_at.pop(ep.name, None)

    def _with_failover(self, model: str, session: Optional[str], attempt,
                       mark_failures: bool = True,
                       modality: Optional[str] = None,
                       prefer: Optional[str] = None):
        """Weighted selection + failover cascade shared by single and
        batched dispatch.  ``attempt(ep)`` performs the upstream call;
        any exception cascades to the next endpoint.  ``mark_failures``
        is disabled for the batched group attempt, where one poisoned
        request fails the whole group: blame is attributed by the
        per-request retry instead, so request-level errors cannot charge
        endpoint health once per batch on top of once per request."""
        tried = set()
        last_err = None
        for _ in range(len(self.endpoints)):
            ep = self.resolve(model, session, modality,
                              prefer=prefer if not tried else None)
            if ep is None or ep.name in tried:
                remaining = [e for e in self.serving(model, modality)
                             if e.name not in tried]
                if not remaining:
                    break
                ep = max(remaining, key=lambda e: e.weight)
            tried.add(ep.name)
            try:
                out = attempt(ep)
                self.mark_success(ep)
                return out
            except Exception as e:  # failover
                last_err = e
                if mark_failures:
                    self.mark_failure(ep)
        raise RuntimeError(f"no healthy endpoint for {model}: {last_err}")

    def dispatch(self, req: Request, model: str, call_fn,
                 session: Optional[str] = None,
                 modality: Optional[str] = None,
                 prefer: Optional[str] = None
                 ) -> Tuple[Response, Endpoint]:
        """call_fn(endpoint, payload, headers) -> provider payload.
        Weighted selection with failover cascade to next endpoints.
        ``modality`` restricts selection to lane-compatible endpoints;
        ``prefer`` biases the first attempt to a prefix-holding endpoint."""
        def attempt(ep):
            payload = to_provider_payload(req, ep, model)
            headers = self.auth.outbound_headers(req, ep)
            return from_provider_payload(call_fn(ep, payload, headers), ep), \
                ep
        return self._with_failover(model, session, attempt,
                                   modality=modality, prefer=prefer)

    def dispatch_many(self, reqs: List[Request], model: str, call_fn,
                      sessions: Optional[List[Optional[str]]] = None,
                      return_errors: bool = False,
                      modality: Optional[str] = None,
                      prefer: Optional[List[Optional[str]]] = None):
        """Micro-batched dispatch: when the transport exposes a
        ``batch_call(ep, payloads, headers_list) -> payloads`` attribute,
        same-model requests sharing a sticky endpoint become ONE batched
        upstream call of ANY size — the transport owns its own admission
        (the local fleet queues payloads into its continuous-batching
        scheduler and its slot pool is the batching boundary; nothing is
        chunked or dropped here).  Requests whose sessions resolve to
        different endpoints keep their affinity — they form separate
        sub-batches.  Transports without batch support fall back to
        per-request ``dispatch`` with identical semantics.  Transports
        may report per-request service time in
        ``usage["vsr_service_ms"]``; the pipeline prefers it over batch
        wall clock for latency-aware selection.

        With ``return_errors`` a failure is isolated to the requests it
        belongs to: the failing sub-batch is retried one-by-one and the
        still-failing entries come back as Exception objects, so results
        from sub-batches that already succeeded upstream are never
        discarded or re-dispatched.  Without it, failures raise.

        Failover retries a whole sub-batch on the next endpoint: a
        transport whose ``batch_call`` is not atomic (partial chunks may
        have executed before raising) can see those requests re-sent —
        same caveat as any at-least-once retry."""
        sessions = sessions or [None] * len(reqs)
        prefer = prefer or [None] * len(reqs)
        batch_call = getattr(call_fn, "batch_call", None)

        def one(r, s, p=None):
            try:
                return self.dispatch(r, model, call_fn, session=s,
                                     modality=modality, prefer=p)
            except Exception as e:
                if not return_errors:
                    raise
                return e

        if batch_call is None or len(reqs) <= 1:
            return [one(r, s, p) for r, s, p in zip(reqs, sessions, prefer)]
        # sticky sessions and prefix-preferred endpoints pin their
        # endpoint; the remaining (sessionless, preference-free) requests
        # share ONE group (a per-request resolve() draw would scatter
        # them into tiny sub-batches and defeat micro-batching)
        groups: Dict[Optional[str], List[int]] = {}
        for i, (s, p) in enumerate(zip(sessions, prefer)):
            ep = (self.resolve(model, s, modality, prefer=p)
                  if (s is not None or p is not None) else None)
            groups.setdefault(ep.name if ep else None, []).append(i)
        results: List[Any] = [None] * len(reqs)
        for idxs in groups.values():
            sub = [reqs[i] for i in idxs]

            def attempt(ep, sub=sub):
                payloads = [to_provider_payload(r, ep, model) for r in sub]
                headers = [self.auth.outbound_headers(r, ep) for r in sub]
                outs = batch_call(ep, payloads, headers)
                if len(outs) != len(sub):   # broken transport => failover
                    raise RuntimeError(
                        f"batch_call returned {len(outs)} results for "
                        f"{len(sub)} payloads on {ep.name}")
                return [(from_provider_payload(o, ep), ep) for o in outs]

            try:
                pairs = self._with_failover(model, sessions[idxs[0]],
                                            attempt,
                                            mark_failures=not return_errors,
                                            modality=modality,
                                            prefer=prefer[idxs[0]])
            except Exception:
                if not return_errors:
                    raise
                pairs = [one(reqs[i], sessions[i], prefer[i]) for i in idxs]
            for i, p in zip(idxs, pairs):
                results[i] = p
        return results
