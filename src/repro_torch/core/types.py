"""Core datatypes for the semantic router (paper §2-§4), a copy of
``repro.core.types``.

Everything is a plain dataclass; the RouterConfig is the compile target of
the DSL (§6) and the single source the engine executes from.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


@dataclass
class Message:
    role: str
    content: str


@dataclass
class Request:
    """An OpenAI-ish chat completion request + transport metadata."""
    messages: List[Message]
    model: Optional[str] = None
    user: Optional[str] = None
    headers: Dict[str, str] = field(default_factory=dict)
    stream: bool = False
    metadata: Dict[str, Any] = field(default_factory=dict)
    previous_response_id: Optional[str] = None
    api: str = "chat"            # "chat" | "responses"

    @property
    def latest_user_text(self) -> str:
        for m in reversed(self.messages):
            if m.role == "user":
                return m.content
        return ""

    @property
    def user_texts(self) -> List[str]:
        return [m.content for m in self.messages if m.role == "user"]

    @property
    def full_text(self) -> str:
        return "\n".join(m.content for m in self.messages)


@dataclass
class Response:
    content: str
    model: str
    finish_reason: str = "stop"
    usage: Dict[str, int] = field(default_factory=dict)
    headers: Dict[str, str] = field(default_factory=dict)
    response_id: Optional[str] = None
    annotations: Dict[str, Any] = field(default_factory=dict)


# ---------------------------------------------------------------------------
# signals (paper §3, Definitions 2-3)
# ---------------------------------------------------------------------------

SIGNAL_TYPES = (
    "keyword", "context", "language", "authz",                       # heuristic
    "embedding", "domain", "fact_check", "user_feedback", "modality",
    "complexity", "jailbreak", "pii", "preference",                  # learned
)

HEURISTIC_TYPES = ("keyword", "context", "language", "authz")


@dataclass(frozen=True)
class SignalKey:
    type: str
    name: str

    def __str__(self):
        return f"{self.type}:{self.name}"


@dataclass
class SignalMatch:
    key: SignalKey
    matched: bool
    confidence: float
    latency_ms: float = 0.0
    detail: Dict[str, Any] = field(default_factory=dict)


@dataclass
class SignalResult:
    """Structured signal vector s = S(r)."""
    matches: Dict[str, SignalMatch] = field(default_factory=dict)

    def add(self, m: SignalMatch):
        self.matches[str(m.key)] = m

    def matched(self, type_: str, name: str) -> bool:
        m = self.matches.get(f"{type_}:{name}")
        return bool(m and m.matched)

    def confidence(self, type_: str, name: str) -> float:
        m = self.matches.get(f"{type_}:{name}")
        return m.confidence if m else 0.0

    def as_vector(self, keys: List[SignalKey]):
        return [1.0 if self.matched(k.type, k.name) else 0.0 for k in keys], \
               [self.confidence(k.type, k.name) for k in keys]


# ---------------------------------------------------------------------------
# model fleet / endpoints (paper §2.1, §12.3)
# ---------------------------------------------------------------------------

@dataclass
class ModelRef:
    name: str
    reasoning: bool = False
    effort: str = "medium"
    lora_adapter: Optional[str] = None
    weight: float = 1.0


@dataclass
class Endpoint:
    name: str
    provider: str                 # vllm|openai|anthropic|azure|bedrock|gemini|vertex|ollama
    address: str = "127.0.0.1"
    port: int = 8000
    weight: float = 1.0
    models: List[str] = field(default_factory=list)
    auth: str = "passthrough"     # api_key|oauth2|cloud_iam|passthrough|custom
    auth_config: Dict[str, str] = field(default_factory=dict)
    # backend lane type served by this endpoint: "text" | "image" | "audio";
    # "" serves any modality (backwards-compatible default)
    modality: str = ""


@dataclass
class ModelProfile:
    """Capability/cost profile used by the selection algorithms (§10)."""
    name: str
    cost_per_mtok: float = 1.0
    quality: float = 0.5
    elo: float = 1200.0
    latency_ms: float = 200.0
    tags: Tuple[str, ...] = ()
    arch: Optional[str] = None    # fleet arch id when served locally


# ---------------------------------------------------------------------------
# decisions (paper §4, Definitions 4-5)
# ---------------------------------------------------------------------------

@dataclass
class SLOSpec:
    """Service tier declared by a decision's ``SLO { ... }`` block (§QoS).

    ``cls`` names the SLO class; requests select it via
    ``metadata["slo"]`` or the ``X-VSR-SLO`` header.  ``priority`` orders
    scheduler admission and arms preemption (higher evicts lower);
    ``ttft_ms`` is the class's TTFT target (0 = untracked) and
    ``degrade_to`` names the cheaper model this class falls back to under
    overload (empty = shed instead of degrading)."""
    cls: str = "standard"
    priority: int = 0
    ttft_ms: float = 0.0
    degrade_to: str = ""


@dataclass
class OverloadPolicy:
    """GLOBAL ``overload: { ... }``: detector thresholds + admission rules.

    The overload detector trips when the aggregate engine queue depth,
    paged-pool free-block fraction, or EWMA TTFT crosses these limits;
    ``slot_occupancy`` marks the busy band.  Requests whose SLO priority
    is below ``shed_below`` are best-effort: under overload they are shed
    (typed rejection carrying ``retry_after_s``) or degraded to their
    class's ``degrade_to`` model.  ``default_class`` resolves requests
    that declare no SLO class."""
    queue_depth: int = 64
    slot_occupancy: float = 0.95
    free_block_frac: float = 0.05
    ttft_ms: float = 0.0
    shed_below: int = 100
    retry_after_s: float = 1.0
    default_class: str = ""


@dataclass
class SpecPolicy:
    """GLOBAL ``speculative: { ... }``: draft-model speculative decoding
    on the serving text lanes.

    ``draft_model`` names the (small) fleet arch that proposes ``k``
    tokens per round; each lane's own member verifies all k+1 positions
    in one wide forward and greedy acceptance keeps output token-exact
    vs plain decode.  ``adaptive`` backs a lane off to plain decode when
    the acceptance EWMA collapses; ``probe_every`` is the full-k re-probe
    cadence for backed-off lanes."""
    draft_model: str = ""
    k: int = 4
    adaptive: bool = True
    probe_every: int = 16


class RouterOverloadError(RuntimeError):
    """Typed admission rejection: the router is overloaded and this
    request was shed (never dispatched).  ``retry_after_s`` is the
    client backoff hint surfaced as a ``retry-after`` header."""

    def __init__(self, message: str = "router overloaded", *,
                 retry_after_s: float = 1.0, slo_class: str = ""):
        super().__init__(message)
        self.retry_after_s = retry_after_s
        self.slo_class = slo_class


@dataclass
class Decision:
    name: str
    rule: "RuleNode"              # repro_torch.core.decision.RuleNode
    model_refs: List[ModelRef]
    priority: int = 0
    plugins: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    algorithm: str = "static"
    algorithm_config: Dict[str, Any] = field(default_factory=dict)
    description: str = ""
    slo: Optional[SLOSpec] = None


@dataclass
class RouterConfig:
    """Gamma = (S, D, Pi, E): the deployment configuration (Definition 1)."""
    signals: Dict[str, Dict[str, Dict[str, Any]]] = field(default_factory=dict)
    decisions: List[Decision] = field(default_factory=list)
    plugin_templates: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    endpoints: List[Endpoint] = field(default_factory=list)
    model_profiles: Dict[str, ModelProfile] = field(default_factory=dict)
    default_model: str = ""
    strategy: str = "priority"    # priority | confidence
    fuzzy: bool = False           # Definition-6 (min, max, 1-x) evaluation
    fuzzy_threshold: float = 0.5
    embedding_backend: str = "hash"
    classifier_backend: str = ""  # "" = same backend as embeddings
    # weight of the prefix-cache affinity term in selection/dispatch:
    # 0.0 disables it, 1.0 routes purely toward the member/endpoint
    # holding the longest cached prefix of the conversation
    prefix_affinity: float = 0.0
    # QoS: overload detection thresholds + admission rules; None keeps
    # the pre-SLO behaviour (FIFO, no shedding, no preemption)
    overload: Optional[OverloadPolicy] = None
    # speculative decoding: draft model + verify width for the serving
    # text lanes; None keeps plain per-token decode
    speculative: Optional[SpecPolicy] = None

    def used_signal_types(self) -> set:
        from repro_torch.core.decision import leaf_keys
        used = set()
        for d in self.decisions:
            for key in leaf_keys(d.rule):
                used.add(key.type)
        return used


@dataclass
class RoutingOutcome:
    decision: Optional[str]
    model: str
    endpoint: Optional[str]
    confidence: float
    signals: SignalResult
    fast_response: Optional[Response] = None
    cache_hit: bool = False
    headers: Dict[str, str] = field(default_factory=dict)
    trace: List[Dict[str, Any]] = field(default_factory=list)
    started: float = field(default_factory=time.time)
