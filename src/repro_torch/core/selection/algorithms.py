"""Semantic model selection (§10): thirteen algorithms behind one interface.
The port of ``repro.core.selection.algorithms``: a copy, except the
``mlp`` selector, whose training and forward run in torch on
``SelectionContext.device`` (the reference's are JAX).

    Select: (e_q, domain z, candidates M_d*, state) -> (model_name, conf)

Families: rating (static, elo), embedding (routerdc, hybrid), cascading
(automix), classical ML (knn, kmeans, svm, mlp), RL (thompson, gmt),
latency-aware, and multi-round reasoning (remom, in remom.py).
All learn/update from RoutingRecords so the closed loop (§2.4) is real.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.types import ModelProfile
from repro_torch.device import DeviceLike, resolve_device


@dataclass
class RoutingRecord:
    embedding: np.ndarray
    domain: int
    model: str
    quality: float
    user: str = "anon"
    latency_ms: float = 0.0


@dataclass
class SelectionContext:
    """Shared state across requests (the closed-loop memory).  ``device``
    is where the ``mlp`` selector trains (the router's device)."""
    profiles: Dict[str, ModelProfile]
    records: List[RoutingRecord] = field(default_factory=list)
    elo: Dict[str, float] = field(default_factory=dict)
    beta: Dict[str, List[float]] = field(default_factory=dict)  # [alpha, beta]
    latency: Dict[str, List[float]] = field(default_factory=dict)
    model_emb: Dict[str, np.ndarray] = field(default_factory=dict)
    rng: random.Random = field(default_factory=lambda: random.Random(0))
    device: DeviceLike = "cuda"

    # ---- closed-loop updates (Equation 1 / §10.2 / §10.6) -----------------
    def update_elo(self, winner: str, loser: str, k: float = 24.0):
        rw = self.elo.setdefault(winner, 1200.0)
        rl = self.elo.setdefault(loser, 1200.0)
        pw = 1.0 / (1.0 + 10 ** ((rl - rw) / 400.0))
        self.elo[winner] = rw + k * (1 - pw)
        self.elo[loser] = rl - k * (1 - pw)

    def update_feedback(self, model: str, positive: bool):
        ab = self.beta.setdefault(model, [1.0, 1.0])
        ab[0 if positive else 1] += 1.0

    def observe_latency(self, model: str, ms: float):
        self.latency.setdefault(model, []).append(ms)

    def add_record(self, rec: RoutingRecord):
        self.records.append(rec)
        # RouterDC-style model embedding: EMA toward good queries, away
        # from bad ones (dual-contrastive update, §10.3)
        e = self.model_emb.setdefault(
            rec.model, np.zeros_like(rec.embedding))
        sign = 1.0 if rec.quality >= 0.5 else -0.3
        e += 0.1 * sign * (rec.embedding - e)


Algorithm = Callable[[np.ndarray, int, Sequence[str], SelectionContext,
                      Dict[str, Any]], Tuple[str, float]]


# ---------------------------------------------------------------------------
# rating-based
# ---------------------------------------------------------------------------

def select_static(e_q, z, cands, ctx, cfg):
    best = max(cands, key=lambda m: ctx.profiles[m].quality
               if m in ctx.profiles else 0.0)
    conf = ctx.profiles[best].quality if best in ctx.profiles else 0.5
    return best, conf


def select_elo(e_q, z, cands, ctx, cfg):
    """Bradley-Terry sampling proportional to expected win rate (Eq. 33)."""
    ratings = [ctx.elo.get(m, ctx.profiles[m].elo if m in ctx.profiles
                           else 1200.0) for m in cands]
    mean_r = sum(ratings) / len(ratings)
    win = [1.0 / (1.0 + 10 ** ((mean_r - r) / 400.0)) for r in ratings]
    total = sum(win)
    if cfg.get("sample", False):
        x = ctx.rng.random() * total
        acc = 0.0
        for m, w in zip(cands, win):
            acc += w
            if x <= acc:
                return m, w / total
    i = int(np.argmax(win))
    return cands[i], win[i] / total


# ---------------------------------------------------------------------------
# embedding-based
# ---------------------------------------------------------------------------

def select_routerdc(e_q, z, cands, ctx, cfg):
    """Query-model embedding cosine (Eq. 34)."""
    sims = []
    for m in cands:
        e_m = ctx.model_emb.get(m)
        if e_m is None or not np.any(e_m):
            sims.append(0.0)
        else:
            sims.append(float(e_q @ e_m /
                              (np.linalg.norm(e_m) + 1e-9)))
    if max(sims) <= 0.0:
        return select_static(e_q, z, cands, ctx, cfg)
    i = int(np.argmax(sims))
    return cands[i], max(0.0, sims[i])


def select_hybrid(e_q, z, cands, ctx, cfg):
    """alpha*elo~ + beta*cos + gamma*(1-cost~) (Eq. 35, RouterBench)."""
    a = cfg.get("alpha", 0.4)
    b = cfg.get("beta", 0.3)
    g = cfg.get("gamma", 0.3)
    elos = np.array([ctx.elo.get(m, 1200.0) for m in cands])
    er = (elos - elos.min()) / max(1e-9, elos.max() - elos.min()) \
        if len(cands) > 1 else np.ones(1)
    cos = np.array([select_routerdc(e_q, z, [m], ctx, cfg)[1]
                    for m in cands])
    costs = np.array([ctx.profiles[m].cost_per_mtok if m in ctx.profiles
                      else 1.0 for m in cands])
    cr = (costs - costs.min()) / max(1e-9, costs.max() - costs.min()) \
        if len(cands) > 1 else np.zeros(1)
    score = a * er + b * cos + g * (1 - cr)
    i = int(np.argmax(score))
    return cands[i], float(score[i])


# ---------------------------------------------------------------------------
# cascading (AutoMix, §10.4)
# ---------------------------------------------------------------------------

def select_automix(e_q, z, cands, ctx, cfg):
    """POMDP cascade: order by cost, escalate while self-verification fails.
    ``verify_fn(model) -> q_hat`` is injected for live use; offline it
    falls back to profile quality + per-model threshold."""
    order = sorted(cands, key=lambda m: ctx.profiles[m].cost_per_mtok
                   if m in ctx.profiles else 1.0)
    thr = cfg.get("threshold", 0.6)
    verify = cfg.get("verify_fn")
    expected_cost = 0.0
    for m in order[:-1]:
        prof = ctx.profiles.get(m)
        expected_cost += prof.cost_per_mtok if prof else 1.0
        q_hat = verify(m) if verify else (prof.quality if prof else 0.5)
        if q_hat >= thr:
            return m, q_hat
    last = order[-1]
    prof = ctx.profiles.get(last)
    return last, prof.quality if prof else 0.5


# ---------------------------------------------------------------------------
# classical ML (§10.5) — trained on RoutingRecords
# ---------------------------------------------------------------------------

def _features(e_q: np.ndarray, z: int, n_domains: int = 14) -> np.ndarray:
    oh = np.zeros(n_domains, np.float32)
    oh[min(z, n_domains - 1)] = 1.0
    return np.concatenate([e_q, oh])


def select_knn(e_q, z, cands, ctx, cfg):
    """Quality-weighted k-NN vote (Eq. 38).  Single source of truth is
    the batched form; this is its B=1 view."""
    return _knn_many(np.asarray([e_q]), [z], list(cands), ctx, cfg)[0]


def select_kmeans(e_q, z, cands, ctx, cfg):
    """Cluster assignment -> best model for the cluster (Eq. 39)."""
    return _kmeans_many(np.asarray([e_q]), [z], list(cands), ctx, cfg)[0]


def select_svm(e_q, z, cands, ctx, cfg):
    """Linear one-vs-rest SVM (Pegasos SGD) over routing records."""
    return _svm_many(np.asarray([e_q]), [z], list(cands), ctx, cfg)[0]


def select_mlp(e_q, z, cands, ctx, cfg):
    """2-hidden-layer ReLU MLP (Eq. 40), trained in torch on records."""
    return _mlp_many(np.asarray([e_q]), [z], list(cands), ctx, cfg)[0]


# ---------------------------------------------------------------------------
# reinforcement learning (§10.6)
# ---------------------------------------------------------------------------

def select_thompson(e_q, z, cands, ctx, cfg):
    best, best_s = None, -1.0
    for m in cands:
        a, b = ctx.beta.get(m, [1.0, 1.0])
        s = np.random.default_rng(
            abs(hash((m, len(ctx.records)))) % (2 ** 31)).beta(a, b)
        if s > best_s:
            best, best_s = m, s
    return best, float(best_s)


def select_gmt(e_q, z, cands, ctx, cfg):
    """GMTRouter-style heterogeneous-graph scoring: two rounds of
    mean-aggregation over (user, query, model) interaction edges."""
    user = cfg.get("user", "anon")
    recs = [r for r in ctx.records if r.model in cands]
    if not recs:
        return select_static(e_q, z, cands, ctx, cfg)
    # node features: users/models start from interaction means
    model_feat: Dict[str, np.ndarray] = {}
    user_feat: Dict[str, np.ndarray] = {}
    for _ in range(2):  # message-passing rounds
        mf2, uf2 = {}, {}
        for m in cands:
            neigh = [np.concatenate([r.embedding, [r.quality]])
                     for r in recs if r.model == m]
            if neigh:
                base = np.mean(neigh, axis=0)
                u_msg = [user_feat.get(r.user) for r in recs
                         if r.model == m and r.user in user_feat]
                if u_msg:
                    base = 0.7 * base + 0.3 * np.mean(u_msg, axis=0)
                mf2[m] = base
        for u in {r.user for r in recs}:
            neigh = [model_feat.get(r.model) for r in recs
                     if r.user == u and r.model in model_feat]
            if neigh:
                uf2[u] = np.mean(neigh, axis=0)
            else:
                mine = [np.concatenate([r.embedding, [r.quality]])
                        for r in recs if r.user == u]
                uf2[u] = np.mean(mine, axis=0)
        model_feat, user_feat = mf2, uf2
    qf = np.concatenate([e_q, [0.5]])
    uf = user_feat.get(user)
    scores = {}
    for m in cands:
        f = model_feat.get(m)
        if f is None:
            scores[m] = 0.0
            continue
        s = float(qf @ f / (np.linalg.norm(qf) * np.linalg.norm(f) + 1e-9))
        if uf is not None:
            s = 0.7 * s + 0.3 * float(
                uf @ f / (np.linalg.norm(uf) * np.linalg.norm(f) + 1e-9))
        scores[m] = s
    best = max(scores, key=scores.get)
    return best, max(0.0, scores[best])


# ---------------------------------------------------------------------------
# latency-aware (§10.7)
# ---------------------------------------------------------------------------

def select_latency(e_q, z, cands, ctx, cfg):
    """Normalized percentile TPOT/TTFT score, minimized (Eq. 43)."""
    pcts = cfg.get("percentiles", [50, 95])
    obs = {m: ctx.latency.get(m) or
           [ctx.profiles[m].latency_ms if m in ctx.profiles else 200.0]
           for m in cands}
    per_p = {}
    for p in pcts:
        vals = {m: float(np.percentile(obs[m], p)) for m in cands}
        mn = min(vals.values()) or 1.0
        per_p[p] = {m: v / mn for m, v in vals.items()}
    scores = {m: float(np.mean([per_p[p][m] for p in pcts])) for m in cands}
    best = min(scores, key=scores.get)
    return best, 1.0 / scores[best]


# ---------------------------------------------------------------------------
# batched selection: one matrix-form pass over the whole batch (§10, batched)
# ---------------------------------------------------------------------------

def _static_many(E_q, zs, cands, ctx, cfg):
    # profile ranking is query-independent: compute once, replicate
    pick = select_static(E_q[0], zs[0], cands, ctx, cfg)
    return [pick] * len(E_q)


def _knn_many(E_q, zs, cands, ctx, cfg):
    """Row-batched quality-weighted k-NN: ONE (B, R) distance matrix and
    one row-wise argsort replace B independent record scans."""
    k = cfg.get("k", 5)
    recs = [r for r in ctx.records if r.model in cands]
    if not recs:
        return _static_many(E_q, zs, cands, ctx, cfg)
    F = np.stack([_features(E_q[i], zs[i]) for i in range(len(E_q))])
    feats = np.stack([_features(r.embedding, r.domain) for r in recs])
    d = np.linalg.norm(feats[None] - F[:, None], axis=2)        # (B, R)
    nn = np.argsort(d, axis=1)[:, :k]
    out = []
    for row in nn:
        votes: Dict[str, float] = {}
        for i in row:
            votes[recs[i].model] = votes.get(recs[i].model, 0.0) + \
                recs[i].quality
        best = max(votes, key=votes.get)
        out.append((best, votes[best] / max(1e-9, sum(votes.values()))))
    return out


def _kmeans_many(E_q, zs, cands, ctx, cfg):
    """Centroids/assignments depend only on the records: fit ONCE per
    batch, then assign all B queries with one (B, k) distance matrix."""
    alpha = cfg.get("alpha", 0.7)
    k = cfg.get("clusters", 4)
    recs = [r for r in ctx.records if r.model in cands]
    if len(recs) < k:
        return _static_many(E_q, zs, cands, ctx, cfg)
    X = np.stack([r.embedding for r in recs])
    rng = np.random.RandomState(0)
    cents = X[rng.choice(len(X), k, replace=False)]
    for _ in range(10):
        assign = np.argmin(np.linalg.norm(X[:, None] - cents[None], axis=2),
                           axis=1)
        for c in range(k):
            pts = X[assign == c]
            if len(pts):
                cents[c] = pts.mean(0)
    # per-cluster model scores, computed once
    cluster_scores: List[Dict[str, List[float]]] = [dict() for _ in range(k)]
    for r, a in zip(recs, assign):
        cluster_scores[a].setdefault(r.model, []).append(r.quality)

    def sc(scores, m):
        q = float(np.mean(scores[m]))
        lat = float(np.mean(ctx.latency.get(m, [200.0]))) / 1000.0
        return alpha * q - (1 - alpha) * lat

    out = []
    cq_all = np.argmin(np.linalg.norm(cents[None] - np.asarray(E_q)[:, None],
                                      axis=2), axis=1)
    for b, cq in enumerate(cq_all):
        scores = cluster_scores[int(cq)]
        if not scores:
            out.append(select_static(E_q[b], zs[b], cands, ctx, cfg))
            continue
        best = max(scores, key=lambda m: sc(scores, m))
        out.append((best, float(np.mean(scores[best]))))
    return out


def _svm_many(E_q, zs, cands, ctx, cfg):
    """Pegasos weights depend only on the records: train each one-vs-rest
    classifier ONCE, score the whole batch as F @ W.T."""
    recs = [r for r in ctx.records if r.model in cands and r.quality >= 0.5]
    if len(recs) < 4 or len({r.model for r in recs}) < 2:
        return _static_many(E_q, zs, cands, ctx, cfg)
    models = sorted({r.model for r in recs})
    X = np.stack([_features(r.embedding, r.domain) for r in recs])
    lam = cfg.get("lambda", 0.01)
    W = []
    for m in models:
        y = np.array([1.0 if r.model == m else -1.0 for r in recs])
        w = np.zeros(X.shape[1])
        for t in range(1, cfg.get("epochs", 20) * len(recs) + 1):
            i = (t * 2654435761) % len(recs)
            eta = 1.0 / (lam * t)
            margin = y[i] * (w @ X[i])
            w *= (1 - eta * lam)
            if margin < 1:
                w += eta * y[i] * X[i]
        W.append(w)
    W = np.stack(W)                                           # (M, Feat)
    F = np.stack([_features(E_q[i], zs[i]) for i in range(len(E_q))])
    S = F @ W.T                                               # (B, M)
    out = []
    for row in S:
        i = int(np.argmax(row))
        out.append((models[i], 1.0 / (1.0 + math.exp(-float(row[i])))))
    return out


def _mlp_init(dims: Sequence[int], generator: torch.Generator
              ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Initial (weight, bias) per layer: weights N(0, 0.1^2) of shape
    (dims[i], dims[i + 1]), biases zero, float32 on the generator's device.

    The reference draws its weights from ``jax.random.PRNGKey(0)`` split
    three ways, which torch cannot reproduce; the port draws from an
    explicit ``torch.Generator``.  The parity tests monkeypatch this
    function with the reference's draws, bridged through numpy, so both
    packages train from the same start."""
    return [(torch.randn(dims[i], dims[i + 1], generator=generator) * 0.1,
             torch.zeros(dims[i + 1])) for i in range(len(dims) - 1)]


def _mlp_fwd(p, x):
    for w, b in p[:-1]:
        x = torch.relu(x @ w + b)
    w, b = p[-1]
    return x @ w + b


def _mlp_many(E_q, zs, cands, ctx, cfg):
    """The 60-step SGD loop (torch.autograd, the reference's weighted
    log-softmax loss) runs ONCE per batch (it only sees the records) on
    ``ctx.device``; inference is one batched softmax forward over all B
    queries, brought to the host in one transfer."""
    recs = [r for r in ctx.records if r.model in cands]
    models = sorted({r.model for r in recs})
    if len(recs) < 8 or len(models) < 2:
        return _static_many(E_q, zs, cands, ctx, cfg)
    dev = resolve_device(ctx.device)
    X = torch.as_tensor(np.stack([_features(r.embedding, r.domain)
                                  for r in recs]), dtype=torch.float32,
                        device=dev)
    y = torch.as_tensor([models.index(r.model) for r in recs],
                        dtype=torch.long, device=dev)
    qw = torch.as_tensor([r.quality for r in recs], dtype=torch.float32,
                         device=dev)
    h = cfg.get("hidden", 64)
    dims = [X.shape[1], h, h, len(models)]
    params = [(w.to(dev).requires_grad_(), b.to(dev).requires_grad_())
              for w, b in _mlp_init(dims, torch.Generator().manual_seed(0))]
    flat = [t for wb in params for t in wb]
    lr = float(cfg.get("lr", 0.05))
    for _ in range(cfg.get("steps", 60)):
        ll = torch.log_softmax(_mlp_fwd(params, X), dim=-1)
        loss = -(qw * ll.gather(1, y[:, None])[:, 0]).mean()
        grads = torch.autograd.grad(loss, flat)
        with torch.no_grad():
            for t, g in zip(flat, grads):
                t.sub_(lr * g)
    F = torch.as_tensor(np.stack([_features(E_q[i], zs[i])
                                  for i in range(len(E_q))]),
                        dtype=torch.float32, device=dev)
    with torch.no_grad():
        probs = torch.softmax(_mlp_fwd(params, F), dim=-1).cpu().numpy()
    out = []
    for row in probs:
        i = int(np.argmax(row))
        out.append((models[i], float(row[i])))
    return out


def _thompson_many(E_q, zs, cands, ctx, cfg):
    # the per-model Beta draw is seeded by (model, record count) only —
    # identical for every request in the batch, so sample once
    pick = select_thompson(E_q[0], zs[0], cands, ctx, cfg)
    return [pick] * len(E_q)


_BATCHED: Dict[str, Any] = {
    "static": _static_many,
    "knn": _knn_many,
    "kmeans": _kmeans_many,
    "svm": _svm_many,
    "mlp": _mlp_many,
    "thompson": _thompson_many,
}


def select_many(name: str, E_q: np.ndarray, zs: Sequence[int],
                cands: Sequence[str], ctx: SelectionContext,
                cfg: Dict[str, Any],
                users: Optional[Sequence[Optional[str]]] = None
                ) -> List[Tuple[str, float]]:
    """Batched selection front door: (B, dim) query embeddings + domains
    -> one (model, conf) per row.  Algorithms with a matrix form (knn,
    kmeans, svm, mlp, thompson, static) run ONCE over the whole batch
    (training/featurization amortized, scores vectorized); the rest fall
    back to per-row calls with per-request ``user`` config, preserving
    sequential semantics exactly."""
    B = len(E_q)
    users = list(users) if users is not None else [None] * B
    if name == "confidence":              # DSL alias, same as get_algorithm
        name = "hybrid"
    impl = _BATCHED.get(name)
    if impl is not None and B > 1 and "user" not in cfg:
        d = dict(cfg)
        d.setdefault("user", users[0] or "anon")
        return impl(np.asarray(E_q), list(zs), list(cands), ctx, d)
    algo = get_algorithm(name)
    out = []
    for i in range(B):
        d = dict(cfg)
        d.setdefault("user", users[i] or "anon")
        out.append(algo(E_q[i], zs[i], list(cands), ctx, d))
    return out


ALGORITHMS: Dict[str, Algorithm] = {
    "static": select_static,
    "elo": select_elo,
    "routerdc": select_routerdc,
    "hybrid": select_hybrid,
    "automix": select_automix,
    "knn": select_knn,
    "kmeans": select_kmeans,
    "svm": select_svm,
    "mlp": select_mlp,
    "thompson": select_thompson,
    "gmt": select_gmt,
    "latency": select_latency,
    # "remom" dispatches through repro_torch.core.selection.remom (multi-round)
}


def get_algorithm(name: str) -> Algorithm:
    if name == "confidence":      # DSL alias: confidence-weighted hybrid
        return select_hybrid
    return ALGORITHMS[name]
