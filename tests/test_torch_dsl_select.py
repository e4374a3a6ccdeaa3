"""The port's policy compiler, Level-4 verifier and model selectors against
the JAX package on the CPU.

* Policies compile alike: ``serve.py``'s demo DSL and every
  ``examples/policies/*.vsr`` compile to equal ``RouterConfig``s in both
  packages (decisions, priorities, rules, plugins, profiles, endpoints,
  signals: ``dataclasses.asdict`` of each), with equal diagnostics and
  ``verify_config`` findings (text and fatality); ``decompile`` gives the
  same text and round-trips to a fixed point in the port.
* Selectors agree: every algorithm's ``select_many`` picks the JAX
  package's model over the same ``SelectionContext`` state, confidence
  within 1e-6 (numpy on both sides).  The ``mlp`` selector trains in torch
  (the reference in JAX): with the reference's initial draws bridged into
  ``_mlp_init``, its probabilities agree within 1e-5 (float32 on both
  sides, 60 SGD steps; summation order only).
"""

import dataclasses
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.analysis.policy_verify import verify_config as j_verify
from repro.classifiers.backend import HashBackend as JHash
from repro.core import decision as JD
from repro.core.dsl import compile_source as j_compile
from repro.core.dsl import decompile as j_decompile
from repro.core.selection import algorithms as JA
from repro.core.types import ModelProfile as JProfile
from repro.launch.serve import DEMO_REQUESTS as J_DEMO
from repro.launch.serve import build_dsl as j_build_dsl
from repro_torch.analysis import verify_config as t_verify
from repro_torch.classifiers.backend import HashBackend
from repro_torch.configs import get_config, get_reduced
from repro_torch.core import decision as TD
from repro_torch.core.dsl import compile_source as t_compile
from repro_torch.core.dsl import decompile as t_decompile
from repro_torch.core.dsl.emit import config_to_dict
from repro_torch.core.observability import Span, stage_scope
from repro_torch.core.prefix import PrefixIndex, text_block_hashes
from repro_torch.core.selection import algorithms as TA
from repro_torch.core.types import ModelProfile as TProfile
from repro_torch.launch.serve import DEMO_REQUESTS, build_dsl

ROOT = Path(__file__).resolve().parents[1]
POLICIES = ("serve", "cost", "privacy", "lint_demo")
CONF_TOL = 1e-6
MLP_TOL = 1e-5


def _source(name):
    if name == "serve":
        return build_dsl()
    return (ROOT / "examples" / "policies" / f"{name}.vsr").read_text()


# ---------------------------------------------------------------------------
# policies
# ---------------------------------------------------------------------------

def test_serve_demo_dsl_and_requests_are_the_reference_text_lane():
    assert build_dsl() == j_build_dsl(("text",))
    assert DEMO_REQUESTS == J_DEMO


@pytest.mark.parametrize("name", POLICIES)
def test_policy_compiles_alike(name):
    src = _source(name)
    jcfg, jd = j_compile(src)
    tcfg, td = t_compile(src)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.decisions, name
    assert [(str(d), d.level) for d in td] == [(str(d), d.level) for d in jd]


@pytest.mark.parametrize("name", POLICIES)
def test_verify_findings_alike(name):
    src = _source(name)
    jf = [(str(d), d.fatal) for d in j_verify(j_compile(src)[0])]
    tf = [(str(d), d.fatal) for d in t_verify(t_compile(src)[0])]
    assert tf == jf
    # the demo pragma's file is the one with fatal findings
    assert any(f for _, f in tf) == (name == "lint_demo")


@pytest.mark.parametrize("name", POLICIES)
def test_decompile_round_trips_like_the_reference(name):
    cfg, _ = t_compile(_source(name))
    src2 = t_decompile(cfg)
    assert src2 == j_decompile(j_compile(_source(name))[0])
    cfg2, _ = t_compile(src2)
    assert json.dumps(config_to_dict(cfg), sort_keys=True) == \
        json.dumps(config_to_dict(cfg2), sort_keys=True)
    assert t_decompile(cfg2) == src2


@pytest.mark.parametrize("name", POLICIES)
def test_coverage_analysis_and_subsumes_alike(name):
    src = _source(name)
    jdec = j_compile(src)[0].decisions
    tdec = t_compile(src)[0].decisions
    assert TD.coverage_analysis(tdec) == JD.coverage_analysis(jdec)
    for a in range(len(tdec)):
        for b in range(len(tdec)):
            assert TD.subsumes(tdec[a].rule, tdec[b].rule) == \
                JD.subsumes(jdec[a].rule, jdec[b].rule)


def test_glm4_config_matches_reference():
    from repro.configs import get_config as j_get, get_reduced as j_red
    assert dataclasses.asdict(get_config("glm4-9b")) == \
        dataclasses.asdict(j_get("glm4-9b"))
    assert dataclasses.asdict(get_reduced("glm4-9b")) == \
        dataclasses.asdict(j_red("glm4-9b"))
    cfg = get_config("glm4-9b")
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.vocab_size) == \
        (32, 2, 128, 151552)


def test_prefix_index_and_spans_match_reference():
    from repro.core.prefix import PrefixIndex as JIndex
    from repro.core.prefix import text_block_hashes as j_hashes
    text = " ".join(f"word{i}" for i in range(70))
    assert text_block_hashes(text) == j_hashes(text)
    assert len(text_block_hashes(text)) == 70 // 16
    ti, ji = PrefixIndex(), JIndex()
    for idx in (ti, ji):
        idx.insert("a", j_hashes(text))
        idx.insert("b", j_hashes(text)[:2])
    assert ti.match(text_block_hashes(text)) == \
        ji.match(j_hashes(text)) == {"a": 4, "b": 2}
    root = Span("pipeline")
    with stage_scope(root, "stage:decide", batch=3) as span:
        pass
    assert root.children == [span] and span.end is not None
    assert span.attributes == {"batch": 3}


# ---------------------------------------------------------------------------
# selectors
# ---------------------------------------------------------------------------

CANDS = ["cheap", "mid", "big"]


def _ctx(A, Profile, device=None):
    """A SelectionContext with records clustered per model, latencies,
    feedback and Elo games (the same state in either package)."""
    kw = {} if device is None else {"device": device}
    ctx = A.SelectionContext(profiles={
        m: Profile(m, cost_per_mtok=0.1 * 3 ** i, quality=0.4 + 0.25 * i,
                   latency_ms=50.0 * (i + 1))
        for i, m in enumerate(CANDS)}, **kw)
    rng = np.random.RandomState(0)
    emb = HashBackend().embed([f"query {i} about topic {i % 3}"
                               for i in range(24)])
    for i in range(24):
        m = CANDS[i % 3]
        e = emb[i] + 0.5 * rng.randn(emb.shape[1]).astype(np.float32)
        e[i % 3] += 2.0
        ctx.add_record(A.RoutingRecord(e.astype(np.float32), i % 3, m,
                                       0.9 if i % 3 == 2 else 0.6,
                                       user=f"u{i % 2}"))
        ctx.observe_latency(m, 80.0 + 60.0 * (i % 3) + i)
        ctx.update_feedback(m, i % 4 != 1)
    ctx.update_elo("big", "cheap")
    ctx.update_elo("mid", "cheap")
    return ctx


def _queries():
    E = JHash().embed(["solve the integral", "debug the python api",
                       "capital of france", "prove the lemma",
                       "sort a list", "urgent incident"])
    return E, [0, 1, 2, 0, 1, 2], [f"u{i % 2}" for i in range(6)]


def _jax_mlp_init(dims, generator):
    """The reference's initial MLP draws (``jax.random.PRNGKey(0)`` split
    three ways, N(0, 0.1^2)), bridged to torch through numpy."""
    ks = jax.random.split(jax.random.PRNGKey(0), 3)
    return [(torch.from_numpy(np.array(
        jax.random.normal(ks[i], (dims[i], dims[i + 1])) * 0.1)),
             torch.zeros(dims[i + 1])) for i in range(len(dims) - 1)]


@pytest.mark.parametrize("algo", sorted(TA.ALGORITHMS) + ["confidence"])
@pytest.mark.parametrize("batched", [True, False], ids=["many", "one"])
def test_selector_matches_reference(algo, batched, monkeypatch):
    monkeypatch.setattr(TA, "_mlp_init", _jax_mlp_init)
    E, zs, users = _queries()
    jctx = _ctx(JA, JProfile)
    tctx = _ctx(TA, TProfile, device="cpu")
    if batched:
        want = JA.select_many(algo, E, zs, CANDS, jctx, {}, users=users)
        got = TA.select_many(algo, E, zs, CANDS, tctx, {}, users=users)
    else:
        want = [JA.get_algorithm(algo)(E[i], zs[i], CANDS, jctx,
                                       {"user": users[i]})
                for i in range(len(E))]
        got = [TA.get_algorithm(algo)(E[i], zs[i], CANDS, tctx,
                                      {"user": users[i]})
               for i in range(len(E))]
    assert [m for m, _ in got] == [m for m, _ in want]
    tol = MLP_TOL if algo == "mlp" else CONF_TOL
    for (_, g), (_, w) in zip(got, want):
        assert g == pytest.approx(w, abs=tol)
    # closed-loop state moved alike
    assert tctx.elo == jctx.elo and tctx.beta == jctx.beta


def test_mlp_trains_from_its_own_draws():
    """Without the bridge the port draws its initial weights from
    ``torch.Generator().manual_seed(0)``: deterministic, and it still
    learns the clustered records' split."""
    E, zs, users = _queries()
    a = TA.select_many("mlp", E, zs, CANDS, _ctx(TA, TProfile, "cpu"), {})
    b = TA.select_many("mlp", E, zs, CANDS, _ctx(TA, TProfile, "cpu"), {})
    assert a == b
    dims = [E.shape[1] + 14, 64, 64, 3]
    init = TA._mlp_init(dims, torch.Generator().manual_seed(0))
    assert [tuple(w.shape) for w, _ in init] == \
        [(dims[i], dims[i + 1]) for i in range(3)]
    assert all(float(b.abs().sum()) == 0.0 for _, b in init)
    assert 0.08 < float(init[0][0].std()) < 0.12
