"""The port's serving front against the JAX package on the CPU: the
overload detector and its fleet probe, SLO admission (shed, degrade,
premium pass), priority preemption with park/resume, the fleet
autoscaler, ``AsyncFrontend``, the image lane and ``serve.py --async
--lanes text,image``.

* Detector: the same ``EngineLoad`` sequences graded by both packages'
  ``OverloadDetector`` give the same states (hysteresis, KV headroom).
* Admission: ``tests/test_qos.py``'s ``QOS_DSL`` through both routers
  (echo transport) with a detector forced to one state: equal headers,
  decisions and models; a legacy policy never samples the detector.
* Preemption: the reference's ``_preempt_roundtrip`` on reduced float32
  smollm-360m (GQA) and deepseek-v2 (MLA + MoE) fleets, weights bridged:
  the victims resume token-exactly, on both sides, with equal tokens.
* Probes: ``fleet_probe`` reads the reference's ``EngineLoad`` off the
  same fleet state; the probe cases of ``tests/test_disagg.py`` and
  ``tests/test_spec_decode.py``.
* Frontend: ``tests/test_scheduler.py``'s, ``test_qos.py``'s and
  ``test_disagg.py``'s stub-router cases, the reload stress of
  ``test_policy.py`` on the port's router, and ``AsyncFrontend`` over the
  port's router and a reduced fleet == direct ``route_batch``.
* Image lane: latents within 1e-6 of the JAX lane's and equal image
  ``sig``s and payloads, slot batching and determinism; the
  ``text,image`` demo router's decisions and endpoints equal the JAX
  router's.
"""

import contextlib
import io
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import types as JT
from repro.core.dsl import compile_source as j_compile
from repro.core.observability import METRICS as J_METRICS
from repro.core.router import SemanticRouter as JRouter
from repro.launch import serve as jserve
from repro.serving import fleet as JF
from repro.serving import overload as JO
from repro_torch.bridge import params_from_jax
from repro_torch.core import types as TT
from repro_torch.core.dsl import compile_source as t_compile
from repro_torch.core.observability import METRICS as T_METRICS
from repro_torch.core.router import SemanticRouter
from repro_torch.launch import serve
from repro_torch.serving import fleet as TF
from repro_torch.serving import overload as TO
from repro_torch.serving.frontend import AsyncFrontend
from repro_torch.serving.scheduler import SpecConfig

ATTN_ARCH = "smollm-360m"
MLA_ARCH = "deepseek-v2-236b"
IMG_ARCH = "sd-tiny"
LATENT_TOL = 1e-6

# tests/test_qos.py's policy
QOS_DSL = """
SIGNAL keyword urgent { keywords: ["urgent"] }

ROUTE premium (description = "interactive tier") {
  PRIORITY 10
  WHEN keyword("urgent")
  MODEL "large"
  SLO { class: "premium", priority: 100, ttft_ms: 500.0 }
}

ROUTE bulk (description = "degradable tier") {
  PRIORITY 1
  WHEN keyword("urgent")
  MODEL "large"
  SLO { class: "batch", degrade_to: "small" }
}

BACKEND ep0 vllm { address: "127.0.0.1", port: 8000,
                   models: ["large", "small"] }

GLOBAL { default_model: "small",
         overload: { queue_depth: 4, shed_below: 100,
                     retry_after_s: 0.5, default_class: "best_effort" } }
"""

LEGACY_DSL = """
SIGNAL keyword k { keywords: ["urgent"] }
ROUTE r { WHEN keyword("k") MODEL "m" }
BACKEND ep0 vllm { address: "127.0.0.1", port: 8000, models: ["m"] }
GLOBAL { default_model: "m" }
"""


def _counter(metrics, prefix):
    return sum(v for k, v in metrics.counters.items()
               if k.split("{")[0] == prefix)


class _ForcedDetector:
    """Detector stand-in pinned to one state; records sample calls."""

    def __init__(self, state):
        self.state = state
        self.samples = 0

    def sample(self, policy=None, force=False):
        self.samples += 1
        return self.state


# ---------------------------------------------------------------------------
# overload detector
# ---------------------------------------------------------------------------

_BASE = dict(queue_depth=0, active_slots=0, slots=4, free_blocks=90,
             total_blocks=100)
# (field -> value) changes applied in turn; test_qos.py's sequence first
LOAD_SEQUENCES = {
    "reference": [{}, {"queue_depth": 4}, {"queue_depth": 8},
                  {"queue_depth": 0, "free_blocks": 3},
                  {"free_blocks": 90}, {}],
    "kv_headroom": [{"free_blocks": 9}, {"free_blocks": 5},
                    {"free_blocks": 4}, {"free_blocks": 11}, {}, {},
                    {"free_blocks": 20}, {}],
    "occupancy_and_ttft": [{"active_slots": 4}, {"active_slots": 3},
                           {"ttft_ewma_ms": 300.0}, {"ttft_ewma_ms": 600.0},
                           {"ttft_ewma_ms": 10.0, "active_slots": 0}, {},
                           {"queue_depth": 5}, {"queue_depth": 0}, {}, {}],
    "flapping": [{"queue_depth": 9}, {"queue_depth": 0},
                 {"queue_depth": 9}, {"queue_depth": 0},
                 {"queue_depth": 0}, {"queue_depth": 4},
                 {"queue_depth": 0}, {}, {}],
}


def _grade_sequence(O, steps, policy):
    load = O.EngineLoad(**_BASE)
    det = O.OverloadDetector(interval_s=0.0)
    det.add_probe(lambda: O.EngineLoad(**vars(load)))
    states = []
    for change in steps:
        for k, v in change.items():
            setattr(load, k, v)
        states.append(det.sample(policy, force=True))
    return states, det


@pytest.mark.parametrize("name", sorted(LOAD_SEQUENCES))
def test_detector_states_match_reference(name):
    steps = LOAD_SEQUENCES[name]
    kw = dict(queue_depth=8, slot_occupancy=0.9, free_block_frac=0.05,
              ttft_ms=500.0)
    want, jdet = _grade_sequence(JO, steps, JT.OverloadPolicy(**kw))
    got, tdet = _grade_sequence(TO, steps, TT.OverloadPolicy(**kw))
    assert got == want
    assert vars(tdet.load) == vars(jdet.load)
    assert T_METRICS.gauges.get("overload_state") == \
        {"ok": 0, "busy": 1, "overload": 2}[got[-1]]
    if name == "reference":
        assert got == ["ok", "busy", "overload", "overload", "overload", "ok"]
        assert "vsr_overload_state 0" in T_METRICS.scrape()


def test_detector_throttles_to_interval():
    det = TO.OverloadDetector(interval_s=60.0)
    calls = []
    det.add_probe(lambda: calls.append(1) or TO.EngineLoad(queue_depth=99))
    pol = TT.OverloadPolicy(queue_depth=8)
    assert det.sample(pol) == "overload"
    assert det.sample(pol) == "overload" and len(calls) == 1
    det.sample(pol, force=True)
    assert len(calls) == 2


# ---------------------------------------------------------------------------
# admission control through both routers
# ---------------------------------------------------------------------------

def _qos_routers(state, src=QOS_DSL):
    jcfg, _ = j_compile(src)
    tcfg, _ = t_compile(src)
    jr, tr = JRouter(jcfg), SemanticRouter(tcfg, device="cpu")
    jr.overload, tr.overload = _ForcedDetector(state), _ForcedDetector(state)
    return jr, tr


def _req(T, text, **md):
    return T.Request(messages=[T.Message("user", text)], metadata=md)


def _key(pair):
    resp, out = pair
    return (out.decision, out.model, dict(resp.headers), resp.finish_reason,
            resp.content)


ADMISSION_CASES = {
    "shed": ("overload", [("hello there", {})]),
    "degrade": ("overload", [("urgent bulk job", {"slo": "batch"})]),
    "premium": ("overload", [("urgent question", {"slo": "premium"})]),
    "busy": ("busy", [("urgent bulk job", {"slo": "batch"}),
                      ("plain question", {})]),
    "mixed": ("overload", [("plain question one", {}),
                           ("urgent question", {"slo": "premium"}),
                           ("urgent bulk job", {"slo": "batch"}),
                           ("plain question two", {})]),
    "ok": ("ok", [("plain question", {}),
                  ("urgent bulk job", {"slo": "batch"})]),
}


@pytest.mark.parametrize("case", sorted(ADMISSION_CASES))
def test_admission_matches_reference(case):
    state, rows = ADMISSION_CASES[case]
    jr, tr = _qos_routers(state)
    ctr = ("admission_rejected_total", "admission_degraded_total")
    j0 = [_counter(J_METRICS, c) for c in ctr]
    t0 = [_counter(T_METRICS, c) for c in ctr]
    want = jr.route_batch([_req(JT, t, **md) for t, md in rows])
    got = tr.route_batch([_req(TT, t, **md) for t, md in rows])
    assert [_key(p) for p in got] == [_key(p) for p in want]
    assert [_counter(T_METRICS, c) - n for c, n in zip(ctr, t0)] == \
        [_counter(J_METRICS, c) - n for c, n in zip(ctr, j0)]
    if case == "mixed":
        assert got[0][0].headers["x-vsr-error"] == "overload"
        assert got[0][0].headers["retry-after"] == "0.5"
        assert got[1][1].decision == "premium"
        assert got[2][0].headers["x-vsr-degraded"] == "small"
    tr.close()


def test_admission_route_raises_typed_error_like_reference():
    jr, tr = _qos_routers("overload")
    errs = []
    for r, T in ((jr, JT), (tr, TT)):
        with pytest.raises(T.RouterOverloadError) as ei:
            r.route(_req(T, "hello there"))
        errs.append((ei.value.retry_after_s, ei.value.slo_class))
        _, out = r.route(_req(T, "urgent bulk job", slo="batch"))
        errs.append((out.model, bool(out.signals.matches)))
    assert errs[2:] == errs[:2] == [(0.5, "best_effort"), ("small", False)]
    tr.close()


def test_legacy_policy_never_samples_detector():
    jr, tr = _qos_routers("overload", LEGACY_DSL)
    pairs = []
    for r, T in ((jr, JT), (tr, TT)):
        req = _req(T, "urgent request")
        pairs.append(r.route(req))
        assert r.overload.samples == 0
        assert "slo_priority" not in req.metadata
    assert _key(pairs[1]) == _key(pairs[0])
    assert pairs[1][1].decision == "r"
    tr.close()


# ---------------------------------------------------------------------------
# scheduler: preemption round trip on bridged reduced fleets
# ---------------------------------------------------------------------------

def _pair(arch, **kw):
    f32 = {arch: {"dtype": "float32"}}
    jf = JF.LocalFleet([arch], batch=3, gen_tokens=6, paged=True,
                       warmup=False, decode_impl="xla", arch_overrides=f32,
                       **kw)
    tf = TF.LocalFleet([arch], batch=3, gen_tokens=6, warmup=False,
                       arch_overrides=f32, device="cpu", **kw)
    tf.members[arch].params.load_state_dict(
        params_from_jax(jf.members[arch].params))
    return jf, tf


@pytest.fixture(scope="module")
def attn_pair():
    return _pair(ATTN_ARCH)


@pytest.fixture(scope="module")
def mla_pair():
    return _pair(MLA_ARCH)


def _preempt_roundtrip(fleet, arch, metrics):
    """The reference's round trip: fill the slots with low-priority rows,
    land a VIP, and return (uninterrupted tokens, resumed tokens, VIP
    tokens); asserts one preemption, a parked victim and a clean pool."""
    lane = fleet.lanes[arch]
    sched = fleet.schedulers[arch]
    victims = [f"background analysis over corpus {i} with clauses {i}"
               for i in range(3)]
    ref = [o["tokens"] for o in fleet.generate(arch, victims, max_new=6)]
    pre0, parks0 = sched.preempted, _counter(metrics, "preemptions_total")
    rids = [lane.submit(p, max_new=6, priority=0, slo="batch")
            for p in victims]
    lane.step()                      # victims decode a couple of tokens
    lane.step()
    hi = lane.submit("urgent vip request", max_new=2, priority=100,
                     slo="premium")
    finished = {}
    while sched.pending:
        for seq in lane.step():
            finished[seq.rid] = seq
    assert sched.preempted == pre0 + 1
    assert _counter(metrics, "preemptions_total") == parks0 + 1
    victim = next(s for s in finished.values() if s.parks > 0)
    assert victim.priority == 0
    assert finished[hi].out
    assert sched.pool.live_refs() == 0, "BlockPool leaked references"
    return ref, [list(finished[r].out) for r in rids], list(finished[hi].out)


@pytest.mark.parametrize("arch", [ATTN_ARCH, MLA_ARCH])
def test_preemption_roundtrip_matches_reference(arch, attn_pair, mla_pair):
    jf, tf = attn_pair if arch == ATTN_ARCH else mla_pair
    jref, jgot, jvip = _preempt_roundtrip(jf, arch, J_METRICS)
    tref, tgot, tvip = _preempt_roundtrip(tf, arch, T_METRICS)
    assert tgot == tref, f"park/resume diverged on {arch}"
    assert (tref, tgot, tvip) == (jref, jgot, jvip)


def test_priority_queue_order_matches_reference(attn_pair):
    orders = []
    for fleet in attn_pair:
        lane, sched = fleet.lanes[ATTN_ARCH], fleet.schedulers[ATTN_ARCH]
        rids = [lane.submit(f"prompt number {i}", priority=p)
                for i, p in enumerate([0, 5, 0, 10, 5])]
        orders.append([(s.priority, rids.index(s.rid)) for s in sched.queue])
        pre0 = sched.preempted
        sched.drain()
        assert sched.preempted == pre0 and sched.pool.live_refs() == 0
    assert orders[1] == orders[0] == [(10, 3), (5, 1), (5, 4), (0, 0),
                                      (0, 2)]


# ---------------------------------------------------------------------------
# overload probes
# ---------------------------------------------------------------------------

PROBE_FIELDS = ("queue_depth", "active_slots", "slots", "free_blocks",
                "total_blocks", "spec_accept_ewma", "spec_tokens_per_step")


def test_fleet_probe_matches_reference_on_same_state(attn_pair):
    """The port's probe reads the reference's EngineLoad off the same
    fleet state, step by step (TTFT fields are wall clock: the sample
    counts compare instead)."""
    prompts = [" ".join(f"w{i}{j}" for j in range(3 + 9 * i))
               for i in range(5)]
    traces = [[], []]
    for k, fleet in enumerate(attn_pair):
        lane, sched = fleet.lanes[ATTN_ARCH], fleet.schedulers[ATTN_ARCH]
        probe = (JO if k == 0 else TO).fleet_probe(fleet)
        n0 = sched.ttft_samples
        for p in prompts:
            lane.submit(p, max_new=4)
        while True:
            load = probe()
            traces[k].append(tuple(getattr(load, f) for f in PROBE_FIELDS)
                             + (sched.ttft_samples - n0,))
            if not sched.pending:
                break
            lane.step()
    assert traces[1] == traces[0]
    assert traces[1][0][0] == len(prompts) and traces[1][-1][0] == 0
    assert traces[1][-1][-1] == len(prompts)


@pytest.fixture(scope="module")
def small_fleet():
    return TF.LocalFleet([ATTN_ARCH], batch=2, gen_tokens=6, max_seq=64,
                         warmup=False, device="cpu")


def test_ttft_ewma_not_reset_by_zero_sample(small_fleet):
    sched = small_fleet.schedulers[ATTN_ARCH]
    sched.ttft_ewma, sched.ttft_samples = 0.0, 0
    sched._note_ttft(0.0)                 # genuinely-zero first sample
    assert sched.ttft_ewma == 0.0 and sched.ttft_samples == 1
    sched._note_ttft(100.0)
    assert sched.ttft_samples == 2
    assert sched.ttft_ewma == pytest.approx(20.0)   # blended, not reset


def test_overload_probe_sees_queued_stall_before_first_token(small_fleet):
    sched = small_fleet.schedulers[ATTN_ARCH]
    sched.ttft_ewma, sched.ttft_samples = 1.0, 1    # served fast so far
    probe = TO.fleet_probe(small_fleet)
    sched.submit(np.arange(4, 20, dtype=np.int32), max_new=2)
    time.sleep(0.05)                      # request ages without any step
    load = probe()
    assert load.queue_depth >= 1
    assert load.ttft_ewma_ms >= 40.0, load.ttft_ewma_ms
    sched.drain()                         # serve it: probe relaxes again
    assert probe().queue_depth == 0
    assert sched.ttft_samples == 2
    assert sched.prefill.oldest_wait_s(time.perf_counter()) == 0.0


def test_overload_probe_reports_spec_health():
    fleet = TF.LocalFleet([ATTN_ARCH], batch=2, gen_tokens=6, warmup=False,
                          device="cpu",
                          speculative=SpecConfig(ATTN_ARCH, k=4))
    probe = TO.fleet_probe(fleet)
    assert probe().spec_tokens_per_step == 0.0     # nothing decoded yet
    fleet.generate(ATTN_ARCH, [" ".join(f"sys{i}" for i in range(20))
                               + " question one", "a lone unshared prompt",
                               "tiny"])
    load = probe()
    assert load.spec_accept_ewma > 0.9             # aligned draft
    assert load.spec_tokens_per_step > 1.0         # beats plain decode
    merged = probe()
    merged.merge(load)
    assert merged.spec_tokens_per_step == load.spec_tokens_per_step


# ---------------------------------------------------------------------------
# fleet autoscaler
# ---------------------------------------------------------------------------

class _FakeSched:
    def __init__(self, active, slots, queue):
        self.active = [object()] * active + [None] * (slots - active)
        self.slots = slots
        self.queue = [None] * queue


class _FakeFleet:
    def __init__(self):
        self.schedulers = {"base": _FakeSched(3, 3, 6)}
        self.archs = ["base"]
        self.events = []

    def add_member(self, arch, *, warmup=True):
        self.schedulers[arch] = _FakeSched(0, 3, 0)
        self.events.append(("add", arch))
        return True

    def remove_member(self, arch):
        self.schedulers.pop(arch)
        self.events.append(("remove", arch))
        return True


@pytest.mark.parametrize("O", [JO, TO], ids=["reference", "port"])
def test_autoscaler_spins_standby_up_then_down_fake(O):
    fleet = _FakeFleet()
    scaler = O.FleetAutoscaler(fleet, ["aux-7b"], cooldown_s=5.0)
    acts = scaler.poll(now=100.0)
    assert [(a.direction, a.arch) for a in acts] == [("up", "aux-7b")]
    assert scaler.poll(now=101.0) == []       # cooldown holds
    acts = scaler.poll(now=200.0)
    assert [(a.direction, a.arch) for a in acts] == [("down", "aux-7b")]
    assert fleet.events == [("add", "aux-7b"), ("remove", "aux-7b")]
    assert scaler.standby == ["aux-7b"]


def test_autoscaler_drives_a_torch_fleet():
    """Hot base lane -> the standby member is built and serves; once idle
    it is removed again; the base member is never scaled away."""
    fleet = TF.LocalFleet([ATTN_ARCH], batch=2, gen_tokens=3, warmup=False,
                          device="cpu")
    scaler = TO.FleetAutoscaler(fleet, ["qwen3-1.7b"], cooldown_s=5.0)
    lane, sched = fleet.lanes[ATTN_ARCH], fleet.schedulers[ATTN_ARCH]
    for i in range(6):
        lane.submit(f"queued prompt {i}")
    lane.step()                                    # 2 slots busy, 4 queued
    acts = scaler.poll(now=100.0)
    assert [(a.direction, a.arch) for a in acts] == [("up", "qwen3-1.7b")]
    assert fleet.modality_of("qwen3-1.7b") == "text"
    out = fleet.generate("qwen3-1.7b", ["overflow request"])[0]
    assert len(out["tokens"]) == 3
    sched.drain()
    acts = scaler.poll(now=200.0)
    assert [(a.direction, a.arch) for a in acts] == [("down", "qwen3-1.7b")]
    assert list(fleet.members) == [ATTN_ARCH] and "qwen3-1.7b" not in \
        fleet.schedulers
    assert scaler.poll(now=300.0) == []
    assert sched.pool.live_refs() == 0


# ---------------------------------------------------------------------------
# AsyncFrontend on stub routers
# ---------------------------------------------------------------------------

class _StubRouter:
    """Records route_batch() batch sizes; echoes per-request results."""

    def __init__(self, delay_s=0.0):
        self.batches = []
        self.delay_s = delay_s

    def route_batch(self, reqs):
        self.batches.append(len(reqs))
        if self.delay_s:
            time.sleep(self.delay_s)
        return [(f"resp:{r}", f"out:{r}") for r in reqs]


class _ShortRouter:
    def route_batch(self, reqs):
        return [(f"resp:{r}", f"out:{r}") for r in reqs[:-1]]


class _RaisingRouter:
    def route_batch(self, reqs):
        raise ValueError("boom on the frontend thread")


def test_frontend_coalesces_staggered_arrivals():
    router = _StubRouter()
    fe = AsyncFrontend(router, window_ms=80.0, max_batch=32)
    futs = {}
    for i in range(8):
        futs[i] = fe.submit(f"r{i}")
        time.sleep(0.005)                   # staggered but inside window
    for i, f in futs.items():
        assert f.result(timeout=5) == (f"resp:r{i}", f"out:r{i}")
    fe.close()
    assert router.batches and len(router.batches) < 8
    assert sum(router.batches) == 8
    assert fe.stats.requests == 8 and fe.stats.batches == len(router.batches)


def test_frontend_window_bounds_lone_request_latency():
    router = _StubRouter()
    fe = AsyncFrontend(router, window_ms=30.0)
    t0 = time.perf_counter()
    assert fe.submit("solo").result(timeout=5)[0] == "resp:solo"
    assert time.perf_counter() - t0 < 2.0
    fe.close()
    assert router.batches == [1]


def test_frontend_concurrent_submitters():
    router = _StubRouter(delay_s=0.01)
    fe = AsyncFrontend(router, window_ms=20.0, max_batch=8)
    results = {}

    def worker(i):
        results[i] = fe.submit(f"w{i}").result(timeout=10)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(12)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    fe.close()
    assert all(results[i] == (f"resp:w{i}", f"out:w{i}") for i in range(12))
    assert sum(router.batches) == 12 and max(router.batches) <= 8


def test_frontend_close_rejects_new_work_and_drains_queue():
    router = _StubRouter(delay_s=0.02)
    fe = AsyncFrontend(router, window_ms=1.0, max_batch=1)
    futs = [fe.submit(f"q{i}") for i in range(5)]
    fe.close()
    assert all(f.done() for f in futs)
    assert [f.result()[0] for f in futs] == [f"resp:q{i}" for i in range(5)]
    with pytest.raises(RuntimeError):
        fe.submit("late")


def test_frontend_queue_bound_sheds_with_retry_after():
    fe = AsyncFrontend(_StubRouter(delay_s=0.05), window_ms=1.0,
                       max_batch=1, max_depth=2)
    shed0 = _counter(T_METRICS, "admission_rejected_total")
    futs, err = [], None
    try:
        for i in range(50):
            futs.append(fe.submit(f"r{i}"))
    except TT.RouterOverloadError as e:
        err = e
    assert err is not None, "bounded queue never pushed back"
    assert err.retry_after_s >= 0.05
    assert _counter(T_METRICS, "admission_rejected_total") > shed0
    for f in futs:                   # accepted work still completes
        assert f.result(timeout=10)[0].startswith("resp:")
    fe.close()


def test_frontend_short_router_response_fails_unmatched_futures():
    fe = AsyncFrontend(_ShortRouter(), window_ms=60.0, max_batch=8)
    futs = [fe.submit(f"r{i}") for i in range(3)]
    assert futs[0].result(timeout=5) == ("resp:r0", "out:r0")
    assert futs[1].result(timeout=5) == ("resp:r1", "out:r1")
    with pytest.raises(RuntimeError, match="2 responses for 3 requests"):
        futs[2].result(timeout=5)
    fe.close()


def test_frontend_thread_failure_reaches_every_future():
    fe = AsyncFrontend(_RaisingRouter(), window_ms=20.0, max_batch=8)
    futs = [fe.submit(f"r{i}") for i in range(3)]
    for f in futs:
        with pytest.raises(ValueError, match="boom"):
            f.result(timeout=5)
    fe.close()


def test_frontend_probe_reads_pending_depth():
    gate = threading.Event()

    class _Blocking:
        def route_batch(self, reqs):
            gate.wait(5)
            return [("r", "o") for _ in reqs]

    fe = AsyncFrontend(_Blocking(), window_ms=1.0, max_batch=1)
    det = TO.OverloadDetector(interval_s=0.0)
    det.attach_frontend(fe)
    futs = [fe.submit(i) for i in range(6)]
    time.sleep(0.05)                 # the frontend holds one, five wait
    pol = TT.OverloadPolicy(queue_depth=4)
    assert det.sample(pol) == "overload" and det.load.queue_depth >= 4
    gate.set()
    for f in futs:
        f.result(timeout=5)
    fe.close()


# ---------------------------------------------------------------------------
# AsyncFrontend over the port's router
# ---------------------------------------------------------------------------

TENANT_DSL = '''
SIGNAL keyword vip { operator: "any", keywords: ["vip"] }
ROUTE vip_route {
  PRIORITY 50
  WHEN keyword("vip")
  MODEL "tenant-large"
}
GLOBAL { default_model: "tenant-small", strategy: "priority" }
'''

BASE_DSL = '''
SIGNAL keyword kw { keywords: ["special"] }
ROUTE special { PRIORITY 10 WHEN keyword("kw") MODEL "large" }
BACKEND e0 vllm { address: "127.0.0.1", port: 8000 }
GLOBAL { default_model: "small" }
'''


def test_frontend_reload_during_continuous_stream():
    """A submitter thread keeps a stream in flight while the main thread
    reloads the policy repeatedly; every future resolves, never to a torn
    mix of two programs (echo transport)."""
    cfg, _ = t_compile(BASE_DSL)
    router = SemanticRouter(cfg, device="cpu")
    router.add_policy("t", TENANT_DSL)
    fe = AsyncFrontend(router, window_ms=2.0)
    futs = []
    stop = threading.Event()

    def pump():
        i = 0
        while not stop.is_set():
            r = TT.Request(messages=[TT.Message("user",
                                                f"question number {i}")])
            r.metadata["policy"] = "t"
            futs.append(fe.submit(r))
            i += 1
            time.sleep(0.001)

    th = threading.Thread(target=pump)
    th.start()
    try:
        for v in range(8):
            fe.reload_policy("t", TENANT_DSL.replace(
                "tenant-small", f"tenant-v{v}"))
            time.sleep(0.01)
    finally:
        stop.set()
        th.join()
    results = [f.result(timeout=60) for f in futs]
    assert results and all(r.finish_reason == "stop" for r, _ in results)
    served = {o.model for _, o in results}
    assert served <= {"tenant-small"} | {f"tenant-v{v}" for v in range(8)}
    assert router.policies.get("t").version == 9
    fe.close()
    router.close()


def _demo_requests(T, n):
    demo = list(jserve.DEMO_REQUESTS) + jserve.LANE_DEMO_REQUESTS["image"]
    return [T.Request(messages=[T.Message("user", demo[i % len(demo)])],
                      user=f"user{i % 3}") for i in range(n)]


def _outcome(pair):
    resp, out = pair
    return (out.decision, out.model, resp.content, resp.finish_reason,
            (resp.usage or {}).get("vsr_lane"))


def test_frontend_over_port_router_equals_route_batch():
    """The text,image demo router over a reduced fleet: the 10 demo
    requests through ``AsyncFrontend`` (one window) give what a direct
    ``route_batch`` on a twin router gives; image requests come back
    from the image lane with an 8x8 payload."""
    outs, lanes = [], None
    for mode in ("direct", "frontend"):
        router, fleet = serve.build_router(
            gen_tokens=2, lanes=("text", "image"), device="cpu", batch=2,
            warmup=False)
        reqs = _demo_requests(TT, 10)
        if mode == "direct":
            pairs = router.route_batch(reqs)
        else:
            fe = AsyncFrontend(router, window_ms=500.0, max_batch=len(reqs))
            router.overload.attach_frontend(fe)
            futs = [fe.submit(r) for r in reqs]
            pairs = [f.result(timeout=120) for f in futs]
            fe.close()
            assert fe.stats.batches == 1
        router.close()
        outs.append([_outcome(p) for p in pairs])
        lanes = {a: fleet.modality_of(a) for a in fleet.members}
        for resp, out in pairs:
            if out.model == "sd":
                assert resp.usage["vsr_lane"] == "image"
                assert "image 8x8" in resp.content
        assert all(s.pool.live_refs() == 0
                   for s in fleet.schedulers.values())
    assert outs[1] == outs[0]
    assert lanes[IMG_ARCH] == "image" and IMG_ARCH not in fleet.schedulers
    assert sum(o[1] == "sd" for o in outs[0]) == 2


# ---------------------------------------------------------------------------
# the image lane against the JAX lane
# ---------------------------------------------------------------------------

def _synchronous(lane):
    """The reference lane with its denoise depths read when the step is
    made.  Its ``step`` hands ``jnp.asarray(self.t_idx)`` to an
    asynchronously dispatched jit and then increments ``t_idx`` in place;
    on the CPU that array can alias the numpy buffer, so a denoise may
    read the incremented depths (sigma one step early) — which makes the
    reference's own slot-batching test flaky.  Copying the depths at the
    call and waiting for the result gives the documented schedule,
    sigma_t = 1 - t/N with t the slot's depth before the step."""
    denoise = lane._denoise
    lane._denoise = lambda lat, t: jax.block_until_ready(
        denoise(lat, jnp.array(np.array(t))))
    return lane


def _lanes(hw=4, steps=5, batch=2):
    jl = _synchronous(JF.DiffusionLane(JF.DiffusionMember("d", batch=batch),
                                       hw=hw, steps=steps))
    tl = TF.DiffusionLane(TF.DiffusionMember("d", batch=batch), hw=hw,
                          steps=steps, device="cpu")
    return jl, tl


def test_diffusion_latents_match_reference_step_by_step():
    jl, tl = _lanes(hw=8, steps=8, batch=3)
    prompts = ["a red fox", "blue mountain", "late arrival", "a fourth one",
               "and a fifth"]
    done = {0: {}, 1: {}}
    for i, p in enumerate(prompts):
        assert jl.submit(p) == tl.submit(p) == i + 1
    worst = 0.0
    while jl.pending or tl.pending:
        for k, lane in enumerate((jl, tl)):
            for job in lane.step():
                done[k][job.rid] = job
        assert list(tl.t_idx) == list(jl.t_idx)
        worst = max(worst, float(np.abs(np.asarray(jl.latents)
                                        - tl.latents.numpy()).max()))
    assert worst <= LATENT_TOL, worst
    assert sorted(done[1]) == sorted(done[0]) == [1, 2, 3, 4, 5]
    for rid in done[0]:
        a, b = jl.result(done[0][rid]), tl.result(done[1][rid])
        assert b["image"] == a["image"]
        assert b["content"] == a["content"]
        assert done[1][rid].slot == done[0][rid].slot


def test_diffusion_lane_slot_batching_and_determinism():
    """The denoiser's own batch semantics: slots at different denoise
    depths advance together per step; admission is slot-based; images
    are prompt-deterministic (tests/test_fleet_lanes.py's case)."""
    _, lane = _lanes()
    r1 = lane.submit("a red fox")
    r2 = lane.submit("blue mountain")
    r3 = lane.submit("late arrival")          # overflow: queued, not dropped
    assert lane.pending == 3
    assert not lane.step() and len(lane.queue) == 1
    assert list(lane.t_idx) == [1, 1]
    lane.step()
    assert list(lane.t_idx) == [2, 2]
    finished = {}
    while lane.pending:
        for job in lane.step():
            finished[job.rid] = job
    assert sorted(finished) == [r1, r2, r3]
    assert all(j.steps_done == 5 for j in finished.values())
    assert all(j.image.shape == (4, 4) and j.image.dtype == np.uint8
               for j in finished.values())
    assert finished[r3].slot in (0, 1)
    assert finished[r3].t_done >= finished[r3].t_first > 0
    fleet = TF.LocalFleet([IMG_ARCH], batch=3, device="cpu")
    out1 = fleet.generate(IMG_ARCH, ["a red fox"])[0]
    out2 = fleet.generate(IMG_ARCH, ["a red fox"])[0]
    out3 = fleet.generate(IMG_ARCH, ["something else"])[0]
    assert out1["image"]["sig"] == out2["image"]["sig"]
    assert out1["image"]["sig"] != out3["image"]["sig"]
    assert out1["lane"] == "image" and out1["tokens"] == []
    assert fleet.modality_of(IMG_ARCH) == "image"
    assert fleet.members[IMG_ARCH].prompts_in == 3


def test_image_fleet_payloads_match_reference():
    prompts = jserve.LANE_DEMO_REQUESTS["image"] + ["a red fox"]
    jf = JF.LocalFleet([IMG_ARCH], batch=2)
    _synchronous(jf.lanes[IMG_ARCH])
    tf = TF.LocalFleet([IMG_ARCH], batch=2, device="cpu")
    want = [o["image"] for o in jf.generate(IMG_ARCH, prompts)]
    got = [o["image"] for o in tf.generate(IMG_ARCH, prompts)]
    assert got == want
    assert all(len(g["data"]) == 64 and g["hw"] == 8 for g in got)
    call = tf.call_fn({"sd": IMG_ARCH})
    out = call(None, {"model": "sd", "messages": [
        {"role": "user", "content": prompts[0]}]}, {})
    assert out["choices"][0]["message"]["image"] == want[0]
    assert out["usage"]["vsr_lane"] == "image"


def test_text_image_demo_router_matches_reference():
    """``build_dsl(("text", "image"))`` is the reference's byte for byte,
    and both routers (echo transport) give equal decisions, models and
    endpoints, the image requests routed to the image model."""
    assert serve.build_dsl(("text",)) == jserve.build_dsl(("text",)) == \
        serve.build_dsl()
    src = serve.build_dsl(("text", "image"))
    assert src == jserve.build_dsl(("text", "image"))
    keys = []
    for compile_, mk, T in ((j_compile, lambda c: JRouter(c), JT),
                            (t_compile, lambda c: SemanticRouter(
                                c, device="cpu"), TT)):
        cfg, _ = compile_(src)
        r = mk(cfg)
        pairs = r.route_batch(_demo_requests(T, 10))
        keys.append([(o.decision, o.model, o.endpoint,
                      o.fast_response is not None) for _, o in pairs])
        r.close()
    assert keys[1] == keys[0]
    assert [k[:2] for k in keys[1][8:]] == [("image_gen", "sd")] * 2


def test_audio_lane_is_a_later_slice():
    """The audio lane, once a later slice, is served: ``build_dsl`` with
    audio is the reference's byte for byte, and ``serve.main --lanes
    text,audio`` answers the transcription requests from the audio lane."""
    assert serve.build_dsl(("text", "audio")) == \
        jserve.build_dsl(("text", "audio"))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(["--device", "cpu", "--lanes", "text,audio",
                    "--requests", "10", "--batch", "5",
                    "--gen-tokens", "2"])
    out = buf.getvalue()
    assert "-> transcribe" in out and "lane=audio" in out, out[-2000:]
    assert "backend whisper-tiny" in out


def test_serve_main_async_text_image_runs_to_the_end():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(["--device", "cpu", "--async", "--lanes", "text,image",
                    "--requests", "10", "--gen-tokens", "2",
                    "--window-ms", "20", "--stagger-ms", "1"])
    out = buf.getvalue()
    assert "mode=async window=20ms" in out, out[-2000:]
    assert "frontend:" in out and "lane=image" in out
    assert "backend sd-tiny" in out
    assert "10 requests in" in out
