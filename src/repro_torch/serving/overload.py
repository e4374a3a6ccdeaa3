"""Overload detection + fleet autoscaling for the QoS control plane.
A copy of ``repro.serving.overload``.

The :class:`OverloadDetector` samples engine stats from attached probes
(scheduler queue depth, slot occupancy, paged-pool free blocks, EWMA
TTFT per lane), aggregates them into an :class:`EngineLoad`, and grades
the result against a policy's ``OverloadPolicy`` thresholds into one of
three states:

- ``ok`` (0)       — admit everything
- ``busy`` (1)     — degrade classes that declare ``degrade_to``
- ``overload`` (2) — shed best-effort (priority below ``shed_below``)

State transitions are published to metrics
(``overload_state`` gauge + ``overload_state_changes_total`` counter)
so the burst benchmark can assert on them.  De-escalation is damped
with 2-sample hysteresis: a single quiet sample after a storm does not
re-open the gates.

:class:`FleetAutoscaler` is the utilization hook: it watches the same
load signals per member and spins standby sharded members up/down
through ``LocalFleet.add_member`` / ``remove_member``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core.observability import METRICS
from repro_torch.core.types import OverloadPolicy

STATE_OK = "ok"
STATE_BUSY = "busy"
STATE_OVERLOAD = "overload"
_STATE_CODE = {STATE_OK: 0, STATE_BUSY: 1, STATE_OVERLOAD: 2}


@dataclass
class EngineLoad:
    """Aggregate engine load sampled across all probes."""
    queue_depth: int = 0
    active_slots: int = 0
    slots: int = 0
    free_blocks: int = 0
    total_blocks: int = 0
    ttft_ewma_ms: float = 0.0
    # speculative decoding health: best-lane acceptance EWMA and accepted
    # tokens per engine step (0.0 on both = no lane speculating)
    spec_accept_ewma: float = 0.0
    spec_tokens_per_step: float = 0.0

    @property
    def occupancy(self) -> float:
        return self.active_slots / self.slots if self.slots else 0.0

    @property
    def free_frac(self) -> float:
        return self.free_blocks / self.total_blocks if self.total_blocks \
            else 1.0

    def merge(self, other: "EngineLoad"):
        self.queue_depth += other.queue_depth
        self.active_slots += other.active_slots
        self.slots += other.slots
        self.free_blocks += other.free_blocks
        self.total_blocks += other.total_blocks
        self.ttft_ewma_ms = max(self.ttft_ewma_ms, other.ttft_ewma_ms)
        self.spec_accept_ewma = max(self.spec_accept_ewma,
                                    other.spec_accept_ewma)
        self.spec_tokens_per_step = max(self.spec_tokens_per_step,
                                        other.spec_tokens_per_step)


def fleet_probe(fleet) -> Callable[[], EngineLoad]:
    """Probe a ``LocalFleet``: sums queue depth / slots / paged-pool
    free blocks across AR lanes and takes the worst per-lane EWMA TTFT."""
    def probe() -> EngineLoad:
        load = EngineLoad()
        for arch, sched in getattr(fleet, "schedulers", {}).items():
            # queue_depth counts prefilling / prefilled-waiting requests
            # too, not just the raw arrival queue
            load.queue_depth += getattr(sched, "queue_depth",
                                        len(sched.queue))
            load.active_slots += sum(1 for a in sched.active
                                     if a is not None)
            load.slots += sched.slots
            pool = getattr(sched, "pool", None)
            if pool is not None:
                load.free_blocks += pool.free_blocks
                load.total_blocks += pool.num_blocks
            # ttft_probe_ms floors the served EWMA by the oldest waiting
            # request's age: a stalled lane reads as stalled NOW, not
            # only after the stalled request finally finishes
            ttft = getattr(sched, "ttft_probe_ms",
                           getattr(sched, "ttft_ewma", 0.0))
            load.ttft_ewma_ms = max(load.ttft_ewma_ms, ttft)
            # speculating lanes report effective decode throughput (accepted
            # tokens per engine step) so the TTFT/throughput grading sees
            # spec gains/losses the raw step counters would hide
            load.spec_accept_ewma = max(
                load.spec_accept_ewma,
                float(getattr(sched, "spec_acceptance_ewma", 0.0)))
            load.spec_tokens_per_step = max(
                load.spec_tokens_per_step,
                float(getattr(sched, "spec_tokens_per_round", 0.0)))
        return load
    return probe


def frontend_probe(frontend) -> Callable[[], EngineLoad]:
    """Probe an ``AsyncFrontend``: its pending arrival-window depth."""
    def probe() -> EngineLoad:
        return EngineLoad(queue_depth=frontend.queue_depth)
    return probe


class OverloadDetector:
    """Samples probes and grades load against an ``OverloadPolicy``.

    The policy is passed per-sample (``detector.sample(policy)``) rather
    than bound at construction so hot-reloaded programs are graded by
    their own thresholds.  ``sample`` throttles to ``interval_s`` unless
    forced; the latest state is cached in :attr:`state`.
    """

    def __init__(self, *, interval_s: float = 0.05):
        self.interval_s = interval_s
        self._probes: List[Callable[[], EngineLoad]] = []
        self.state = STATE_OK
        self.load = EngineLoad()
        self._last_sample = 0.0
        self._cooler = 0        # consecutive samples grading below state

    # -- wiring --------------------------------------------------------
    def add_probe(self, probe: Callable[[], EngineLoad]):
        self._probes.append(probe)

    def attach_fleet(self, fleet):
        self.add_probe(fleet_probe(fleet))

    def attach_frontend(self, frontend):
        self.add_probe(frontend_probe(frontend))

    # -- detection -----------------------------------------------------
    def _grade(self, load: EngineLoad, policy: OverloadPolicy) -> str:
        if (load.queue_depth >= policy.queue_depth
                or load.free_frac <= policy.free_block_frac
                or (policy.ttft_ms > 0
                    and load.ttft_ewma_ms >= policy.ttft_ms)):
            return STATE_OVERLOAD
        if (load.queue_depth >= max(1, policy.queue_depth // 2)
                or load.occupancy >= policy.slot_occupancy
                or load.free_frac <= min(1.0, 2 * policy.free_block_frac)
                or (policy.ttft_ms > 0
                    and load.ttft_ewma_ms >= 0.5 * policy.ttft_ms)):
            return STATE_BUSY
        return STATE_OK

    def sample(self, policy: Optional[OverloadPolicy] = None, *,
               force: bool = False) -> str:
        """Re-probe (at most every ``interval_s`` unless forced) and
        return the current load state for ``policy``."""
        now = time.monotonic()
        if not force and (now - self._last_sample) < self.interval_s:
            return self.state
        self._last_sample = now
        load = EngineLoad()
        for probe in self._probes:
            load.merge(probe())
        self.load = load
        policy = policy or OverloadPolicy()
        graded = self._grade(load, policy)
        if _STATE_CODE[graded] >= _STATE_CODE[self.state]:
            self._cooler = 0
            new = graded
        else:
            # hysteresis: need 2 consecutive lower samples to de-escalate
            self._cooler += 1
            new = graded if self._cooler >= 2 else self.state
            if new != self.state:
                self._cooler = 0
        if new != self.state:
            METRICS.inc("overload_state_changes_total", state=new)
        self.state = new
        METRICS.gauge("overload_state", _STATE_CODE[new])
        METRICS.gauge("overload_queue_depth", load.queue_depth)
        METRICS.gauge("overload_free_block_frac", round(load.free_frac, 4))
        if load.spec_tokens_per_step:
            METRICS.gauge("spec_accept_ewma",
                          round(load.spec_accept_ewma, 4))
            METRICS.gauge("spec_tokens_per_step",
                          round(load.spec_tokens_per_step, 4))
        return new


# ---------------------------------------------------------------------------
# fleet autoscaler hook
# ---------------------------------------------------------------------------

@dataclass
class ScaleAction:
    direction: str   # "up" | "down"
    arch: str


class FleetAutoscaler:
    """Utilization-driven member scaling.

    ``standby`` lists archs that may be spun up under load (they are NOT
    built until needed).  Base members — everything the fleet was
    constructed with — are never scaled below.  ``poll()`` samples
    per-member utilization (slot occupancy + queue pressure) and calls
    ``fleet.add_member`` / ``fleet.remove_member``; it returns the list
    of actions taken so callers/tests can assert on them.
    """

    def __init__(self, fleet, standby: List[str], *,
                 up_occupancy: float = 0.85, down_occupancy: float = 0.2,
                 queue_factor: float = 1.0, cooldown_s: float = 5.0):
        self.fleet = fleet
        self.standby = list(standby)
        self.up_occupancy = up_occupancy
        self.down_occupancy = down_occupancy
        self.queue_factor = queue_factor
        self.cooldown_s = cooldown_s
        self._base = set(getattr(fleet, "archs", []) or
                         list(getattr(fleet, "members", {})))
        self._spun: List[str] = []
        self._last_action = 0.0

    def _utilization(self) -> Dict[str, Any]:
        stats = {}
        for arch, sched in getattr(self.fleet, "schedulers", {}).items():
            active = sum(1 for a in sched.active if a is not None)
            stats[arch] = {
                "occupancy": active / sched.slots if sched.slots else 0.0,
                "queue": getattr(sched, "queue_depth", len(sched.queue)),
                "slots": sched.slots,
            }
        return stats

    def poll(self, *, now: Optional[float] = None) -> List[ScaleAction]:
        now = time.monotonic() if now is None else now
        if (now - self._last_action) < self.cooldown_s:
            return []
        actions: List[ScaleAction] = []
        util = self._utilization()
        hot = [a for a, u in util.items()
               if u["occupancy"] >= self.up_occupancy
               and u["queue"] >= self.queue_factor * u["slots"]]
        if hot and self.standby:
            arch = self.standby.pop(0)
            self.fleet.add_member(arch)
            self._spun.append(arch)
            actions.append(ScaleAction("up", arch))
            METRICS.inc("autoscale_events_total", direction="up", arch=arch)
        elif self._spun:
            # scale down the most recent spun-up member once it idles
            arch = self._spun[-1]
            u = util.get(arch)
            if u is not None and u["occupancy"] <= self.down_occupancy \
                    and u["queue"] == 0:
                if self.fleet.remove_member(arch):
                    self._spun.pop()
                    self.standby.insert(0, arch)
                    actions.append(ScaleAction("down", arch))
                    METRICS.inc("autoscale_events_total",
                                direction="down", arch=arch)
        if actions:
            self._last_action = now
        return actions
