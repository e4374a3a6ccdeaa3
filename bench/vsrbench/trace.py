"""The device trace of a ``--trace 1`` run: ``torch.profiler`` (CUDA
activity only) over whole batches, started at the dispatch of one batch
and stopped at the end of the first batch that ends ``trace_seconds``
later, then read from its Chrome trace.

Trace timestamps are microseconds on the host's wall clock (since the
trace's ``baseTimeNanoseconds``); they are mapped onto ``perf_counter``
time, the clock of the harness's own records, by the offset between the
two clocks read when the profiler starts.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import torch

from vsrbench import stats

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class DeviceEvent:
    cat: str
    name: str
    start: float              # perf_counter seconds
    end: float
    grid: Optional[Tuple[int, int, int]] = None


@dataclass
class TraceData:
    t_start: float
    t_stop: float
    first_batch: int
    last_batch: int
    events: List[DeviceEvent] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.t_stop - self.t_start

    def intervals(self) -> List[Tuple[float, float]]:
        return [(max(e.start, self.t_start), min(e.end, self.t_stop))
                for e in self.events
                if e.end > self.t_start and e.start < self.t_stop]

    @property
    def busy_s(self) -> float:
        return stats.union_seconds(self.intervals())

    def kernels(self, names: Sequence[str]) -> List[DeviceEvent]:
        """Kernel launches whose name holds one of ``names``."""
        return [e for e in self.events
                if e.cat == "kernel" and any(n in e.name for n in names)]


def prime() -> None:
    """Start and stop the profiler once: its first start sets up the
    device tracer, which takes seconds that no traced batch (nor the
    requests queued behind it) should hold."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


class Tracer:
    """Starts and stops the profiler from the system's batch hooks (on the
    frontend's thread), so the traced window holds whole batches."""

    # the first batch, which the window opens with, runs untraced
    FIRST_BATCH = 1

    def __init__(self, trace_seconds: float):
        self.trace_seconds = float(trace_seconds)
        self.prof = None
        self.t_start = self.t_stop = None
        self.first = self.last = None
        self.offset_ns = 0

    def on_batch_start(self, k: int) -> None:
        if self.prof is None and k >= self.FIRST_BATCH:
            self.prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            self.prof.start()
            self.offset_ns = time.time_ns() - time.perf_counter_ns()
            self.t_start, self.first = time.perf_counter(), k

    def on_batch_end(self, k: int) -> None:
        if self.prof is not None and self.t_stop is None and \
                time.perf_counter() - self.t_start >= self.trace_seconds:
            self._stop(k)

    def _stop(self, k: int) -> None:
        # the window ends when the device has; stopping the profiler then
        # takes seconds of host work that the window must not hold
        torch.cuda.synchronize()
        self.t_stop, self.last = time.perf_counter(), k
        self.prof.stop()

    def finish(self, n_batches: int) -> Optional[TraceData]:
        """The trace read back (None if no batch was traced)."""
        if self.prof is None:
            return None
        if self.t_stop is None:
            self._stop(n_batches - 1)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                doc = json.load(f)
        finally:
            os.unlink(path)
        base = int(doc.get("baseTimeNanoseconds", 0))
        out = TraceData(self.t_start, self.t_stop, self.first, self.last)
        for e in doc.get("traceEvents", []):
            if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
                continue
            t0 = (float(e["ts"]) * 1e3 + base - self.offset_ns) / 1e9
            grid = (e.get("args") or {}).get("grid")
            out.events.append(DeviceEvent(
                e["cat"], e.get("name", ""), t0, t0 + float(e["dur"]) / 1e6,
                tuple(grid) if grid else None))
        self.prof = None
        return out


def _short(name: str, n: int = 96) -> str:
    name = name[5:] if name.startswith("void ") else name
    return name if len(name) <= n else name[:n] + "..."


def breakdown(trace: TraceData, batches) -> dict:
    """The device operations that took most time, and the device's idle
    time by what the host was doing (the batch stage running then, or the
    frontend between batches), ten of each."""
    by_op = defaultdict(float)
    for e in trace.events:
        by_op[_short(e.name)] += e.end - e.start
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    stages = []                     # (start, end, label) on the host
    for b in batches:
        t = b.start
        for name, ms in b.stages:
            stages.append((t, t + ms / 1e3, name))
            t += ms / 1e3
        stages.append((t, b.end, "route_batch: after the stages"))
    idle = defaultdict(float)
    for s, e in stats.gaps(trace.intervals(), trace.t_start, trace.t_stop):
        mid = (s + e) / 2
        label = next((lab for a, z, lab in stages if a <= mid < z),
                     "frontend: between batches")
        idle[label] += e - s
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps]}
